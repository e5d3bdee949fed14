"""Statistical validation battery for top-k vs bottom-k causal shifts.

A copy of `synt_isic_tpu/xai/stats.py` (numpy and scipy on the host), but
for the Kolmogorov-Smirnov call, which passes the fitted normal's cdf as a
callable (the same test and numbers; scipy 1.18 refuses the reference's
`kstest(x, "norm", args=(loc, scale))`).

Parity with reference `statistical_validation_comprehensive`
(`xai/XAI.py:1708-2005`): descriptive stats, Student + Welch t-tests,
Mann-Whitney U + Wilcoxon rank-sum, Cohen's d + Glass's Δ effect sizes,
bootstrap CI of the mean difference, permutation test, Shapiro-Wilk +
Kolmogorov-Smirnov normality, Levene + F variance tests, and the
majority-vote significance consensus.

The reference's bootstrap (1000 resamples) and permutation (10000
shuffles) are sequential Python loops
(`XAI.py:1845-1906`); here both are fully vectorized numpy (one
(n_bootstrap, n) gather each) and seeded for reproducibility — orders of
magnitude faster on host and deterministic.
"""
from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, Sequence

import numpy as np
from scipy import stats

ALPHA_LEVEL = 0.1
N_BOOTSTRAP = 1000
N_PERMUTATIONS = 10000


def _descriptive(data: np.ndarray, name: str) -> Dict[str, Any]:
    return {
        "name": name,
        "n": int(len(data)),
        "mean": float(np.mean(data)),
        "median": float(np.median(data)),
        "std": float(np.std(data, ddof=1)) if len(data) > 1 else 0.0,
        "var": float(np.var(data, ddof=1)) if len(data) > 1 else 0.0,
        "min": float(np.min(data)),
        "max": float(np.max(data)),
        "q25": float(np.percentile(data, 25)),
        "q75": float(np.percentile(data, 75)),
        "iqr": float(np.percentile(data, 75) - np.percentile(data, 25)),
        "skewness": float(stats.skew(data)) if len(data) > 2 else 0.0,
        "kurtosis": float(stats.kurtosis(data)) if len(data) > 3 else 0.0,
    }


def statistical_validation_comprehensive(top_k_shifts: Sequence[float],
                                         bottom_k_shifts: Sequence[float],
                                         alpha: float = ALPHA_LEVEL,
                                         n_bootstrap: int = N_BOOTSTRAP,
                                         n_permutations: int = N_PERMUTATIONS,
                                         seed: int = 0) -> Dict[str, Any]:
    top_k = np.asarray(top_k_shifts, dtype=np.float64)
    bottom_k = np.asarray(bottom_k_shifts, dtype=np.float64)
    rng = np.random.default_rng(seed)

    results: Dict[str, Any] = {
        "descriptive_statistics": {
            "top_k": _descriptive(top_k, "Top-k"),
            "bottom_k": _descriptive(bottom_k, "Bottom-k"),
        }
    }

    # 1. parametric
    t_stat, t_p = stats.ttest_ind(top_k, bottom_k)
    welch_stat, welch_p = stats.ttest_ind(top_k, bottom_k, equal_var=False)
    results["parametric_tests"] = {
        "t_test": {"statistic": float(t_stat), "p_value": float(t_p),
                   "significant": bool(t_p < alpha),
                   "description": "Independent samples t-test"},
        "welch_t_test": {"statistic": float(welch_stat), "p_value": float(welch_p),
                         "significant": bool(welch_p < alpha),
                         "description": "Welch's t-test (unequal variances)"},
    }

    # 2. nonparametric
    nonparam: Dict[str, Any] = {}
    try:
        u_stat, u_p = stats.mannwhitneyu(top_k, bottom_k, alternative="two-sided")
        nonparam["mann_whitney_u"] = {"statistic": float(u_stat), "p_value": float(u_p),
                                      "significant": bool(u_p < alpha),
                                      "description": "Mann-Whitney U test"}
    except Exception as exc:
        nonparam["mann_whitney_u"] = {"error": str(exc)}
    try:
        w_stat, w_p = stats.ranksums(top_k, bottom_k)
        nonparam["wilcoxon_rank_sum"] = {"statistic": float(w_stat), "p_value": float(w_p),
                                         "significant": bool(w_p < alpha),
                                         "description": "Wilcoxon rank-sum test"}
    except Exception as exc:
        nonparam["wilcoxon_rank_sum"] = {"error": str(exc)}
    results["nonparametric_tests"] = nonparam

    # 3. effect sizes
    n1, n2 = len(top_k), len(bottom_k)
    pooled_std = np.sqrt(((n1 - 1) * np.var(top_k, ddof=1) +
                          (n2 - 1) * np.var(bottom_k, ddof=1)) /
                         max(n1 + n2 - 2, 1)) if n1 + n2 > 2 else 0.0
    cohens_d = float((np.mean(top_k) - np.mean(bottom_k)) / pooled_std) if pooled_std > 0 else 0.0
    interp = ("negligible" if abs(cohens_d) < 0.2 else
              "small" if abs(cohens_d) < 0.5 else
              "medium" if abs(cohens_d) < 0.8 else "large")
    bottom_std = np.std(bottom_k, ddof=1) if n2 > 1 else 0.0
    results["effect_sizes"] = {
        "cohens_d": {"value": cohens_d, "interpretation": interp,
                     "description": "Cohen's d (standardized mean difference)"},
        "glass_delta": {
            "value": float((np.mean(top_k) - np.mean(bottom_k)) / bottom_std)
                     if bottom_std > 0 else 0.0,
            "description": "Glass's delta (using control group std)"},
    }

    # 4. bootstrap CI — vectorized resampling
    confidence_level = 1 - alpha
    top_samples = rng.choice(top_k, size=(n_bootstrap, n1), replace=True)
    bottom_samples = rng.choice(bottom_k, size=(n_bootstrap, n2), replace=True)
    boot_diffs = top_samples.mean(axis=1) - bottom_samples.mean(axis=1)
    ci_lower = float(np.percentile(boot_diffs, (1 - confidence_level) / 2 * 100))
    ci_upper = float(np.percentile(boot_diffs, (1 + confidence_level) / 2 * 100))
    results["bootstrap_analysis"] = {
        "mean_diff": float(boot_diffs.mean()),
        "ci_lower": ci_lower,
        "ci_upper": ci_upper,
        "ci_contains_zero": bool(ci_lower <= 0 <= ci_upper),
        "confidence_level": confidence_level,
        "n_bootstrap": n_bootstrap,
    }

    # 5. permutation test — vectorized shuffles
    observed = float(np.mean(top_k) - np.mean(bottom_k))
    if n1 >= 2 and n2 >= 2:
        combined = np.concatenate([top_k, bottom_k])
        # one (n_permutations, n) argsort of random keys = all shuffles at once
        perm_idx = np.argsort(rng.random((n_permutations, len(combined))), axis=1)
        permuted = combined[perm_idx]
        perm_diffs = permuted[:, :n1].mean(axis=1) - permuted[:, n1:].mean(axis=1)
        p_value = float(np.mean(np.abs(perm_diffs) >= abs(observed)))
    else:
        perm_diffs = np.array([observed])
        p_value = 1.0
    results["permutation_analysis"] = {
        "observed_difference": observed,
        "p_value": p_value,
        "significant": bool(p_value < alpha),
        "n_permutations": n_permutations,
    }

    # 6. normality
    normality: Dict[str, Any] = {}
    if 3 <= n1 <= 5000 and 3 <= n2 <= 5000:
        sh_t = stats.shapiro(top_k)
        sh_b = stats.shapiro(bottom_k)
        normality["shapiro_wilk"] = {
            "top_k": {"statistic": float(sh_t[0]), "p_value": float(sh_t[1]),
                      "normal": bool(sh_t[1] > alpha)},
            "bottom_k": {"statistic": float(sh_b[0]), "p_value": float(sh_b[1]),
                         "normal": bool(sh_b[1] > alpha)},
        }
    else:
        normality["shapiro_wilk"] = {
            "top_k": {"skipped": True, "reason": "sample_size < 3 or > 5000"},
            "bottom_k": {"skipped": True, "reason": "sample_size < 3 or > 5000"},
        }
    # the fitted normal's cdf as a callable: scipy 1.18's kstest maps "norm"
    # to `special.ndtr`, which takes no (loc, scale) args
    ks_t = stats.kstest(top_k, stats.norm(np.mean(top_k), np.std(top_k)).cdf)
    ks_b = stats.kstest(bottom_k, stats.norm(np.mean(bottom_k), np.std(bottom_k)).cdf)
    normality["kolmogorov_smirnov"] = {
        "top_k": {"statistic": float(ks_t[0]), "p_value": float(ks_t[1]),
                  "normal": bool(ks_t[1] > alpha)},
        "bottom_k": {"statistic": float(ks_b[0]), "p_value": float(ks_b[1]),
                     "normal": bool(ks_b[1] > alpha)},
    }
    results["normality_tests"] = normality

    # 7. variance equality
    variance: Dict[str, Any] = {}
    try:
        lev_stat, lev_p = stats.levene(top_k, bottom_k)
        variance["levene"] = {"statistic": float(lev_stat), "p_value": float(lev_p),
                              "equal_variances": bool(lev_p > alpha),
                              "description": "Levene's test for equal variances"}
    except Exception as exc:
        variance["levene"] = {"error": str(exc)}
    var_b = np.var(bottom_k, ddof=1)
    if var_b > 0 and n1 > 1 and n2 > 1:
        f_stat = float(np.var(top_k, ddof=1) / var_b)
        f_p = float(2 * min(stats.f.cdf(f_stat, n1 - 1, n2 - 1),
                            1 - stats.f.cdf(f_stat, n1 - 1, n2 - 1)))
        variance["f_test"] = {"statistic": f_stat, "p_value": f_p,
                              "equal_variances": bool(f_p > alpha),
                              "description": "F-test for equal variances"}
    results["variance_tests"] = variance

    # 8. consensus
    consensus = {
        "parametric_significant": any(t.get("significant", False)
                                      for t in results["parametric_tests"].values()),
        "nonparametric_significant": any(t.get("significant", False)
                                         for t in nonparam.values()),
        "bootstrap_significant": not results["bootstrap_analysis"]["ci_contains_zero"],
        "permutation_significant": results["permutation_analysis"]["significant"],
    }
    total_sig = sum(consensus.values())
    threshold = len(consensus) // 2 + 1
    results["significance_consensus"] = consensus
    results["overall_conclusion"] = {
        "significant": bool(total_sig >= threshold),
        "significant_tests_count": int(total_sig),
        "total_tests_count": len(consensus),
        "alpha_level": alpha,
        "recommendation": "significant" if total_sig >= threshold else "not_significant",
    }
    results["metadata"] = {
        "analysis_timestamp": datetime.now().isoformat(),
        "n_bootstrap_samples": n_bootstrap,
        "n_permutations": n_permutations,
        "alpha_level": alpha,
        "seed": seed,
    }
    return results
