"""Visualization artifacts for the XAI pipeline (matplotlib/Agg).

The port of `synt_isic_tpu/xai/viz.py`, a copy whose functions import
matplotlib when they draw, so `import synt_isic_tpu_torch.xai` works
without it. Produces the same artifact set as the reference's viz layer
(`xai/XAI.py:2218-2661`, `xai/xai_integration.py:35-53`):
  * per-step 5-panel figure (original | attribution | overlay | top-k |
    bottom-k) — `visualize_xai_step_comprehensive` (`XAI.py:2241`);
  * interventions figure (original + per region/type modified images with
    CFI annotations) — `visualize_intervention_comprehensive` (`XAI.py:2305`);
  * Time-SHAP 4-panel — `plot_time_shap_comprehensive` (`XAI.py:2382`);
  * statistics figure with test table — `plot_statistical_analysis_modern`
    (`XAI.py:2457`);
  * full trajectory mosaic (10 columns, 2px padding) —
    `save_trajectory_grid` (`xai_integration.py:35-53`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def _pyplot():
    """matplotlib's pyplot on the Agg backend, imported at first use."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def tensor_to_displayable_image(t) -> np.ndarray:
    """(H,W,C)/(1,H,W,C) in [-1,1] -> (H,W,3) float in [0,1]
    (reference `tensor_to_displayable_image`, `XAI.py:2218`)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    arr = np.asarray(t, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[0] in (1, 3) and arr.shape[-1] not in (1, 3):
        arr = np.transpose(arr, (1, 2, 0))  # tolerate CHW input
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def _attr_to_heat(attr) -> np.ndarray:
    a = np.asarray(attr, dtype=np.float32)
    if a.ndim == 4:
        a = a[0]
    if a.ndim == 3:
        a = np.linalg.norm(a, axis=-1)
    return a


# The per-step 5-panel figure is produced 3x per frame x every captured
# frame (150 figures for a 50-frame trajectory) — figure construction,
# colorbar creation, and tight_layout dominated the whole XAI pipeline's
# wall time (~66 s of a 168 s run). The figure is therefore built ONCE per
# image shape and reused: subsequent calls only set_data on the existing
# artists and re-encode the PNG. Built via matplotlib.figure.Figure (NOT
# pyplot), so cached canvases are never registered with pyplot's figure
# manager; the cache is bounded (long-lived serve/GUI processes seeing
# many image sizes must not accumulate canvases). Not thread-safe
# (neither is pyplot); every production caller runs the pipeline serially.
_STEP_FIG_CACHE: Dict[Any, Dict[str, Any]] = {}
_STEP_FIG_CACHE_MAX = 4


def _get_step_figure(shape) -> Dict[str, Any]:
    c = _STEP_FIG_CACHE.get(shape)
    if c is not None:
        return c
    if len(_STEP_FIG_CACHE) >= _STEP_FIG_CACHE_MAX:
        _STEP_FIG_CACHE.pop(next(iter(_STEP_FIG_CACHE)))  # evict oldest
    h, w = shape
    zero_img = np.zeros((h, w, 3), np.float32)
    zero_heat = np.zeros((h, w), np.float32)
    from matplotlib.figure import Figure

    fig = Figure(figsize=(20, 4.2))
    axes = fig.subplots(1, 5)
    im0 = axes[0].imshow(zero_img)
    im1 = axes[1].imshow(zero_heat, cmap="inferno")
    axes[1].set_title("Attribution |IG+SHAP|")
    fig.colorbar(im1, ax=axes[1], fraction=0.046)
    im2a = axes[2].imshow(zero_img)
    im2b = axes[2].imshow(zero_heat, cmap="inferno", alpha=0.5)
    axes[2].set_title("Overlay")
    im3a = axes[3].imshow(zero_img)
    im3b = axes[3].imshow(zero_heat, cmap="Greens", alpha=0.6, vmin=0, vmax=1)
    axes[3].set_title("Top-k regions")
    im4a = axes[4].imshow(zero_img)
    im4b = axes[4].imshow(zero_heat, cmap="Blues", alpha=0.6, vmin=0, vmax=1)
    axes[4].set_title("Bottom-k regions")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout(rect=(0, 0, 1, 0.95))   # leave room for the suptitle
    c = {"fig": fig, "axes": axes, "im0": im0, "im1": im1, "im2a": im2a,
         "im2b": im2b, "im3a": im3a, "im3b": im3b, "im4a": im4a, "im4b": im4b}
    _STEP_FIG_CACHE[shape] = c
    return c


def visualize_xai_step_comprehensive(image, attribution, top_mask, bottom_mask,
                                     timestep: float, class_name: str,
                                     save_path: Optional[str] = None) -> None:
    img = tensor_to_displayable_image(image)
    heat = _attr_to_heat(attribution)
    c = _get_step_figure(heat.shape)
    fig, axes = c["fig"], c["axes"]
    c["im0"].set_data(img)
    axes[0].set_title(f"Original (t={timestep:.0f})")
    c["im1"].set_data(heat)
    lo, hi = float(heat.min()), float(heat.max())
    c["im1"].set_clim(lo, hi if hi > lo else lo + 1e-12)
    c["im2a"].set_data(img)
    c["im2b"].set_data(heat)
    c["im2b"].set_clim(lo, hi if hi > lo else lo + 1e-12)
    ones = np.ones_like(heat)
    c["im3a"].set_data(img)
    c["im3b"].set_data(np.ma.masked_where(~np.asarray(top_mask, bool), ones))
    c["im4a"].set_data(img)
    c["im4b"].set_data(np.ma.masked_where(~np.asarray(bottom_mask, bool), ones))
    fig.suptitle(f"XAI step analysis — {class_name}")
    if save_path:
        # compress_level=1: PNG encode at zlib level 6 costs ~2.4x the
        # whole canvas draw (measured 320 ms vs 134 ms); level 1 halves
        # the save for +13% file size — at 150 figures/run that's ~27 s
        fig.savefig(save_path, dpi=100, pil_kwargs={"compress_level": 1})


def visualize_intervention_comprehensive(image, region_masks: Dict[str, Any],
                                         interventions: Dict[str, Dict[str, Any]],
                                         cfi_results: Dict[str, Any],
                                         timestep: float,
                                         save_path: Optional[str] = None) -> None:
    img = tensor_to_displayable_image(image)
    cells = [("original", None, img)]
    for region_type, per_type in interventions.items():
        for itype, res in per_type.items():
            cells.append((region_type, itype,
                          tensor_to_displayable_image(res["modified_image"])))
    plt = _pyplot()
    n = len(cells)
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows), squeeze=False)
    for idx, (region, itype, arr) in enumerate(cells):
        ax = axes[idx // cols][idx % cols]
        ax.imshow(arr)
        if itype is None:
            ax.set_title(f"original (t={timestep:.0f})")
        else:
            cfi_key = f"{region}_{itype}"
            cfi = cfi_results.get(cfi_key, {}).get("target_class_analysis", {}).get("cfi")
            label = f"{region}/{itype}"
            if cfi is not None:
                label += f"\nCFI={cfi:+.3f}"
            ax.set_title(label, fontsize=10)
        ax.axis("off")
    for idx in range(n, rows * cols):
        axes[idx // cols][idx % cols].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100,
                    pil_kwargs={"compress_level": 1})
    plt.close(fig)


def plot_time_shap_comprehensive(timesteps: Sequence[float], importance,
                                 raw_data: Dict[str, Any], class_name: str,
                                 save_path: Optional[str] = None) -> None:
    ts = np.asarray(list(timesteps), dtype=np.float64)
    imp = np.asarray(importance, dtype=np.float64)
    conf = np.asarray(raw_data.get("probability_scores", np.zeros_like(imp)))
    scores = np.asarray(raw_data.get("confidence_scores", np.zeros_like(imp)))
    x = np.arange(len(ts))

    plt = _pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(14, 9))
    axes[0, 0].plot(x, imp, marker="o", color="#1f77b4")
    best = int(np.argmax(imp))
    axes[0, 0].axvline(best, color="red", ls="--", alpha=0.6,
                       label=f"max @ t={ts[best]:.0f}")
    axes[0, 0].set_title("Time-SHAP importance (normalized)")
    axes[0, 0].set_xlabel("frame index")
    axes[0, 0].legend()

    axes[0, 1].plot(x, conf, marker=".", color="#2ca02c")
    axes[0, 1].set_title(f"p({class_name} | x_t)")
    axes[0, 1].set_xlabel("frame index")

    axes[1, 0].plot(x, scores, marker=".", color="#d62728")
    axes[1, 0].set_title("per-class log-prob score")
    axes[1, 0].set_xlabel("frame index")

    top = np.argsort(imp)[::-1][:min(10, len(imp))]
    axes[1, 1].bar([f"{ts[i]:.0f}" for i in top], imp[top], color="#9467bd")
    axes[1, 1].set_title("top frames by importance (t labels)")
    axes[1, 1].tick_params(axis="x", rotation=45)

    fig.suptitle(f"Time-SHAP — {class_name}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100,
                    pil_kwargs={"compress_level": 1})
    plt.close(fig)


def plot_time_shap_coalitional(timesteps: Sequence[float], shapley_values,
                               frame_scores, efficiency_gap: float,
                               class_name: str,
                               save_path: Optional[str] = None) -> None:
    """Axiom-faithful Time-SHAP (permutation-sampled Shapley values over
    timesteps — the README-described formulation, reference
    `README.md:198-207`): φ per frame plus the value curve they decompose.
    The efficiency axiom Σφ = v(full) − v(∅) holds by construction; the
    plotted gap is the estimator's numerical residual."""
    ts = np.asarray(list(timesteps), dtype=np.float64)
    phi = np.asarray(shapley_values, dtype=np.float64)
    scores = np.asarray(frame_scores, dtype=np.float64)
    x = np.arange(len(ts))

    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    colors = ["#d62728" if v < 0 else "#1f77b4" for v in phi]
    axes[0].bar(x, phi, color=colors)
    axes[0].axhline(0, color="gray", lw=0.8)
    best = int(np.argmax(np.abs(phi)))
    axes[0].axvline(best, color="red", ls="--", alpha=0.5,
                    label=f"max |φ| @ t={ts[best]:.0f}")
    axes[0].set_title(f"Shapley φ per frame (Σφ={phi.sum():.4f}, "
                      f"efficiency gap={efficiency_gap:.2e})")
    axes[0].set_xlabel("frame index")
    axes[0].legend()

    axes[1].plot(x, scores, marker=".", color="#2ca02c")
    axes[1].set_title("coalition value v: per-class log-prob of the "
                      "latest revealed frame")
    axes[1].set_xlabel("frame index")

    fig.suptitle(f"Coalitional Time-SHAP — {class_name}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100,
                    pil_kwargs={"compress_level": 1})
    plt.close(fig)


def plot_statistical_analysis_modern(stats_results: Dict[str, Any],
                                     class_name: str,
                                     top_k_shifts: Optional[Sequence[float]] = None,
                                     bottom_k_shifts: Optional[Sequence[float]] = None,
                                     save_path: Optional[str] = None) -> None:
    plt = _pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(18, 5.5))

    d = stats_results.get("descriptive_statistics", {})
    if top_k_shifts is not None and bottom_k_shifts is not None:
        axes[0].boxplot([list(top_k_shifts), list(bottom_k_shifts)],
                        tick_labels=["top-k", "bottom-k"])
    else:
        means = [d.get("top_k", {}).get("mean", 0), d.get("bottom_k", {}).get("mean", 0)]
        stds = [d.get("top_k", {}).get("std", 0), d.get("bottom_k", {}).get("std", 0)]
        axes[0].bar(["top-k", "bottom-k"], means, yerr=stds, capsize=6,
                    color=["#1f77b4", "#ff7f0e"])
    axes[0].set_title("CFI shifts: top-k vs bottom-k")

    boot = stats_results.get("bootstrap_analysis", {})
    axes[1].axvline(boot.get("ci_lower", 0), color="gray", ls="--")
    axes[1].axvline(boot.get("ci_upper", 0), color="gray", ls="--")
    axes[1].axvline(boot.get("mean_diff", 0), color="red")
    axes[1].axvline(0, color="black", lw=1)
    axes[1].set_title(f"bootstrap mean diff CI "
                      f"[{boot.get('ci_lower', 0):.3f}, {boot.get('ci_upper', 0):.3f}]")

    rows = []
    for group in ("parametric_tests", "nonparametric_tests"):
        for name, t in stats_results.get(group, {}).items():
            if "p_value" in t:
                rows.append([name, f"{t['p_value']:.4f}",
                             "yes" if t.get("significant") else "no"])
    perm = stats_results.get("permutation_analysis", {})
    if "p_value" in perm:
        rows.append(["permutation", f"{perm['p_value']:.4f}",
                     "yes" if perm.get("significant") else "no"])
    concl = stats_results.get("overall_conclusion", {})
    rows.append(["CONSENSUS", f"{concl.get('significant_tests_count', 0)}/"
                 f"{concl.get('total_tests_count', 0)}",
                 "SIGNIFICANT" if concl.get("significant") else "n.s."])
    axes[2].axis("off")
    table = axes[2].table(cellText=rows, colLabels=["test", "p", "significant"],
                          loc="center")
    table.scale(1, 1.4)
    axes[2].set_title("statistical tests")

    fig.suptitle(f"Statistical validation — {class_name}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=100,
                    pil_kwargs={"compress_level": 1})
    plt.close(fig)


def save_trajectory_grid(trajectory, out_path, cols: int = 10, pad: int = 2) -> None:
    """Mosaic of ALL diffusion steps (reference `xai_integration.py:35-53`)."""
    from PIL import Image

    frames = [(tensor_to_displayable_image(f) * 255).astype(np.uint8)
              for f in trajectory]
    if not frames:
        return
    h, w = frames[0].shape[:2]
    n = len(frames)
    cols = max(1, cols)
    rows = (n + cols - 1) // cols
    canvas = np.full((rows * h + pad * (rows - 1),
                      cols * w + pad * (cols - 1), 3), 255, dtype=np.uint8)
    for idx, fr in enumerate(frames):
        r, c = divmod(idx, cols)
        canvas[r * (h + pad): r * (h + pad) + h,
               c * (w + pad): c * (w + pad) + w] = fr
    Image.fromarray(canvas).save(out_path)
