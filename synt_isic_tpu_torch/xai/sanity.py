"""Sanity checks for attribution methods.

The port of `synt_isic_tpu/xai/sanity.py` (reference
`sanity_check_comprehensive`, `xai/XAI.py:2008-2210`):
  1. weight randomisation: IG maps from a weight-randomised classifier must
     decorrelate from the originals (|r| < 0.1);
  2. input independence: IG maps of independent noise inputs must not
     correlate (< 0.3);
  3. class sensitivity: IG maps for other target classes must differ
     (< 0.8);
plus the aggregate sanity score and its interpretation.

The randomised classifier is a copy of the model whose every entry of
more than one dimension (the convolution and `fc` weights) is replaced by
noise, drawn entry by entry in state-dict order from an explicit CPU
generator; it stands in for `classifier.model` during the test and the
original is put back afterwards.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ..models.classifier import LesionClassifier
from ..models.resnet18 import ResNet18


def _randomized_model(model: ResNet18, generator: torch.Generator,
                      strength: float = 0.01) -> ResNet18:
    """A copy of `model` with every weight (not the 1-d BatchNorm entries
    or biases) replaced by N(0, strength^2) noise, by name."""
    out = copy.deepcopy(model)
    state = out.state_dict()
    with torch.no_grad():
        for value in state.values():
            if value.ndim > 1:
                value.copy_(torch.randn(value.shape, generator=generator) * strength)
    return out


def _corr(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel(), b.ravel()
    if np.any(np.isnan(a)) or np.any(np.isnan(b)):
        return 0.0
    if a.std() == 0 or b.std() == 0:
        return 0.0
    c = float(np.corrcoef(a, b)[0, 1])
    return 0.0 if np.isnan(c) else c


def sanity_check_comprehensive(classifier: LesionClassifier,
                               test_image,
                               target_class: int,
                               xai_analyzer,
                               n_trials: int = 3,
                               randomization_strength: float = 0.01,
                               seed: int = 0) -> Dict[str, Any]:
    generator = torch.Generator().manual_seed(int(seed))
    test_image = classifier.as_input(test_image)
    results: Dict[str, Any] = {
        "weight_randomization_test": {},
        "input_independence_test": {},
        "model_sensitivity_test": {},
        "overall_sanity_score": 0.0,
    }

    def ig(image, cls: int, n_steps: int) -> np.ndarray:
        return xai_analyzer.compute_integrated_gradients(image, cls, n_steps=n_steps).cpu().numpy()

    original_attr = ig(test_image, target_class, 20)

    # 1. weight randomisation
    original_model = classifier.model
    correlations = []
    for _ in range(n_trials):
        classifier.model = _randomized_model(original_model, generator, randomization_strength)
        try:
            correlations.append(abs(_corr(original_attr, ig(test_image, target_class, 20))))
        finally:
            classifier.model = original_model
    mean_rand = float(np.mean(correlations)) if correlations else 0.0
    results["weight_randomization_test"] = {
        "mean_correlation_with_random": mean_rand,
        "correlations_per_trial": correlations,
        "test_passed": bool(mean_rand < 0.1),
        "threshold": 0.1,
        "n_trials": n_trials,
    }

    # 2. input independence
    indep_attrs = [ig(torch.randn(tuple(test_image.shape), generator=generator), target_class, 15)
                   for _ in range(3)]
    indep_corrs = [abs(_corr(indep_attrs[i], indep_attrs[j]))
                   for i in range(len(indep_attrs))
                   for j in range(i + 1, len(indep_attrs))]
    mean_indep = float(np.mean(indep_corrs)) if indep_corrs else 0.0
    results["input_independence_test"] = {
        "mean_correlation_between_independent": mean_indep,
        "independence_correlations": indep_corrs,
        "test_passed": bool(mean_indep < 0.3),
        "threshold": 0.3,
        "n_independent_inputs": 3,
    }

    # 3. class sensitivity
    diff_corrs = [abs(_corr(original_attr, ig(test_image, other, 15)))
                  for other in range(min(3, classifier.num_classes)) if other != target_class]
    mean_diff = float(np.mean(diff_corrs)) if diff_corrs else 1.0
    results["model_sensitivity_test"] = {
        "mean_correlation_different_classes": mean_diff,
        "different_class_correlations": diff_corrs,
        "test_passed": bool(mean_diff < 0.8),
        "threshold": 0.8,
        "classes_tested": len(diff_corrs),
    }

    passed = [results["weight_randomization_test"]["test_passed"],
              results["input_independence_test"]["test_passed"],
              results["model_sensitivity_test"]["test_passed"]]
    score = sum(passed) / len(passed)
    results["overall_sanity_score"] = float(score)
    results["overall_interpretation"] = ("good" if score >= 0.67 else
                                         "moderate" if score >= 0.33 else "poor")
    return results
