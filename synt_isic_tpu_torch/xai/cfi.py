"""Causal-shift (CFI) metrics between original and intervened images.

The port of `synt_isic_tpu/xai/cfi.py`, a near copy on tensors. Parity
with reference `compute_causal_shift_comprehensive`
(`xai/XAI.py:1600-1700`): CFI = g(x) − g(x̃) on the per-class log-prob
score, δ = |CFI| / (|g(x)| + ε), per-class table, prediction-change
analysis, and the KL/JS/TV distribution shifts (matching the reference's
torch `F.kl_div(log(q+eps), p)` = Σ p·(log p − log(q+eps)) convention).

Both images are scored in one stacked classifier forward; the per-class
loop of the reference (7 extra forwards per class pair,
`XAI.py:1674-1688`) collapses into array slicing of the same probs.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models.classifier import LesionClassifier, SCORE_EPS
from ..utils.config import CLASS_NAMES


def _kl(p: np.ndarray, q: np.ndarray) -> float:
    """torch.F.kl_div(log(q+eps), p, reduction='sum') convention."""
    return float(np.sum(p * (np.log(p + SCORE_EPS) - np.log(q + SCORE_EPS))))


def compute_causal_shift_comprehensive(classifier: LesionClassifier,
                                       original_image,
                                       modified_image,
                                       target_class: int,
                                       include_all_classes: bool = True,
                                       class_names=None) -> Dict[str, Any]:
    class_names = class_names or CLASS_NAMES
    orig = classifier.as_input(original_image)
    mod = classifier.as_input(modified_image)

    probs = classifier.get_probabilities(torch.cat([orig, mod])).cpu().numpy()
    orig_probs, mod_probs = probs[0], probs[1]
    scores = np.log(probs + SCORE_EPS)
    orig_score = scores[0, target_class]
    mod_score = scores[1, target_class]

    cfi = orig_score - mod_score
    delta = abs(cfi) / (abs(orig_score) + SCORE_EPS)
    orig_pred, mod_pred = int(np.argmax(orig_probs)), int(np.argmax(mod_probs))

    results: Dict[str, Any] = {
        "target_class_analysis": {
            "class_id": int(target_class),
            "class_name": class_names[target_class] if target_class < len(class_names)
                          else str(target_class),
            "cfi": float(cfi),
            "delta": float(delta),
            "original_score": float(orig_score),
            "modified_score": float(mod_score),
            "original_probability": float(orig_probs[target_class]),
            "modified_probability": float(mod_probs[target_class]),
            "probability_shift": float(orig_probs[target_class] - mod_probs[target_class]),
        },
        "prediction_analysis": {
            "original_prediction": orig_pred,
            "original_prediction_name": class_names[orig_pred] if orig_pred < len(class_names) else str(orig_pred),
            "modified_prediction": mod_pred,
            "modified_prediction_name": class_names[mod_pred] if mod_pred < len(class_names) else str(mod_pred),
            "prediction_changed": bool(orig_pred != mod_pred),
            "original_confidence": float(orig_probs.max()),
            "modified_confidence": float(mod_probs.max()),
            "confidence_drop": float(orig_probs.max() - mod_probs.max()),
        },
    }

    if include_all_classes:
        all_classes = []
        for cid in range(len(class_names)):
            c_cfi = scores[0, cid] - scores[1, cid]
            all_classes.append({
                "class_id": cid,
                "class_name": class_names[cid],
                "cfi": float(c_cfi),
                "delta": float(abs(c_cfi) / (abs(scores[0, cid]) + SCORE_EPS)),
                "original_probability": float(orig_probs[cid]),
                "modified_probability": float(mod_probs[cid]),
                "probability_shift": float(orig_probs[cid] - mod_probs[cid]),
            })
        results["all_classes_analysis"] = all_classes

    m = (orig_probs + mod_probs) / 2
    results["distribution_analysis"] = {
        "kl_divergence": _kl(orig_probs, mod_probs),
        "js_divergence": 0.5 * (_kl(orig_probs, m) + _kl(mod_probs, m)),
        "total_variation": float(0.5 * np.sum(np.abs(orig_probs - mod_probs))),
    }
    return results
