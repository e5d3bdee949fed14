"""Fairness audit over large synthetic-sample batches.

The port of `synt_isic_tpu/xai/fairness.py`. The reference's research
claims include an ~8000-sample dark-phototype fairness audit (reference
`README.md:31`; benchmark config 5 in BASELINE.md) but ship no audit code.
Classifier probabilities for thousands of images run as device batches
(uint8 images are dequantised on the device: a quarter of the bytes to
move), and group comparisons reuse the statistical battery
(`xai/stats.py`).

Audit contents per group pair (e.g. dark-phototype vs rest):
  * prediction distribution + demographic-parity gaps per class;
  * confidence and per-class-score distributions with the full
    statistical-significance battery;
  * equalized-odds-style gaps when ground-truth labels are provided.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..models.classifier import LesionClassifier, SCORE_EPS
from ..utils.config import CLASS_NAMES
from ..parallel.replicas import sampling_replica
from ..parallel.sharded_sampler import sharded_scores
from .attribution import check_mesh
from .stats import statistical_validation_comprehensive


class FairnessAuditor:
    def __init__(self, classifier: LesionClassifier, batch_size: int = 128,
                 mesh=None, class_names: Optional[Sequence[str]] = None):
        self.mesh = check_mesh(mesh)
        self.classifier = classifier
        self.batch_size = batch_size
        self.class_names = list(class_names or CLASS_NAMES)

    # -- scoring ---------------------------------------------------------------
    def probabilities(self, images: np.ndarray) -> np.ndarray:
        """(N,H,W,3) -> (N, num_classes) softmax probabilities, computed in
        device batches. Accepts float in [-1,1] or uint8 [0,255] (dequantised
        on the device). With a mesh each chunk is split over its 'data' axis
        (`parallel.sharded_scores`), one shard per device's classifier
        replica (reference `fairness.py:57-71`)."""
        def probs_on(clf: LesionClassifier):
            def probs(chunk: torch.Tensor) -> np.ndarray:
                chunk = chunk.to(clf.device)
                if chunk.dtype == torch.uint8:
                    chunk = chunk.float() / 127.5 - 1.0
                return clf.get_probabilities(chunk).cpu().numpy()
            return probs

        outs = []
        for start in range(0, len(images), self.batch_size):
            chunk = torch.as_tensor(np.array(images[start:start + self.batch_size]))
            if self.mesh is not None:
                outs.append(sharded_scores(lambda shard: probs_on(
                    sampling_replica(self.classifier, shard.device))(shard), chunk, self.mesh))
            else:
                outs.append(probs_on(self.classifier)(chunk))
        return np.concatenate(outs) if outs else np.zeros((0, len(self.class_names)))

    # -- audit -------------------------------------------------------------------
    def audit(self, images: np.ndarray, group_mask: np.ndarray,
              target_class: Optional[int] = None,
              labels: Optional[np.ndarray] = None,
              alpha: float = 0.1,
              group_source: str = "provided_labels") -> Dict[str, Any]:
        """Compare classifier behavior between group (mask=True) and the
        complement. `target_class` defaults to per-sample argmax scoring.

        `group_source` is recorded verbatim in the report: audits whose
        mask came from `estimate_phototype_mask` must pass
        "luminance_heuristic" so their conclusions are never mistaken for
        curated-phototype-label results (the reference's corpus claim,
        reference `README.md:31`, rests on curated labels)."""
        group_mask = np.asarray(group_mask, bool)
        probs = self.probabilities(images)
        preds = probs.argmax(axis=1)
        conf = probs.max(axis=1)

        g, r = group_mask, ~group_mask
        results: Dict[str, Any] = {
            "n_group": int(g.sum()),
            "n_rest": int(r.sum()),
            "group_source": str(group_source),
        }
        if group_source == "luminance_heuristic":
            results["group_source_caveat"] = (
                "group membership was estimated by a border-ring luminance "
                "threshold, not curated phototype labels; treat fairness "
                "conclusions as indicative only")

        # prediction distribution + demographic parity gaps. An EMPTY side
        # has no distribution — reporting all-zeros would read as a ~1.0
        # parity gap when no comparison happened at all
        dist_g = (np.bincount(preds[g], minlength=len(self.class_names))
                  / g.sum()) if g.any() else None
        dist_r = (np.bincount(preds[r], minlength=len(self.class_names))
                  / r.sum()) if r.any() else None
        both = dist_g is not None and dist_r is not None
        results["prediction_distribution"] = {
            "group": dist_g.tolist() if dist_g is not None else None,
            "rest": dist_r.tolist() if dist_r is not None else None,
            "parity_gap_per_class": (dist_g - dist_r).tolist() if both else None,
            "max_parity_gap": float(np.abs(dist_g - dist_r).max()) if both else None,
        }

        # confidence comparison with the full statistical battery
        results["confidence"] = {
            "group_mean": float(conf[g].mean()) if g.any() else None,
            "rest_mean": float(conf[r].mean()) if r.any() else None,
            "statistics": statistical_validation_comprehensive(
                conf[g], conf[r], alpha=alpha, n_bootstrap=500,
                n_permutations=2000) if g.sum() > 2 and r.sum() > 2 else None,
        }

        # per-class score comparison for the target class
        if target_class is not None:
            scores = np.log(probs[:, target_class] + SCORE_EPS)
            results["target_class_scores"] = {
                "class": self.class_names[target_class],
                "group_mean": float(scores[g].mean()) if g.any() else None,
                "rest_mean": float(scores[r].mean()) if r.any() else None,
                "statistics": statistical_validation_comprehensive(
                    scores[g], scores[r], alpha=alpha, n_bootstrap=500,
                    n_permutations=2000) if g.sum() > 2 and r.sum() > 2 else None,
            }

        # accuracy / equalized-odds gaps when labels exist
        if labels is not None:
            labels = np.asarray(labels)
            acc_g = float((preds[g] == labels[g]).mean()) if g.any() else None
            acc_r = float((preds[r] == labels[r]).mean()) if r.any() else None
            per_class_tpr = {}
            for cid, name in enumerate(self.class_names):
                mg = g & (labels == cid)
                mr = r & (labels == cid)
                per_class_tpr[name] = {
                    "group_tpr": float((preds[mg] == cid).mean()) if mg.any() else None,
                    "rest_tpr": float((preds[mr] == cid).mean()) if mr.any() else None,
                }
            results["accuracy"] = {
                "group": acc_g, "rest": acc_r,
                "gap": (acc_g - acc_r) if acc_g is not None and acc_r is not None else None,
                "per_class_tpr": per_class_tpr,
            }

        # a two-sample comparison needs both sides populated: below
        # MIN_SIDE the gap estimates are noise (and at 0 they're undefined).
        # For a generator audit an (almost-)empty group is itself the
        # finding — the generator produced essentially no group members —
        # so it gets its own verdict instead of a fabricated parity gap.
        MIN_SIDE = 8
        if min(results["n_group"], results["n_rest"]) < MIN_SIDE:
            verdict = "group_underrepresented"
            results["comparisons_reliable"] = False
            results["verdict_caveat"] = (
                f"one side is below {MIN_SIDE} samples (group="
                f"{results['n_group']}, rest={results['n_rest']}): any "
                f"parity/confidence comparisons present in this report are "
                f"noise-level estimates and did NOT inform the verdict; for "
                f"an audit of generated samples this underrepresentation is "
                f"itself the fairness finding")
        else:
            verdict = "balanced"
            results["comparisons_reliable"] = True
            if results["prediction_distribution"]["max_parity_gap"] > 0.1:
                verdict = "parity_gap"
            stats = results["confidence"]["statistics"]
            if stats and stats["overall_conclusion"]["significant"]:
                verdict = "significant_confidence_gap" if verdict == "balanced" \
                    else verdict + "+confidence_gap"
        results["verdict"] = verdict
        return results


def estimate_phototype_mask(images: np.ndarray,
                            luminance_threshold: float = -0.25) -> np.ndarray:
    """Heuristic dark-phototype selector: mean luminance of the border ring
    (skin around the lesion) below threshold ([-1,1] space). This stands in
    for the curated phototype labels the reference's corpus has; callers
    with real labels should pass their own mask."""
    imgs = np.asarray(images)
    if imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 127.5 - 1.0
    lum = (0.299 * imgs[..., 0] + 0.587 * imgs[..., 1] + 0.114 * imgs[..., 2])
    h, w = lum.shape[1:3]
    ring = np.ones((h, w), bool)
    ring[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = False
    ring_mean = lum[:, ring].mean(axis=1)
    return ring_mean < luminance_threshold
