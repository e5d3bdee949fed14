"""Re-judge family consistency from saved samples + merge per-class reports.

The port of `scripts/rescore_family_consistency.py`, with its flags and
report keys and `--device` (default cuda; raises without CUDA unless
`--device cpu`) in place of `--cpu`. When `score_family` ran once per class
in fresh processes, each run's per-class Fréchet numbers are sound (no
classifier involved) and its samples persist under
`family_score_samples/<CLASS>/`, but its consistency is only as good as the
probe it used. This script:

  1. retrains the shared probe ONCE over the full taxonomy
     (`score_family.train_probe`: 256 img/class x 24 epochs, hard 0.6,
     target MEL held-out >= 0.70), or with `--skip-probe` reuses
     `classifier.pth` and measures its held-out accuracy on 128 images of
     128² a class;
  2. reclassifies the SAVED samples per class (no resampling — the
     generation evidence is untouched);
  3. merges the per-class `family_score_<C>.json` reports into the single
     `family_score.json`, with consistency, probe accuracy, and the
     absolute + skill-relative verdicts rebuilt from that probe.

Usage:
    python -m synt_isic_tpu_torch.scripts.rescore_family_consistency \
        --checkpoints artifacts/family_full/checkpoints \
        --samples artifacts/family_score_samples \
        --reports 'artifacts/family_score_{C}.json' \
        --out artifacts/family_score.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

CLASSES = ["MEL", "NV", "BCC", "AKIEC", "BKL", "DF", "VASC"]


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoints", required=True)
    p.add_argument("--samples", default="artifacts/family_score_samples")
    p.add_argument("--reports", default="artifacts/family_score_{C}.json")
    p.add_argument("--out", default="artifacts/family_score.json")
    p.add_argument("--classes", default=",".join(CLASSES))
    p.add_argument("--clf-per-class", type=int, default=256)
    p.add_argument("--clf-epochs", type=int, default=24)
    p.add_argument("--clf-hard", type=float, default=0.6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip-probe", action="store_true",
                   help="reuse classifier.pth (must already be the "
                        "full-taxonomy probe)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to train the probe and classify on")
    args = p.parse_args(argv)

    import numpy as np

    from ..model_manager import resolve_device
    from ..models.classifier import LesionClassifier
    from ..utils.config import CLASS_NAMES
    from .e2e_loop import load_generated_images
    from .score_family import heldout_accuracy, train_probe

    device = resolve_device(args.device)
    classes = [c.strip() for c in args.classes.split(",") if c.strip()]
    ckpt_dir = Path(args.checkpoints)
    clf_path = ckpt_dir / "classifier.pth"

    if args.skip_probe and clf_path.exists():
        probe_info = {"reused": str(clf_path)}
    else:
        probe_info = train_probe(ckpt_dir, classes, 128, args.clf_per_class,
                                 args.clf_epochs, args.clf_hard, args.seed,
                                 device=device)
    clf, _ = LesionClassifier.from_checkpoint(str(clf_path), device=device)
    held_acc = probe_info.get("heldout_acc")
    if held_acc is None:
        held_acc = heldout_accuracy(clf, classes, 128, args.clf_hard, args.seed)
        probe_info["heldout_acc"] = held_acc

    merged: dict = {"checkpoints_dir": str(ckpt_dir), "classes": classes,
                    "probe": probe_info,
                    "merged_from": args.reports,
                    "note": ("per-class Frechet from the split runs "
                             "(classifier-free, still valid); consistency "
                             "re-judged on the SAVED samples by the "
                             "full-taxonomy probe — see module docstring"),
                    "rescored": time.strftime("%Y-%m-%d %H:%M:%S"),
                    "per_class": {}}
    for c in classes:
        rp = Path(args.reports.replace("{C}", c))
        entry = json.loads(rp.read_text())["per_class"][c]
        # score_family passes work/<C> as the run dir and the generator
        # nests per-class subdirs, so samples land at work/<C>/<C>/
        samples = load_generated_images(Path(args.samples) / c / c,
                                        entry.get("count", 64) or 64)
        pred = clf.predict(samples).cpu().numpy()
        cons = float(np.mean(pred == CLASS_NAMES.index(c)))
        entry["class_consistency"] = round(cons, 4)
        entry["probe_heldout_acc"] = round(held_acc[c], 4)
        entry["consistency_absolute_ok"] = bool(cons >= 0.70)
        entry["consistency_vs_judge_skill"] = (
            round(cons / held_acc[c], 3) if held_acc[c] > 0 else None)
        merged["per_class"][c] = entry
        print(f"[rescore] {c}: F={entry['frechet_vs_heldout']} "
              f"cons={cons:.2f} (probe {held_acc[c]:.2f})")

    pc = merged["per_class"]
    merged["family_converged"] = bool(
        all(v["model_converged"] for v in pc.values()))
    merged["family_consistent_absolute"] = bool(
        all(v["consistency_absolute_ok"] for v in pc.values()))
    merged["probe_competent"] = bool(
        all(held_acc[c] >= 0.70 for c in classes))
    Path(args.out).write_text(json.dumps(merged, indent=2))
    print(json.dumps({
        "family_converged": merged["family_converged"],
        "family_consistent_absolute": merged["family_consistent_absolute"],
        "probe_competent": merged["probe_competent"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
