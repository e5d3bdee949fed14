"""Large-batch fairness audit (BASELINE config 5: 8000-sample
dark-phototype corpus).

The port of `scripts/fairness_audit.py`: the same flags and report, with
`--device` (default cuda; raises without CUDA unless `--device cpu`) in
place of `--cpu`. The classifier scores on the device; images from a
directory stay uint8 on the host and are dequantised on the device.

Sources images either from a directory of generated PNG/JPGs or by
generating them on the fly, derives (or loads) the group mask, and runs
`xai.fairness.FairnessAuditor`, writing a JSON report.

Usage:
  python -m synt_isic_tpu_torch.scripts.fairness_audit --images generated_images/NV \
      --target-class NV
  python -m synt_isic_tpu_torch.scripts.fairness_audit --generate MEL:4000,NV:4000 \
      --checkpoints checkpoints
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..models.classifier import LesionClassifier
from ..utils.config import CLASS_NAMES
from ..xai.fairness import FairnessAuditor, estimate_phototype_mask


def load_images(directory: str, limit: int) -> np.ndarray:
    from PIL import Image

    paths = sorted(Path(directory).rglob("*.png")) + \
        sorted(Path(directory).rglob("*.jpg"))
    paths = paths[:limit]
    if not paths:
        raise SystemExit(f"no images under {directory}")
    imgs = []
    for p in paths:
        # keep uint8: the auditor dequantizes on device, and large corpora
        # are transfer-bound (4x fewer bytes than float32)
        imgs.append(np.asarray(Image.open(p).convert("RGB").resize((128, 128)),
                               dtype=np.uint8))
    return np.stack(imgs)


def generate_images(spec: str, checkpoints: str, steps: int, batch: int,
                    seed: int, device: str = "cuda", model_config=None) -> np.ndarray:
    from ..cli import _parse_class_counts
    from ..model_manager import ModelManager

    counts = _parse_class_counts(spec)
    mm = ModelManager(checkpoints_dir=checkpoints, device=device,
                      model_config=model_config)
    chunks = []
    rng = np.random.default_rng(seed)
    for cls, count in counts.items():
        if not mm.load_model(cls):
            print(f"!! missing checkpoint for {cls}")
            continue
        sampler = mm.create_sampler(steps, scheduler="ddim")
        model = mm.loaded_models[cls]
        done = 0
        while done < count:
            block = min(batch, count - done)
            seeds = rng.integers(0, 2**31 - 1, block).astype(np.uint32)
            out = sampler.sample(model, seeds)
            chunks.append(out["images"].float().cpu().numpy())
            done += block
        mm.unload_model(cls)
    return np.concatenate(chunks)


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` (a `UNet2DConfig`) sizes the `--generate` models; the
    flagship architecture by default."""
    p = argparse.ArgumentParser()
    p.add_argument("--images", help="directory of images to audit")
    p.add_argument("--generate", help="generate on the fly, e.g. 'MEL:4000'")
    p.add_argument("--checkpoints", default="checkpoints")
    p.add_argument("--classifier", default=None)
    p.add_argument("--target-class", default=None, choices=list(CLASS_NAMES))
    p.add_argument("--limit", type=int, default=8000)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--luminance-threshold", type=float, default=-0.25)
    p.add_argument("--split", default=None, metavar="SPEC",
                   help="REAL group split of the generated corpus by border "
                        "skin tone: 'median-luminance' (darker half vs "
                        "lighter half) or 'luminance-percentile:P' (darkest "
                        "P%% vs rest). Both sides are non-empty by "
                        "construction, so the full parity/confidence "
                        "battery runs end-to-end on generated data (VERDICT "
                        "r4 #8). The group is a TONE split, a proxy for "
                        "phototype — the report labels it so")
    p.add_argument("--group-labels", default=None,
                   help="file with one 0/1 per line (or a .npy bool array) "
                        "giving curated group membership per image, in the "
                        "sorted image order; without it the luminance "
                        "HEURISTIC stands in and the report is marked so")
    p.add_argument("--phototype-sim", type=float, default=None, metavar="F",
                   help="CURATED-LABELS validation mode: darken a seeded "
                        "fraction F of the corpus (synthetic dark-phototype "
                        "rendering, tone scale 0.45) and audit with the "
                        "ground-truth membership as curated labels; the "
                        "report additionally scores the luminance "
                        "heuristic's agreement against those labels")
    p.add_argument("--out", default="fairness_report.json")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to classify (and generate) on")
    args = p.parse_args(argv)

    if args.images:
        images = load_images(args.images, args.limit)
    elif args.generate:
        images = generate_images(args.generate, args.checkpoints, args.steps,
                                 args.batch, args.seed, args.device, model_config)
    else:
        raise SystemExit("provide --images or --generate")
    print(f"auditing {len(images)} images")

    sim_mask = None
    if args.phototype_sim is not None:
        # synthetic phototype rendering: scale a seeded subset's tones
        # toward dark skin (multiplicative in [0,1] space — shadows and
        # lesion pigment keep their relative contrast)
        rng = np.random.default_rng(args.seed + 99)
        sim_mask = rng.random(len(images)) < args.phototype_sim
        f32 = images.dtype != np.uint8
        imgs = images.astype(np.float32)
        if f32:   # [-1,1] -> [0,1]
            imgs = (imgs + 1.0) / 2.0
        else:
            imgs = imgs / 255.0
        imgs[sim_mask] *= 0.45
        images = ((imgs * 2.0 - 1.0).astype(np.float32) if f32
                  else np.round(imgs * 255.0).astype(np.uint8))
        print(f"phototype-sim: darkened {int(sim_mask.sum())}/{len(images)} "
              f"images (curated ground-truth labels)")

    clf_path = args.classifier or str(Path(args.checkpoints) / "classifier.pth")
    if Path(clf_path).exists():
        clf, counts = LesionClassifier.from_checkpoint(clf_path, device=args.device)
        print(f"classifier: {counts}")
    else:
        clf = LesionClassifier.random_init(device=args.device)
        print("classifier: random init (scores are structural only)")

    heuristic_validation = None
    if args.group_labels:
        lp = Path(args.group_labels)
        if lp.suffix == ".npy":
            mask = np.asarray(np.load(lp), bool)
        else:
            mask = np.asarray(
                [int(t) for t in lp.read_text().split()], bool)
        if len(mask) != len(images):
            raise SystemExit(f"--group-labels has {len(mask)} entries for "
                             f"{len(images)} images")
        group_source = f"labels_file:{lp.name}"
    elif sim_mask is not None:
        mask = sim_mask
        group_source = "synthetic_phototype_rendering"
    elif args.split:
        # real split of the corpus by border-ring tone: every generated
        # image lands on one side, so both groups are populated and the
        # full stats battery executes on real generated data (unlike the
        # absolute-threshold heuristic, which found 0/8000 dark images in
        # round 4 — artifacts/fairness_audit_8000.json)
        imgs_f = np.asarray(images)
        if imgs_f.dtype == np.uint8:
            imgs_f = imgs_f.astype(np.float32) / 127.5 - 1.0
        lum = (0.299 * imgs_f[..., 0] + 0.587 * imgs_f[..., 1]
               + 0.114 * imgs_f[..., 2])
        h, w = lum.shape[1:3]
        ring = np.ones((h, w), bool)
        ring[h // 4: 3 * h // 4, w // 4: 3 * w // 4] = False
        ring_mean = lum[:, ring].mean(axis=1)
        if args.split == "median-luminance":
            pct = 50.0
        elif args.split.startswith("luminance-percentile:"):
            pct = float(args.split.split(":", 1)[1])
        else:
            raise SystemExit(f"unknown --split {args.split!r}")
        cut = float(np.percentile(ring_mean, pct))
        mask = ring_mean < cut
        group_source = f"luminance_split_p{pct:g}"
        print(f"split: darkest {pct:g}% of the corpus by border-ring "
              f"luminance (cut {cut:+.3f} in [-1,1]) — a TONE split as "
              f"phototype proxy, labeled as such in the report")
    else:
        mask = estimate_phototype_mask(images, args.luminance_threshold)
        group_source = "luminance_heuristic"
        print("NOTE: group mask is the luminance HEURISTIC, not curated "
              "phototype labels — conclusions are indicative only "
              "(pass --group-labels for a real audit)")
    if (group_source != "luminance_heuristic"
            and not group_source.startswith("luminance_split")):
        # curated labels available: validate the heuristic against them
        # (this is the only place the heuristic's accuracy is measurable;
        # a percentile SPLIT is itself luminance-derived, so scoring the
        # heuristic against it would be circular — skipped)
        h = estimate_phototype_mask(images, args.luminance_threshold)
        tp = int((h & mask).sum())
        heuristic_validation = {
            "threshold": args.luminance_threshold,
            "accuracy": float((h == mask).mean()),
            "precision": float(tp / max(1, int(h.sum()))),
            "recall": float(tp / max(1, int(mask.sum()))),
            "heuristic_positives": int(h.sum()),
            "curated_positives": int(mask.sum()),
        }
        print(f"luminance-heuristic vs curated labels: {heuristic_validation}")
    print(f"dark-phototype group: {int(mask.sum())}/{len(mask)}")
    auditor = FairnessAuditor(clf, batch_size=args.batch)
    target = CLASS_NAMES.index(args.target_class) if args.target_class else None
    report = auditor.audit(images, mask, target_class=target,
                           group_source=group_source)
    if heuristic_validation is not None:
        report["luminance_heuristic_validation"] = heuristic_validation

    from ..xai.pipeline import json_safe
    Path(args.out).write_text(json.dumps(json_safe(report), indent=2))
    print(f"verdict: {report['verdict']}  -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
