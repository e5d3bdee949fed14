"""Train the full-size PER-CLASS checkpoint family.

The port of `scripts/train_family.py`, with its flags and report and
`--device` (default cuda; raises without CUDA unless `--device cpu`) in
place of `--cpu`. The reference's shipped artifact is seven per-class
checkpoints (`core/generator/model_manager.py:39` glob `unet_*_best.pth`;
`core/cache/metadata/cache_metadata.json:61` — 7 models, ~101 MB each).
This script trains each requested class with the flagship recipe (384
imgs x 1000 epochs, EMA 0.9995, cosine LR 2e-4 with 500 warmup steps,
min-SNR-5, offset noise 0.05, deterministic-probe best selection) into ONE
shared checkpoints dir, so `parity_gauntlet` and `score_family` can run
across all 7. On CUDA the model trains in bf16 on f32 parameters through the
hand-written attention kernels (forward and backward) and the
f32-statistics GroupNorm, with the dataset on the card.

Crash-safe / resumable by design: a class whose `unet_<CLASS>_best.pth`
already exists is skipped (its color-statistics entry is still ensured),
unless the trainer's resume snapshot (`train_state_<CLASS>.pt`,
`train_ddpm.resume_snapshot_path`) is still there: then the class was
interrupted, the best file is only a periodic snapshot, and it trains
again; `--resume` continues it from that snapshot (weights, optimizer state,
step). A clean finish deletes the snapshot (about 3x a checkpoint). The
per-class report is written to `<out>/family_train.json` after EVERY class,
not at the end.

Usage (full width):
    python -m synt_isic_tpu_torch.scripts.train_family --out artifacts/family_full \
        --classes MEL,NV,BCC,AKIEC,BKL,DF,VASC --width full --resume

Tiny CPU smoke:
    python -m synt_isic_tpu_torch.scripts.train_family --out <tmp> --classes MEL,NV \
        --size 32 --train-images 8 --epochs 2 --batch 4 --width quarter --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional


def family_train_config(size: int, train_images: int, epochs: int,
                        batch_size: int, seed: int):
    """The flagship recipe every class of the family trains with."""
    from ..train.train_ddpm import TrainConfig

    return TrainConfig(
        image_size=size, batch_size=min(batch_size, train_images),
        epochs=epochs, ema_decay=0.9995, seed=seed,
        learning_rate=2e-4, lr_schedule="cosine", warmup_steps=500,
        min_snr_gamma=5.0, eval_every=25, eval_probe_images=16,
        eval_t_points=8, offset_noise=0.05,
        snapshot_every=max(5, epochs // 6))


def family_model(size: int, width: str, seed: int, fused: bool):
    """The family's UNet: bf16 compute on f32 parameters, seeded; `fused`
    (CUDA) takes the hand-written attention and the f32-statistics
    GroupNorm."""
    import torch

    from ..models.unet2d import UNet2D
    from .e2e_loop import unet_config

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return UNet2D(unet_config(size, width), dtype=torch.bfloat16,
                      param_dtype=torch.float32, use_fused_attention=fused,
                      fast_norm=fused)


def train_family(out_dir: str, classes, size: int = 128,
                 train_images: int = 384, epochs: int = 1000,
                 batch_size: int = 32, width: str = "full", seed: int = 0,
                 resume: bool = False, force: bool = False,
                 log=print, device: Optional[str] = None) -> dict:
    """`device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent)."""
    from ..io.color_stats import update_color_statistics_file
    from ..model_manager import resolve_device
    from ..train.procedural import ProceduralDataset
    from ..train.train_ddpm import (dataset_color_statistics,
                                    resume_snapshot_path, train_class)

    device = resolve_device(device)
    out = Path(out_dir)
    ckpt_dir = out / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    report_path = out / "family_train.json"
    report: dict = (json.loads(report_path.read_text())
                    if report_path.exists() else {})
    report.setdefault("config", {
        "size": size, "width": width, "train_images": train_images,
        "epochs": epochs, "batch": batch_size, "seed": seed})
    report.setdefault("classes", {})

    on_accel = device.type != "cpu"
    stats_path = ckpt_dir / "color_statistics.json"

    def save():
        report_path.write_text(json.dumps(report, indent=2))

    trained_now = []
    for class_name in classes:
        best = ckpt_dir / f"unet_{class_name}_best.pth"
        resume_snap = resume_snapshot_path(ckpt_dir, class_name)
        have_stats = False
        if stats_path.exists():
            have_stats = class_name in json.loads(stats_path.read_text())
        # a lingering resume snapshot means the class was INTERRUPTED
        # mid-train (clean completions delete it below) — the best file on
        # disk is then only a periodic snapshot, not the finished model:
        # fall through to train_class(resume=...) instead of skipping
        interrupted = resume_snap.exists()
        if best.exists() and not force and not interrupted:
            log(f"[family:{class_name}] checkpoint exists — skipping train")
            entry = report["classes"].setdefault(
                class_name, {"skipped_existing": True})
            if not have_stats:
                dataset = ProceduralDataset(class_name, train_images, size,
                                            seed=seed)
                stats = dataset_color_statistics(dataset)
                if stats is not None:
                    update_color_statistics_file(stats_path, class_name, stats)
                    log(f"[family:{class_name}] color stats backfilled")
            entry["checkpoint"] = str(best)
            save()
            continue

        t0 = time.time()
        # device-resident dataset on an accelerator: no per-step host copy
        dataset = ProceduralDataset(class_name, train_images, size,
                                    seed=seed, device=device if on_accel else None)
        model = family_model(size, width, seed, fused=on_accel)
        tcfg = family_train_config(size, train_images, epochs, batch_size, seed)
        result = train_class(class_name, dataset, str(ckpt_dir), tcfg,
                             model=model, resume=resume, log=log, device=device)
        dt = time.time() - t0
        # a resumed class whose snapshot had every epoch done runs none
        history = result["history"] or [None]
        report["classes"][class_name] = {
            "best_loss": result["best_loss"],
            "best_val": result.get("best_val"),
            "steps": result["steps"],
            "first_epoch_loss": history[0],
            "last_epoch_loss": history[-1],
            "seconds": round(dt, 1),
            "checkpoint": str(best),
        }
        save()
        log(f"[family:{class_name}] done in {dt / 60:.1f} min "
            f"(loss {history[0]} -> {history[-1]}, best {result['best_loss']:.4g})")
        # the resume snapshot is ~3x the checkpoint size (params + opt
        # state + EMA); drop it once the class completed cleanly
        if resume_snap.exists():
            resume_snap.unlink()
        trained_now.append(class_name)

    have = sorted(p.name[5:-9] for p in ckpt_dir.glob("unet_*_best.pth"))
    report["family_complete"] = all(
        (ckpt_dir / f"unet_{c}_best.pth").exists() for c in classes)
    log(f"[family] {len(have)} checkpoints on disk ({', '.join(have)}); "
        f"trained this run: {trained_now or 'none'}")
    save()
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="artifacts/family_full")
    p.add_argument("--classes", default="MEL,NV,BCC,AKIEC,BKL,DF,VASC")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--train-images", type=int, default=384)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--width", choices=("quarter", "full"), default="full")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true",
                   help="continue a killed class from its optimizer snapshot "
                        "at the epoch after the snapshot's (--epochs is the "
                        "class's total)")
    p.add_argument("--force", action="store_true",
                   help="retrain classes whose checkpoint already exists")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to train on")
    args = p.parse_args(argv)
    report = train_family(
        args.out, [c.strip() for c in args.classes.split(",") if c.strip()],
        size=args.size, train_images=args.train_images, epochs=args.epochs,
        batch_size=args.batch, width=args.width, seed=args.seed,
        resume=args.resume, force=args.force, device=args.device)
    return 0 if report.get("family_complete") else 1


if __name__ == "__main__":
    sys.exit(main())
