"""Progressive-distillation quality ladder on a TRAINED checkpoint.

The port of `scripts/distill_ladder.py`, with its flags and report keys and
`--device` (default cuda; raises without CUDA unless `--device cpu`) in
place of `--cpu`. Starting from a trained teacher (e.g. the e2e_loop
checkpoint), it runs the halving ladder (start -> start/2 -> ... -> end)
through the port's `progressive_distill`, then scores EVERY student at its
own step count against the same held-out set, side by side with the
UNDISTILLED teacher sampled at the same step counts. The delta is the
distillation win.

The teacher is the `.pth` state dict itself (`progressive_distill` loads it
into the student and the teacher module); the student trains in bf16 on
f32 parameters, on CUDA through the hand-written attention kernels and the
f32-statistics GroupNorm, as the device chooses. All sampling goes through
the production ImageGenerator; distilled checkpoints are plain
epsilon-parameterized torch-format `.pth` files, so nothing in the pipeline
changes except `num_inference_steps`.

Usage (after an e2e_loop run):
    python -m synt_isic_tpu_torch.scripts.distill_ladder \
        --checkpoints artifacts/e2e_loop/checkpoints \
        --out artifacts/distill_ladder

Tiny CPU smoke:
    python -m synt_isic_tpu_torch.scripts.distill_ladder --checkpoints <tiny> \
        --size 32 --start 8 --end 4 --steps-per-phase 3 --count 4 \
        --train-images 16 --heldout 16 --device cpu --out <tmp>
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import List, Optional


def run_distill_ladder(checkpoints: str, out_dir: str, class_name: str = "MEL",
                       size: int = 128, start_steps: int = 32,
                       end_steps: int = 4, steps_per_phase: int = 1500,
                       batch_size: int = 32, train_images: int = 256,
                       count: int = 64, heldout: int = 128, seed: int = 1,
                       model_config=None, log=print,
                       device: Optional[str] = None) -> dict:
    """`device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent)."""
    import numpy as np
    import torch

    from ..generator import ImageGenerator
    from ..io.pth import load_checkpoint
    from ..metrics.fid import PixelFeatureExtractor, frechet_distance
    from ..model_manager import resolve_device
    from ..models.unet2d import UNet2D
    from ..train.distill import DistillConfig, progressive_distill
    from ..train.procedural import ProceduralDataset, procedural_images
    from .e2e_loop import small_unet_config
    from .ladder_common import make_stats_fn, score_rung

    device = resolve_device(device)
    if model_config is None:
        model_config = small_unet_config(size)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    teacher_path = Path(checkpoints) / f"unet_{class_name}_best.pth"
    teacher = load_checkpoint(str(teacher_path))
    # the student module: its weights are the teacher's once the ladder
    # loads them; the device decides the attention and GroupNorm paths
    on_cuda = device.type == "cuda"
    model = UNet2D(model_config, dtype=torch.bfloat16, param_dtype=torch.float32,
                   use_fused_attention=on_cuda, fast_norm=on_cuda)
    dataset = ProceduralDataset(class_name, train_images, image_size=size,
                                seed=0)

    dcfg = DistillConfig(batch_size=batch_size,
                         steps_per_phase=steps_per_phase,
                         timestep_spacing="trailing", seed=seed,
                         # deterministic best-export selection once the
                         # phase is long enough for drift to matter
                         eval_every=(max(steps_per_phase // 6, 1)
                                     if steps_per_phase >= 60 else 0))
    t0 = time.time()
    ladder = progressive_distill(teacher, dataset, class_name,
                                 str(out / "checkpoints"),
                                 start_steps=start_steps,
                                 end_steps=end_steps,
                                 config=dcfg, model=model, image_size=size,
                                 log=log, device=device)
    distill_wall = time.time() - t0

    # scoring setup (SHARED battery with sampler_ladder: ladder_common)
    held = procedural_images(class_name, heldout, size, seed=0,
                             start_index=10_000_000)
    stats = make_stats_fn(PixelFeatureExtractor())
    s_held = stats(held)
    train_like = procedural_images(class_name, min(heldout, 128), size,
                                   seed=0, start_index=0)

    def score(ckpt_dir: Path, steps: int, tag: str,
              variant: str = "best") -> dict:
        gen = ImageGenerator(checkpoints_dir=str(ckpt_dir),
                             model_config=model_config,
                             compute_dtype=torch.bfloat16,
                             model_variant=variant, device=device)
        gen.scheduler_kind = "ddim"
        gen.timestep_spacing = "trailing"
        gen.set_inference_steps(steps)
        gen.batch_size = min(count, 64)
        row = score_rung(gen, class_name, count, out / "runs" / tag,
                         seed=seed, stats=stats, s_held=s_held, tag=tag,
                         log=log)
        row["steps"] = steps
        return row

    report = {
        "class": class_name, "size": size, "count": count,
        "teacher": str(teacher_path),
        "timestep_spacing": "trailing",
        "steps_per_phase": steps_per_phase,
        "distill_wall_s": round(distill_wall, 1),
        "floor_train_vs_heldout": float(frechet_distance(*stats(train_like),
                                                         *s_held)),
        # floor at the rungs' own sample count (n=count covariance noise)
        # — same small-n anchor the sampler ladder reports
        "floor_train_n_vs_heldout": float(frechet_distance(
            *stats(train_like[:count]), *s_held)),
        "ceiling_noise_vs_heldout": float(frechet_distance(
            *stats(np.random.default_rng(seed).uniform(
                -1, 1, held.shape).astype(np.float32)), *s_held)),
        "rungs": [],
    }

    # teacher reference rung at the ladder's start step count
    report["rungs"].append(
        score(Path(checkpoints), start_steps, f"teacher_ddim{start_steps}"))
    for phase in ladder["phases"]:
        n = phase["n_student"]
        # undistilled baseline at the student's step count
        report["rungs"].append(
            score(Path(checkpoints), n, f"teacher_ddim{n}"))
        # the student samples through the production VARIANT path: the
        # ladder's checkpoint dir needs the class discoverable (best) plus
        # the student file, then ImageGenerator(model_variant=f"distill{n}")
        student_dir = out / "checkpoints"
        best_link = student_dir / f"unet_{class_name}_best.pth"
        if not best_link.exists():
            shutil.copy(teacher_path, best_link)
        row = score(student_dir, n, f"distill{n}", variant=f"distill{n}")
        row["phase_final_loss"] = phase["final_loss"]
        report["rungs"].append(row)

    (out / "report.json").write_text(json.dumps(report, indent=2))
    log(f"[distill-ladder] report -> {out / 'report.json'}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoints", required=True,
                   help="dir with the teacher unet_<CLASS>_best.pth")
    p.add_argument("--out", default="artifacts/distill_ladder")
    p.add_argument("--class", dest="class_name", default="MEL")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--start", type=int, default=32)
    p.add_argument("--end", type=int, default=4)
    p.add_argument("--steps-per-phase", type=int, default=1500)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--train-images", type=int, default=256)
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--heldout", type=int, default=128)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to distill and sample on")
    p.add_argument("--width", choices=("quarter", "full"), default="quarter",
                   help="'full' = flagship ~25M topology")
    args = p.parse_args(argv)
    from .e2e_loop import unet_config

    run_distill_ladder(args.checkpoints, args.out,
                       class_name=args.class_name, size=args.size,
                       start_steps=args.start, end_steps=args.end,
                       steps_per_phase=args.steps_per_phase,
                       batch_size=args.batch,
                       train_images=args.train_images, count=args.count,
                       heldout=args.heldout, seed=args.seed,
                       model_config=unet_config(args.size, args.width),
                       device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
