"""Sampler speed-quality frontier on a TRAINED checkpoint.

The port of `scripts/sampler_ladder.py`, with its flags, grid and report
keys and `--device` (default cuda; raises without CUDA unless `--device
cpu`) in place of `--cpu`. Given a trained checkpoint directory (e.g. from
`synt_isic_tpu_torch.scripts.e2e_loop`), it samples a grid of (scheduler,
steps) configs through the production ImageGenerator (bf16 compute) and
scores each against the SAME procedural held-out set with the deterministic
pixel-Fréchet embedding (metrics/fid.PixelFeatureExtractor), emitting one
JSON report: img/s + Fréchet per rung, with the train-vs-heldout floor and
noise ceiling anchors, and the headline: the fastest rung within 15% of the
best rung's Fréchet.

Reference anchor for the configs: DDIM-50 is the GUI default
(`core/config/config_manager.py:54`), DDPM-1000 the console CLI default
(`diffusion/console_generator_server.py:41`).

Usage (after an e2e_loop run):
    python -m synt_isic_tpu_torch.scripts.sampler_ladder \
        --checkpoints artifacts/e2e_loop/checkpoints \
        --out artifacts/sampler_ladder.json
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

DEFAULT_GRID = (
    # (scheduler, steps[, timestep_spacing]) — spacing defaults to
    # 'leading' (reference parity); 'trailing' is the few-step fix
    # (schedules.trailing_timesteps)
    ("ddim", 50),          # reference GUI default — the quality anchor
    ("ddim", 50, "trailing"),
    ("ddim", 20),
    ("ddim", 20, "trailing"),
    ("dpm_solver", 50),
    ("dpm_solver", 30),
    ("dpm_solver", 30, "trailing"),
    ("dpm_solver", 20),
    ("dpm_solver", 20, "trailing"),
    ("dpm_solver", 10),
    ("dpm_solver", 10, "trailing"),
    # predictor-corrector: higher accuracy than DPM-Solver++(2M) at equal
    # model evaluations on the trailing grid; built for trailing — skip
    # leading rungs below ~20 steps
    ("unipc", 50, "trailing"),
    ("unipc", 20, "trailing"),
    ("unipc", 10, "trailing"),
    ("unipc", 8, "trailing"),
    # stochastic multistep: targets the ancestral rung's texture quality
    # at few-step cost
    ("dpm_solver_sde", 50, "trailing"),
    ("dpm_solver_sde", 30, "trailing"),
    ("dpm_solver_sde", 20, "trailing"),
    ("ddpm", 250),         # ancestral rung (T=1000 is the CLI default but
                           # adds nothing to the frontier at 4x the steps)
)


def run_ladder(checkpoints: str, out_path: str, class_name: str = "MEL",
               size: int = 128, count: int = 64, heldout: int = 128,
               seed: int = 1, grid=DEFAULT_GRID, model_config=None,
               log=print, device: Optional[str] = None) -> dict:
    """`device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent)."""
    import numpy as np
    import torch

    from ..generator import ImageGenerator
    from ..metrics.fid import PixelFeatureExtractor, frechet_distance
    from ..model_manager import resolve_device
    from ..train.procedural import procedural_images
    from .e2e_loop import small_unet_config
    from .ladder_common import make_stats_fn, score_rung

    device = resolve_device(device)
    if model_config is None:
        model_config = small_unet_config(size)
    held = procedural_images(class_name, heldout, size, seed=0,
                             start_index=10_000_000)
    train_like = procedural_images(class_name, min(heldout, 128), size,
                                   seed=0, start_index=0)
    noise = np.random.default_rng(seed).uniform(
        -1, 1, held.shape).astype(np.float32)

    stats = make_stats_fn(PixelFeatureExtractor())

    grid = [(r + ("leading",))[:3] for r in grid]   # optional 3rd: spacing
    s_held = stats(held)
    report = {
        "class": class_name, "size": size, "count": count,
        "checkpoints": str(checkpoints),
        "floor_train_vs_heldout": float(frechet_distance(*stats(train_like),
                                                         *s_held)),
        # floor at the rungs' own sample count (n=count covariance noise)
        "floor_train_n_vs_heldout": float(frechet_distance(
            *stats(train_like[:count]), *s_held)),
        "ceiling_noise_vs_heldout": float(frechet_distance(*stats(noise),
                                                           *s_held)),
        "rungs": [],
    }
    out_dir = Path(out_path).parent / "sampler_ladder_runs"
    for scheduler, steps, spacing in grid:
        gen = ImageGenerator(checkpoints_dir=str(checkpoints),
                             model_config=model_config,
                             compute_dtype=torch.bfloat16, device=device)
        gen.scheduler_kind = scheduler
        gen.timestep_spacing = spacing
        gen.set_inference_steps(steps)
        gen.set_generation_seed(seed)
        gen.batch_size = min(count, 64)
        gen.save_trajectory = False
        tag = f"{scheduler}_{steps}" + ("" if spacing == "leading"
                                        else f"_{spacing}")
        # warm + timed scoring (shared battery, ladder_common.score_rung:
        # warms every block size incl. the remainder block, distinct warm
        # seed)
        row = score_rung(gen, class_name, count, out_dir / tag,
                         seed=seed, stats=stats, s_held=s_held, tag=tag,
                         log=log)
        rung = {"scheduler": scheduler, "steps": steps,
                "timestep_spacing": spacing,
                "frechet_vs_heldout": row["frechet_vs_heldout"],
                "img_per_s": row["img_per_s"],
                "wall_s": row["wall_s"]}
        report["rungs"].append(rung)

    # the fastest rung whose Fréchet is within 15% of the best rung — the
    # honest headline config for this checkpoint
    best = min(r["frechet_vs_heldout"] for r in report["rungs"])
    ok = [r for r in report["rungs"]
          if r["frechet_vs_heldout"] <= 1.15 * best]
    report["headline"] = max(ok, key=lambda r: r["img_per_s"])
    report["headline_rule"] = ("fastest rung within 15% Fréchet of the best "
                               "rung — quality-matched speed claim")
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(report, indent=2))
    log(f"[ladder] headline: {report['headline']} -> {out_path}")
    return report


def parse_grid(spec: str):
    """'scheduler:steps[:spacing],...' -> grid rows, as `--configs` takes them."""
    grid = []
    for part in spec.split(","):
        parts = part.strip().split(":")
        grid.append((parts[0], int(parts[1])) if len(parts) == 2
                    else (parts[0], int(parts[1]), parts[2]))
    return grid


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoints", required=True)
    p.add_argument("--out", default="artifacts/sampler_ladder.json")
    p.add_argument("--class", dest="class_name", default="MEL")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--heldout", type=int, default=128)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to sample on")
    p.add_argument("--width", choices=("quarter", "full"), default="quarter",
                   help="'full' = flagship ~25M topology")
    p.add_argument("--configs", default=None, metavar="SPEC",
                   help="comma-separated subset grid 'scheduler:steps"
                        "[:spacing]' (e.g. 'ddim:50:trailing,unipc:8:"
                        "trailing') instead of the full default ladder")
    args = p.parse_args(argv)
    from .e2e_loop import unet_config

    run_ladder(args.checkpoints, args.out, class_name=args.class_name,
               size=args.size, count=args.count, heldout=args.heldout,
               seed=args.seed,
               grid=parse_grid(args.configs) if args.configs else DEFAULT_GRID,
               model_config=unet_config(args.size, args.width),
               device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
