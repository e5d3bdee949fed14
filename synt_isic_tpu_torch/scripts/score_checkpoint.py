"""Score a trained checkpoint's sample quality at arbitrary sampler configs.

The port of `scripts/score_checkpoint.py`, with its flags and report keys
and `--device` (default cuda; raises without CUDA unless `--device cpu`)
in place of `--cpu`. Generic version of the ladder scripts' scoring rung:
given a checkpoints dir (e.g. an e2e_loop run), sample through the
production ImageGenerator (bf16 compute) at each requested (scheduler,
steps[, spacing]) config and report pixel-Fréchet vs a held-out procedural
set, with the same floor/ceiling anchors and warm-every-block-size rules
(ladder_common).

`--ab-fast-math` additionally runs every config a second time with the
attention kernel's bf16-exponential mode enabled
(`ModelManager.set_attention_tuning(fast_math=True)`) — the quality
evidence required before that mode can ever be a default: the report
carries the Fréchet delta and both rates side by side. The fast rows'
sidecars record `attention_fast_math`, so `--reproduce` rebuilds them.
`--heads-per-program G` runs G attention heads per kernel block (identical
results).

Usage (after an e2e_loop run):
    python -m synt_isic_tpu_torch.scripts.score_checkpoint \
        --checkpoints artifacts/e2e_loop/checkpoints \
        --configs ddim:50:trailing,dpm_solver:20:trailing --ab-fast-math

Tiny CPU smoke:
    python -m synt_isic_tpu_torch.scripts.score_checkpoint --checkpoints <tiny> \
        --size 32 --configs ddim:4 --count 4 --heldout 16 --device cpu --out <tmp>
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional


def parse_configs(spec: str):
    configs = []
    for part in spec.split(","):
        fields = part.strip().split(":")
        if len(fields) < 2:
            raise ValueError(f"config '{part}' is not scheduler:steps[:spacing]")
        configs.append({"scheduler": fields[0], "steps": int(fields[1]),
                        "spacing": fields[2] if len(fields) > 2 else "leading"})
    return configs


def score_checkpoint(checkpoints: str, out_path: str, configs,
                     class_name: str = "MEL", size: int = 128,
                     count: int = 64, heldout: int = 128, seed: int = 2,
                     batch: int = 64, variant: str = "best",
                     ab_fast_math: bool = False, flagship: bool = False,
                     heads_per_program: int = 1, log=print,
                     device: Optional[str] = None) -> dict:
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
    model_config = None if flagship else small_unet_config(size)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    run_root = out.with_suffix("") if out.suffix else out / "runs"

    held = procedural_images(class_name, heldout, size, seed=0,
                             start_index=10_000_000)
    stats = make_stats_fn(PixelFeatureExtractor())
    s_held = stats(held)
    train_like = procedural_images(class_name, min(heldout, 128), size,
                                   seed=0, start_index=0)
    report = {
        "checkpoints": str(checkpoints), "class": class_name, "size": size,
        "count": count, "variant": variant,
        "floor_train_vs_heldout": round(float(frechet_distance(
            *stats(train_like), *s_held)), 3),
        "ceiling_noise_vs_heldout": round(float(frechet_distance(
            *stats(np.random.default_rng(seed).uniform(
                -1, 1, held.shape).astype(np.float32)), *s_held)), 3),
        "rows": [],
    }

    def one(cfg, fast: bool) -> dict:
        tag = (f"{cfg['scheduler']}{cfg['steps']}_{cfg['spacing']}"
               + ("_fastmath" if fast else ""))
        gen = ImageGenerator(checkpoints_dir=str(checkpoints),
                             model_config=model_config,
                             compute_dtype=torch.bfloat16,
                             model_variant=variant, device=device)
        gen.scheduler_kind = cfg["scheduler"]
        gen.timestep_spacing = cfg["spacing"]
        gen.set_inference_steps(cfg["steps"])
        gen.batch_size = min(count, batch)
        if fast or heads_per_program != 1:
            gen.model_manager.set_attention_tuning(
                heads_per_program=heads_per_program, fast_math=fast)
        row = score_rung(gen, class_name, count,
                         Path(str(run_root) + "_runs") / tag,
                         seed=seed, stats=stats, s_held=s_held, tag=tag,
                         log=log)
        row.update(scheduler=cfg["scheduler"], steps=cfg["steps"],
                   spacing=cfg["spacing"], fast_math=fast)
        return row

    for cfg in configs:
        base = one(cfg, False)
        report["rows"].append(base)
        if ab_fast_math:
            fastrow = one(cfg, True)
            fastrow["frechet_delta_vs_exact"] = round(
                fastrow["frechet_vs_heldout"] - base["frechet_vs_heldout"], 3)
            report["rows"].append(fastrow)

    out_file = out if out.suffix else out / "report.json"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(report, indent=2))
    log(f"[score] report -> {out_file}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--checkpoints", required=True)
    p.add_argument("--out", default="artifacts/score_checkpoint.json")
    p.add_argument("--configs", default="ddim:50:trailing")
    p.add_argument("--class", dest="class_name", default="MEL")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--heldout", type=int, default=128)
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--variant", default="best")
    p.add_argument("--ab-fast-math", action="store_true",
                   help="score each config with exact AND bf16-exponential "
                        "attention; report the Fréchet delta")
    p.add_argument("--heads-per-program", type=int, default=1)
    p.add_argument("--flagship", action="store_true",
                   help="full-size UNet2DConfig instead of the e2e loop's "
                        "quarter-width config")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to sample on")
    args = p.parse_args(argv)
    score_checkpoint(args.checkpoints, args.out, parse_configs(args.configs),
                     class_name=args.class_name, size=args.size,
                     count=args.count, heldout=args.heldout, seed=args.seed,
                     batch=args.batch, variant=args.variant,
                     ab_fast_math=args.ab_fast_math, flagship=args.flagship,
                     heads_per_program=args.heads_per_program,
                     device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
