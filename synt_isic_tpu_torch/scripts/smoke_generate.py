"""Smoke sampler: N images per available class, minimal dependencies.

The port of `scripts/smoke_generate.py` (a rebuild of the reference's
`diffusion/generate_test.py`): for every class with a checkpoint, load
`unet_<CLASS>_best.pth` (or `unet_<CLASS>_epoch<N>.pth` with `--epoch`),
sample `--samples` images at `--steps` DDPM steps from the seeds
`arange(samples) + seed * 1000`, and write `<CLASS>_sample<i>.png`. The
quickest end-to-end visual check of a checkpoint set. Exits 1 when the
folder holds no checkpoint.

    python -m synt_isic_tpu_torch.scripts.smoke_generate --checkpoints checkpoints --steps 50
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
from PIL import Image

from ..diffusion.sampler import to_uint8_images
from ..io.images import save_image
from ..model_manager import ModelManager


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` (a `UNet2DConfig`) sizes the models; the flagship
    architecture by default."""
    p = argparse.ArgumentParser(description="per-class smoke generation")
    p.add_argument("--checkpoints", default="checkpoints")
    p.add_argument("--output", default="test_generated")
    p.add_argument("--samples", type=int, default=4)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--epoch", type=int, default=None,
                   help="load unet_<CLASS>_epoch<N>.pth instead of best")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    mm = ModelManager(checkpoints_dir=args.checkpoints, device=args.device,
                      model_config=model_config)
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    classes = mm.get_available_classes()
    if not classes:
        print(f"no checkpoints found in {args.checkpoints}")
        return 1
    print(f"classes: {classes}")

    for cls in classes:
        ckpt = None
        if args.epoch is not None:
            cand = Path(args.checkpoints) / f"unet_{cls}_epoch{args.epoch}.pth"
            ckpt = str(cand) if cand.exists() else None
        if not mm.load_model(cls, checkpoint_path=ckpt):
            print(f"  {cls}: load failed, skipping")
            continue
        sampler = mm.create_sampler(args.steps)
        seeds = (np.arange(args.samples) + args.seed * 1000).astype(np.uint32)
        t0 = time.time()
        out = sampler.sample(mm.loaded_models[cls], seeds)
        images = to_uint8_images(out["images"])
        for i in range(args.samples):
            save_image(Image.fromarray(images[i]), str(out_dir / f"{cls}_sample{i}.png"))
        print(f"  {cls}: {args.samples} samples in {time.time() - t0:.1f}s")
        mm.unload_model(cls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
