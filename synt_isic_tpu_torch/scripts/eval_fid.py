"""FID-style evaluation between two image sets (or checkpoint generations).

The port of `scripts/eval_fid.py`: the same flags, plus `--device`
(default cuda; raises without CUDA unless `--device cpu`). Standard
Inception FID when `<checkpoints>/inception_v3.pth` exists, else the
classifier-feature Fréchet distance, labelled as such.

    python -m synt_isic_tpu_torch.scripts.eval_fid --a data/real/NV --b generated_images/NV
    python -m synt_isic_tpu_torch.scripts.eval_fid --a data/real/NV --generate NV --count 256
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..metrics.fid import FeatureExtractor, InceptionFeatureExtractor, compute_fid
from ..models.classifier import LesionClassifier


def load_dir(directory: str, limit: int) -> np.ndarray:
    from PIL import Image

    paths = (sorted(Path(directory).rglob("*.png")) +
             sorted(Path(directory).rglob("*.jpg")))[:limit]
    if not paths:
        raise SystemExit(f"no images in {directory}")
    out = []
    for p in paths:
        arr = np.asarray(Image.open(p).convert("RGB").resize((128, 128)),
                         dtype=np.float32) / 255.0
        out.append(arr * 2 - 1)
    return np.stack(out)


def generate(class_name: str, checkpoints: str, count: int, steps: int, seed: int,
             device: str, model_config=None) -> np.ndarray:
    """`count` DDIM images of one class from its checkpoint, in blocks of
    up to 64, as (N, H, W, 3) f32 in [-1, 1] on the host."""
    from ..model_manager import ModelManager

    mm = ModelManager(checkpoints_dir=checkpoints, device=device, model_config=model_config)
    if not mm.load_model(class_name):
        raise SystemExit(f"no checkpoint for {class_name}")
    sampler = mm.create_sampler(steps, scheduler="ddim")
    rng = np.random.default_rng(seed)
    chunks = []
    done = 0
    while done < count:
        n = min(64, count - done)
        seeds = rng.integers(0, 2**31 - 1, n).astype(np.uint32)
        images = sampler.sample(mm.loaded_models[class_name], seeds)["images"]
        chunks.append(images.float().cpu().numpy())
        done += n
    return np.concatenate(chunks)


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` (a `UNet2DConfig`) sizes the `--generate` model; the
    flagship architecture by default."""
    p = argparse.ArgumentParser()
    p.add_argument("--a", required=True, help="first image dir")
    p.add_argument("--b", help="second image dir")
    p.add_argument("--generate", help="generate set B for this class instead")
    p.add_argument("--checkpoints", default="checkpoints")
    p.add_argument("--count", type=int, default=256)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to extract features (and generate) on")
    args = p.parse_args(argv)

    a = load_dir(args.a, args.count)
    if args.b:
        b = load_dir(args.b, args.count)
    elif args.generate:
        b = generate(args.generate, args.checkpoints, args.count, args.steps, args.seed,
                     args.device, model_config)
    else:
        raise SystemExit("provide --b or --generate")

    inception_path = Path(args.checkpoints) / "inception_v3.pth"
    if inception_path.exists():
        fid = compute_fid(a, b, InceptionFeatureExtractor(str(inception_path),
                                                          device=args.device))
        print(f"FID (standard InceptionV3 pool3): {fid:.4f}  "
              f"(n_a={len(a)}, n_b={len(b)})")
        return 0
    clf_path = Path(args.checkpoints) / "classifier.pth"
    clf = (LesionClassifier.from_checkpoint(str(clf_path), device=args.device)[0]
           if clf_path.exists() else LesionClassifier.random_init(device=args.device))
    fid = compute_fid(a, b, FeatureExtractor(clf))
    print(f"frechet_distance (classifier-feature embedding, NOT Inception-FID; "
          f"add checkpoints/inception_v3.pth via `python -m "
          f"synt_isic_tpu_torch.app.download_models` or scripts/convert_inception.py "
          f"for standard FID): {fid:.4f}  (n_a={len(a)}, n_b={len(b)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
