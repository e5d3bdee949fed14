"""Quality evidence for the img2img/inpainting augmentation path.

The port of `scripts/augment_eval.py`, with its flags and report keys and
`--device` (default cuda; raises without CUDA unless `--device cpu`).
Given a trained checkpoint (e.g. from
`synt_isic_tpu_torch.scripts.e2e_loop`), this measures what augmentation
actually buys on the procedural distribution, sampling through
`ModelManager` (f32 compute, as the JAX script's manager defaults to) and
`DiffusionSampler.img2img` on the loaded module:

  * a STRENGTH SWEEP — held-out source images augmented at each strength,
    scored by (a) Fréchet vs a held-out reference set (on-manifold?),
    (b) mean L2 distance to the source (how far they moved), with the
    sampler ladder's floor/ceiling anchors and a plain-generation rung
    (strength 1.0 ≈ full walk from noised source) for context. Each
    `wall_s` covers the walk and its images' copy to the host, which waits
    for the device.
  * a DIVERSITY probe — ONE source, many seeds at fixed strength: mean
    pairwise feature distance among variants vs the same among plain
    samples (how much usable variety augmentation yields per source).
  * an INPAINT rung — center-box mask at strength 1.0: Fréchet of the
    composites + exact preservation check of the unmasked region.

Reference anchor: the reference has no augmentation path at all (its
generator is noise-only, `core/generator/image_generator.py:395-438`).

Usage (after an e2e_loop run):
    python -m synt_isic_tpu_torch.scripts.augment_eval \
        --checkpoints artifacts/e2e_loop/checkpoints \
        --out artifacts/augment_eval.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import List, Optional

STRENGTHS = (0.2, 0.4, 0.6, 0.8, 1.0)


def run_eval(checkpoints: str, out_path: str, class_name: str = "MEL",
             size: int = 128, count: int = 64, heldout: int = 128,
             steps: int = 50, seed: int = 1, spacing: str = "trailing",
             diversity_seeds: int = 32, model_config=None,
             strengths=STRENGTHS, log=print,
             device: Optional[str] = None) -> dict:
    """`device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent)."""
    import numpy as np

    from ..metrics.fid import PixelFeatureExtractor, frechet_distance
    from ..model_manager import ModelManager
    from ..train.procedural import procedural_images
    from .e2e_loop import small_unet_config
    from .ladder_common import make_stats_fn

    if model_config is None:
        model_config = small_unet_config(size)
    mm = ModelManager(checkpoints_dir=checkpoints, model_config=model_config,
                      device=device)
    if not mm.load_model(class_name):
        raise SystemExit(f"cannot load {class_name} from {checkpoints}")
    model = mm.loaded_models[class_name]
    sampler = mm.create_sampler(steps, scheduler="ddim",
                                timestep_spacing=spacing)

    def host(out) -> np.ndarray:
        # the copy to the host waits for the walk: a clock read after it
        # covers the device's work
        return out["images"].cpu().numpy()

    extractor = PixelFeatureExtractor()
    stats = make_stats_fn(extractor)
    # disjoint index ranges: reference set, anchor split, and sources
    held = procedural_images(class_name, heldout, size, start_index=10_000)
    s_held = stats(held)
    half = heldout // 2
    floor = float(frechet_distance(*stats(held[:half]), *stats(held[half:])))
    rng = np.random.default_rng(seed)
    noise_ceiling = float(frechet_distance(
        *stats(np.clip(rng.normal(0, 1, held.shape), -1, 1)), *s_held))
    sources = procedural_images(class_name, count, size, start_index=20_000)

    def feats(imgs):
        return np.asarray(extractor(imgs), np.float64)

    report = {
        "class": class_name, "size": size, "count": count, "steps": steps,
        "timestep_spacing": spacing,
        "anchors": {"heldout_split_floor": round(floor, 3),
                    "noise_ceiling": round(noise_ceiling, 3)},
        "strength_sweep": [],
    }

    seeds = np.arange(count, dtype=np.uint32) + seed * 1000
    for s in strengths:
        t0 = time.time()
        imgs = host(sampler.img2img(model, seeds, sources, strength=float(s)))
        wall = time.time() - t0
        fd = float(frechet_distance(*stats(imgs), *s_held))
        l2 = float(np.mean(np.sqrt(np.mean((imgs - sources) ** 2,
                                           axis=(1, 2, 3)))))
        row = {"strength": s, "frechet_vs_heldout": round(fd, 3),
               "mean_rms_to_source": round(l2, 4), "wall_s": round(wall, 2)}
        report["strength_sweep"].append(row)
        log(f"[augment] strength={s}: frechet={fd:.3f} rms={l2:.4f}")

    # plain generation rung (same sampler, pure noise start) for context
    plain_imgs = host(sampler.sample(model, seeds + 500_000))
    fd_plain = float(frechet_distance(*stats(plain_imgs), *s_held))
    report["plain_generation_frechet"] = round(fd_plain, 3)
    log(f"[augment] plain generation: frechet={fd_plain:.3f}")

    # diversity: one source, many seeds, mid strength
    dseeds = np.arange(diversity_seeds, dtype=np.uint32) + 777_000
    one_src = np.broadcast_to(sources[0], (diversity_seeds,) + sources[0].shape)
    var = host(sampler.img2img(model, dseeds, one_src, strength=0.6))
    f_var, f_plain = feats(var), feats(plain_imgs[:diversity_seeds])

    def mean_pairwise(f):
        d = np.sqrt(((f[:, None] - f[None]) ** 2).sum(-1))
        return float(d[np.triu_indices(len(f), 1)].mean())

    report["diversity"] = {
        "strength": 0.6, "seeds": int(diversity_seeds),
        "mean_pairwise_feature_dist_variants": round(mean_pairwise(f_var), 4),
        "mean_pairwise_feature_dist_plain": round(mean_pairwise(f_plain), 4),
    }
    log(f"[augment] diversity: variants {report['diversity']['mean_pairwise_feature_dist_variants']} "
        f"vs plain {report['diversity']['mean_pairwise_feature_dist_plain']}")

    # inpaint rung: regenerate a center box, keep the border
    mask = np.zeros((size, size), np.float32)
    q = size // 4
    mask[q:-q, q:-q] = 1.0
    inp = host(sampler.img2img(model, seeds + 900_000, sources,
                               strength=1.0, mask=mask))
    fd_inp = float(frechet_distance(*stats(inp), *s_held))
    border = np.broadcast_to((mask == 0)[None, :, :, None], inp.shape)
    border_err = float(np.abs(inp[border] - sources[border]).max())
    report["inpaint_center_box"] = {
        "frechet_vs_heldout": round(fd_inp, 3),
        "border_max_abs_err": round(border_err, 6),
        "border_preserved": bool(border_err < 1e-4),
    }
    log(f"[augment] inpaint: frechet={fd_inp:.3f} "
        f"border_err={border_err:.2e}")

    out_p = Path(out_path)
    out_p.parent.mkdir(parents=True, exist_ok=True)
    out_p.write_text(json.dumps(report, indent=2))
    log(f"[augment] wrote {out_p}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoints", required=True)
    p.add_argument("--out", default="artifacts/augment_eval.json")
    p.add_argument("--class", dest="class_name", default="MEL")
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--count", type=int, default=64)
    p.add_argument("--heldout", type=int, default=128)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--timestep-spacing", choices=("leading", "trailing"),
                   default="trailing")
    p.add_argument("--width", choices=("quarter", "full"), default="quarter",
                   help="'full' = flagship ~25M topology")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to sample on")
    args = p.parse_args(argv)
    from .e2e_loop import unet_config

    run_eval(args.checkpoints, args.out, class_name=args.class_name,
             size=args.size, count=args.count, heldout=args.heldout,
             steps=args.steps, seed=args.seed,
             spacing=args.timestep_spacing,
             model_config=unet_config(args.size, args.width),
             device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
