"""Shared scoring battery for the quality ladders.

The port of `scripts/ladder_common.py`: one home for the pieces
`sampler_ladder`, `distill_ladder` and `score_checkpoint` share: the
feature-stats closure, the warm-every-shape rule, and the warm+timed
scoring of one rung through `ImageGenerator`.

Two measurement rules live here, both load-bearing:

* **Warm EVERY block size the timed run will use.** `generate_images`
  runs device blocks of `batch_size` plus one remainder block when
  `count % batch_size != 0`. The first walk at a new batch size pays its
  first-use costs inside that walk: cuDNN's algorithm choice for each
  convolution shape, the caching allocator's growth to the new peak, and,
  on the first walk of a process, the `nvcc` build of the attention
  kernels. A warm pass of a single full block would leave the remainder
  block's first use inside the timed window, billed to that rung's img/s
  (`warm_images` returns the count that covers both sizes).
* **Warm with a DIFFERENT seed than the timed run.** A warm pass on the
  timed run's own seeds would write the same files the timed run then
  overwrites, and would let any cache keyed on the inputs serve the timed
  run; distinct seeds keep the timed run the work it claims to be.

`score_rung` stops its clock only after the device has finished: the
pipelined `generate_images` returns once the last block's images are on the
host and written, and a `synchronize` on the generator's device then
confirms nothing of the run is still queued.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

# seed offset for warm passes: far outside any rung's per-index seed range
WARM_SEED_OFFSET = 100_000


def make_stats_fn(extractor) -> Callable:
    """(N,H,W,C) images -> (mean, cov) of the extractor's features."""

    def stats(imgs):
        f = np.asarray(extractor(imgs), np.float64)
        return f.mean(axis=0), np.cov(f, rowvar=False)

    return stats


def warm_images(total: int, batch: int) -> int:
    """Warm-pass image count that runs every block size of a timed
    `generate_images([(cls, total)])` run at device batch `batch`: one
    full block plus the remainder block when the division is uneven."""
    if total <= batch:
        return total
    rem = total % batch
    return batch + rem  # rem == 0 -> just the full block


def synchronize(gen) -> None:
    """Wait for the device work the generator queued (CUDA only)."""
    device = gen.model_manager.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def score_rung(gen, class_name: str, count: int, run_dir: Path, *,
               seed: int, stats: Callable, s_held, tag: str,
               log=print) -> Dict:
    """Warm + timed generation of one ladder rung through the production
    ImageGenerator; returns Fréchet-vs-heldout, img/s and wall seconds."""
    from ..metrics.fid import frechet_distance
    from .e2e_loop import load_generated_images

    run_dir = Path(run_dir)
    gen.save_trajectory = False
    gen.set_generation_seed(seed + WARM_SEED_OFFSET)
    gen.generate_images(
        [(class_name, warm_images(count, gen.batch_size))],
        str(run_dir.with_name(run_dir.name + "_warm")), postprocess=False)
    gen.set_generation_seed(seed)
    synchronize(gen)
    t0 = time.time()
    result = gen.generate_images([(class_name, count)], str(run_dir),
                                 postprocess=False)
    synchronize(gen)
    if "error" in result:
        raise RuntimeError(f"{tag} failed: {result['error']}")
    wall = time.time() - t0
    imgs = load_generated_images(run_dir / class_name, count)
    fd = float(frechet_distance(*stats(imgs), *s_held))
    log(f"[ladder] {tag}: frechet={fd:.3f} "
        f"{result['images_per_second']} img/s")
    return {"tag": tag, "frechet_vs_heldout": round(fd, 3),
            "img_per_s": result["images_per_second"],
            "wall_s": round(wall, 1)}
