"""Build the kernels ahead of traffic and time each production walk cold
and warm.

The port of `scripts/warm_cache.py`. The JAX tool fills JAX's persistent
compilation cache, so a later process skips minutes of compiling. The port
has no executable cache: what carries across processes is the `nvcc` build
of the hand-written kernels alone. So this tool

  1. builds both kernels (`ops/native.build`) into `ops/native.build_dir()`
     (`$SYNT_ISIC_CACHE_DIR`, else the package's `_build/`): run it while
     building a container image, ship that directory, and start the serving
     processes with the same `$SYNT_ISIC_CACHE_DIR`; then none runs `nvcc`;
  2. fabricates a random full-width checkpoint (weights do not change which
     kernels run) and runs every `SCHED:STEPS:BATCH` config twice through
     `ImageGenerator._sample_batch`, the serve daemon's engine, waiting for
     the device each time: the first (cold) walk pays this process's
     first-use costs (the model's load, the kernel's, cuDNN's plans, the
     allocator's blocks),
     the second (warm) walk is the steady rate;
  3. runs the classifier forward at each `--classifier-batches` size, cold
     and warm.

It prints the cold and the warm seconds of each. The cold costs other than
the build recur in every new process: this tool takes none of them away
from a later one.

    python -m synt_isic_tpu_torch.scripts.warm_cache                  # default config set
    python -m synt_isic_tpu_torch.scripts.warm_cache --configs ddim:50:128 dpm_solver:20:128
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

DEFAULT_CONFIGS = ["ddim:50:128", "ddpm:1000:8", "dpm_solver:20:128"]


def _timed(fn, device: torch.device) -> float:
    """Seconds of `fn()` on the host clock, the device's work included."""
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` (a `UNet2DConfig`) sizes the fabricated checkpoint;
    the flagship architecture by default."""
    p = argparse.ArgumentParser(description="build the kernels and time each walk cold and warm")
    p.add_argument("--configs", nargs="*", default=DEFAULT_CONFIGS,
                   metavar="SCHED:STEPS:BATCH",
                   help=f"default: {' '.join(DEFAULT_CONFIGS)}")
    p.add_argument("--classifier-batches", nargs="*", type=int,
                   default=[64, 256], help="classifier forward batch sizes")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="must match the serve daemon's --dtype")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    from ..generator import ImageGenerator
    from ..io.pth import save_checkpoint
    from ..model_manager import resolve_device
    from ..models.classifier import LesionClassifier
    from ..models.unet2d import UNet2D, UNet2DConfig
    from ..ops import attention, native
    from ..utils.compute import enable_compilation_cache

    device = resolve_device(args.device)
    build_dir = enable_compilation_cache()
    if device.type == "cuda":
        t0 = time.perf_counter()
        native.build([attention.KERNEL, attention.BWD_KERNEL])
        print(f"  kernels built in {build_dir} ({time.perf_counter() - t0:.1f}s)", flush=True)

    with tempfile.TemporaryDirectory(prefix="warm_cache_") as work:
        ckpt_dir = Path(work)
        t0 = time.perf_counter()
        torch.manual_seed(0)
        save_checkpoint(UNet2D(model_config or UNet2DConfig()).state_dict(),
                        str(ckpt_dir / "unet_NV_best.pth"))
        print(f"  fabricated checkpoint ({time.perf_counter() - t0:.1f}s)", flush=True)

        # the serve daemon's engine: the same ModelManager switches and sampler
        gen = ImageGenerator(
            checkpoints_dir=str(ckpt_dir), device=device, model_config=model_config,
            compute_dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32)
        for spec in args.configs:
            sched, steps, batch = spec.split(":")
            gen.set_inference_steps(int(steps))
            gen.scheduler_kind = sched
            seeds = np.arange(int(batch), dtype=np.uint32)

            def walk():
                out = gen._sample_batch("NV", seeds, capture_trajectory=False)
                if out is None:
                    raise RuntimeError("the fabricated checkpoint did not load")

            cold, warm = _timed(walk, device), _timed(walk, device)
            print(f"  {spec}: cold {cold:.3f}s, warm {warm:.3f}s", flush=True)

        clf = LesionClassifier.random_init(device=device)
        for b in args.classifier_batches:
            x = torch.zeros((b, 128, 128, 3), device=device)
            cold = _timed(lambda: clf.get_probabilities(x), device)
            warm = _timed(lambda: clf.get_probabilities(x), device)
            print(f"  classifier b{b}: cold {cold:.3f}s, warm {warm:.3f}s", flush=True)
    print(f"every walk ran; the kernel builds are in {build_dir}" if device.type == "cuda"
          else "every walk ran (the CPU runs no kernel)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
