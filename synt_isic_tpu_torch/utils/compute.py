"""Compute-environment helpers.

The port of `synt_isic_tpu/utils/compute.py`:
  * `enable_compilation_cache`: where the hand-written kernels' `nvcc`
    builds go and are loaded from (the counterpart of JAX's persistent
    compilation cache: a build is the only thing the port compiles that
    outlives a process);
  * `GPU_PEAKS`: the card's data-sheet peaks, the one source of the
    bounds that `chip_smoke.py` sets beside every kernel time.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def enable_compilation_cache(cache_dir: Optional[str] = None) -> Path:
    """Build and load the kernels (`ops/native.py`) under `cache_dir`, else
    `$SYNT_ISIC_CACHE_DIR`; with neither, the builds stay in the package's
    `_build/`. Returns the directory in use.

    `cache_dir` is written to `$SYNT_ISIC_CACHE_DIR`, which
    `ops/native.build_dir` reads at every build and load, so the processes
    this one starts use the directory too. Any other process uses it when it
    starts with the variable set. A build is keyed by its source, headers and
    flags, so a directory kept between processes (or shipped with a container
    image) spares each later process the `nvcc` run. Raises once a kernel is
    loaded from another directory: a process keeps the libraries it loaded."""
    from ..ops import native

    if not cache_dir:
        return native.build_dir()
    path = Path(cache_dir).resolve()
    if path != native.build_dir() and native.load.cache_info().currsize:
        raise RuntimeError(f"kernels are already loaded from {native.build_dir()}; "
                           f"set the build directory before the first launch")
    os.environ["SYNT_ISIC_CACHE_DIR"] = str(path)
    return path


# Card peaks, keyed by torch.cuda.get_device_name(): dense rates without
# sparsity from NVIDIA's data sheet for the H100 SXM at its full 700 W
# limit (a card set below it runs slower under load). "tf32_flops" is the
# dense TF32 rate; a product accurate to f32 on the tensor cores takes three
# TF32 passes (3xTF32), so f32 bounds use a third of it. "exp_per_s" is the
# special-function units' exponentials: 16 per clock per SM, 132 SMs, at the
# 1.98 GHz boost clock.
GPU_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 494.7e12,
        "bytes_per_s": 3.35e12,
        "exp_per_s": 16 * 132 * 1.98e9,
    },
}
