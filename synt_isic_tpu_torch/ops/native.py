"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher. It is compiled
by `nvcc` into a shared library under `build_dir()` at first use and loaded
with `ctypes`; a change to the source, to a header of
`csrc/` or to the flags changes the file name, so a stale library is never
loaded. Nothing here runs at
import time: the CPU tests import every module without a CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
DEFAULT_BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """Where the kernels build to and load from: `$SYNT_ISIC_CACHE_DIR`
    when set, else the package's `_build/`. Read at every build and load,
    so each process (and each child it starts) follows its environment."""
    chosen = os.environ.get("SYNT_ISIC_CACHE_DIR")
    return Path(chosen).resolve() if chosen else DEFAULT_BUILD_DIR


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: install the CUDA toolkit or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by its source, the headers
    of `csrc/` (`*.cuh`, which the sources include) and the flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(path.name.encode() + path.read_bytes() for path in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, all `nvcc`s at
    once. Returns each name's compiler log (`-Xptxas -v` prints registers
    and shared memory per kernel); raises on the first failure."""
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
        logs[name] = log
    return logs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
