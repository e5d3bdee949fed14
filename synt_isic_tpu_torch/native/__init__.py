"""Host C++ morphology for the XAI region cleanup, loaded with `ctypes`.

The port's copy of `synt_isic_tpu/native/`: `morphology.cpp` (binary
closing and opening with a 3x3 structuring element, connected-component
labelling, removal of small components; the same results as
`scipy.ndimage`) is compiled by `g++` at first use into
`synt_isic_tpu_torch/_build/`, under a name keyed by a hash of the source
and the flags, and loaded with `ctypes`. `lib()` is None when there is no
compiler or the library does not load; `xai/regions.py` then takes
scipy's path. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "morphology.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmorphology-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing
    return True


@functools.cache
def lib() -> Optional[ctypes.CDLL]:
    """The morphology library, built first if needed; None when it cannot
    be built or loaded."""
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    try:
        cdll = ctypes.CDLL(str(out))
    except OSError:            # built, but not loadable on this host
        return None
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    for name in ("morph_dilate", "morph_erode", "morph_closing", "morph_opening"):
        fn = getattr(cdll, name)
        fn.argtypes = [u8, u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        fn.restype = None
    cdll.morph_label.argtypes = [u8, i32, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    cdll.morph_label.restype = ctypes.c_int
    cdll.morph_remove_small.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int]
    cdll.morph_remove_small.restype = None
    return cdll


def available() -> bool:
    return lib() is not None


def _morph(name: str, mask: np.ndarray, connectivity: int, iterations: int) -> np.ndarray:
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty_like(src)
    getattr(lib(), name)(src, out, src.shape[0], src.shape[1], connectivity, iterations)
    return out.astype(bool)


def binary_closing(mask: np.ndarray, connectivity: int = 2,
                   iterations: int = 2) -> np.ndarray:
    return _morph("morph_closing", mask, connectivity, iterations)


def binary_opening(mask: np.ndarray, connectivity: int = 2,
                   iterations: int = 1) -> np.ndarray:
    return _morph("morph_opening", mask, connectivity, iterations)


def label(mask: np.ndarray, connectivity: int = 2):
    src = np.ascontiguousarray(mask, dtype=np.uint8)
    labels = np.empty(src.shape, dtype=np.int32)
    n = lib().morph_label(src, labels, src.shape[0], src.shape[1], connectivity)
    return labels, int(n)


def remove_small_components(mask: np.ndarray, min_size: int,
                            connectivity: int = 2) -> np.ndarray:
    out = np.ascontiguousarray(mask, dtype=np.uint8).copy()
    lib().morph_remove_small(out, out.shape[0], out.shape[1], connectivity, min_size)
    return out.astype(bool)
