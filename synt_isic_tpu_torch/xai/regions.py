"""Top-k / bottom-k region selection with morphological cleanup.

A copy of `synt_isic_tpu/xai/regions.py` (host numpy; the C++ morphology
is the port's own copy, `synt_isic_tpu_torch/native/`). Parity with
reference `select_regions_advanced` (`xai/XAI.py:1340-1451`): channel-L2
collapse of the attribution map, percentile threshold, binary closing (2
iters) + opening (1 iter), removal of components smaller than max(10, 1%
of pixels), plus the same statistics/metadata dict.

Masks are 128² booleans: the morphology runs on the host (C++ or
scipy.ndimage, identical results), keeping the device free for the
classifier and attribution batches.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
from scipy import ndimage


def _collapse_channels(attr: np.ndarray) -> np.ndarray:
    """(B,H,W,C)/(H,W,C)/(H,W) -> (H,W) via channel L2 norm (abs if 2-D)."""
    if attr.ndim == 4:
        attr = attr[0]
    if attr.ndim == 3:
        return np.linalg.norm(attr, axis=-1)
    return np.abs(attr)


def select_regions_advanced(attribution_map, k_percent: float = 10,
                            region_type: str = "top",
                            morphology_cleanup: bool = True,
                            connectivity: int = 8,
                            use_native: bool = None) -> Dict[str, Any]:
    """use_native: route morphology through the C++ library
    (`synt_isic_tpu_torch/native/`); None = auto (native when buildable,
    scipy otherwise); True raises when it cannot be built. The two backends
    are bit-identical (tests/test_torch_xai.py)."""
    attr_np = np.asarray(attribution_map, dtype=np.float64)
    original_shape = attr_np.shape
    attr_np = _collapse_channels(attr_np)

    flat = attr_np.ravel()
    if region_type == "top":
        threshold = np.percentile(flat, 100 - k_percent)
        mask = attr_np >= threshold
    elif region_type == "bottom":
        threshold = np.percentile(flat, k_percent)
        mask = attr_np <= threshold
    else:
        raise ValueError(f"unknown region_type: {region_type}")

    if morphology_cleanup:
        conn12 = 1 if connectivity == 4 else 2
        min_size = max(10, int(0.01 * mask.size))
        if use_native is None or use_native:
            from .. import native
            native_ok = native.available()
        else:
            native_ok = False
        if use_native and not native_ok:
            raise RuntimeError("native morphology requested but unavailable")
        if native_ok and (use_native or use_native is None):
            mask = native.binary_closing(mask, connectivity=conn12, iterations=2)
            mask = native.binary_opening(mask, connectivity=conn12, iterations=1)
            mask = native.remove_small_components(mask, min_size,
                                                  connectivity=conn12)
        else:
            structure = ndimage.generate_binary_structure(2, conn12)
            mask = ndimage.binary_closing(mask, structure=structure, iterations=2)
            mask = ndimage.binary_opening(mask, structure=structure, iterations=1)
            labeled, num = ndimage.label(mask, structure=structure)
            if num > 0:
                sizes = ndimage.sum(mask, labeled, range(1, num + 1))
                keep = np.where(sizes >= min_size)[0] + 1
                mask = np.isin(labeled, keep)

    total = attr_np.size
    selected = int(np.sum(mask))
    sel_vals = attr_np[mask] if selected > 0 else np.zeros(1)
    return {
        "mask": mask,
        "threshold": float(threshold),
        "statistics": {
            "total_pixels": int(total),
            "selected_pixels": selected,
            "target_percentage": float(k_percent),
            "actual_percentage": float(selected / total * 100),
            "threshold_value": float(threshold),
            "mean_attribution": float(np.mean(attr_np)),
            "std_attribution": float(np.std(attr_np)),
            "mean_attribution_selected": float(np.mean(sel_vals)) if selected else 0.0,
            "std_attribution_selected": float(np.std(sel_vals)) if selected else 0.0,
            "max_attribution_selected": float(np.max(sel_vals)) if selected else 0.0,
            "min_attribution_selected": float(np.min(sel_vals)) if selected else 0.0,
        },
        "metadata": {
            "region_type": region_type,
            "morphology_cleanup": morphology_cleanup,
            "connectivity": connectivity,
            "original_shape": tuple(original_shape),
        },
    }
