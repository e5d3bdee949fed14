"""Bilinear resizing with `jax.image.resize`'s semantics.

`jax.image.resize(..., "bilinear")` samples at half-pixel centres and, on
an axis that shrinks, widens the triangle kernel by the shrink factor
(antialiasing); on an axis that grows it interpolates between the two
nearest pixels. `F.interpolate(antialias=True)` computes the same weights
axis by axis (a kernel widened only where the scale is below 1, normalised
over the pixels it covers). Where no axis shrinks, plain bilinear
interpolation is the same function and rounds its sample positions as XLA
does (1.2e-7 from JAX at 128 -> 224, against 8e-6 through the antialiased
path), so it takes that one.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, size[0], size[1]), as `jax.image.resize(...,
    "bilinear")` resizes the two spatial axes. Differentiable."""
    size = (int(size[0]), int(size[1]))
    if tuple(x.shape[-2:]) == size:
        return x
    shrinks = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrinks)
