"""Counterfactual interventions: x~ = x·(1-M) + intervention·M.

The port of `synt_isic_tpu/xai/interventions.py` (reference
`counterfactual_intervention_advanced`, `xai/XAI.py:1454-1597`): the 7
intervention types (noise, gaussian_noise with adaptive std, zero, mean,
blur via stride-1 average pooling, inpaint via a 5x5 mean, in-mask pixel
shuffle) and noise for an unknown type, blending with the mask, clamp to
[-1,1], and the same statistics dict. NHWC tensors on the image's device.

Random draws come from an explicit CPU `torch.Generator` (a seeded one
when none is given) and move to the device, so a run on the card and one
on the CPU draw the same numbers. `noise=` (the image's shape) and
`uniform=` (the shuffle's sort keys, (B, H*W, C)) inject them instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

INTERVENTION_TYPES = ["noise", "gaussian_noise", "zero", "mean", "blur",
                      "inpaint", "shuffle"]

NOISE_STD = 0.5
BLUR_KERNEL_SIZE = 5


def _avg_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Stride-1 zero-padded average over NHWC (count_include_pad=True, the
    reference blur's `F.avg_pool2d(..., padding=k//2)`)."""
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), k, stride=1, padding=k // 2,
                       count_include_pad=True)
    return out.permute(0, 2, 3, 1)


def _draw(shape, generator: torch.Generator, device, normal: bool) -> torch.Tensor:
    fn = torch.randn if normal else torch.rand
    return fn(tuple(shape), generator=generator).to(device)


def _shuffle_in_mask(x: torch.Tensor, mask: torch.Tensor,
                     uniform: torch.Tensor) -> torch.Tensor:
    """Permute pixel values within the mask, independently per image and
    channel: sort each (image, channel) column's pixels by (masked first,
    by their key in `uniform`), rotate the masked prefix by one, scatter
    back. `uniform`: (B, H*W, C) keys in [0, 1)."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    m = mask.reshape(1, h * w, 1) if mask.ndim == 2 else mask.reshape(b, h * w, c)
    m = m.expand(flat.shape)
    order = torch.argsort(torch.where(m, uniform, 2.0), dim=1, stable=True)
    gathered = torch.gather(flat, 1, order)
    n_masked = m.sum(dim=1, keepdim=True)
    idx = torch.arange(h * w, device=x.device).view(1, h * w, 1)
    rotated = torch.where(idx < n_masked, (idx + 1) % n_masked.clamp(min=1), idx)
    shuffled = torch.gather(gathered, 1, rotated.expand(flat.shape))
    out = torch.zeros_like(flat).scatter(1, order, shuffled)
    return torch.where(m, out, flat).reshape(b, h, w, c)


def counterfactual_intervention_advanced(image: torch.Tensor, mask,
                                         intervention_type: str = "noise",
                                         generator: Optional[torch.Generator] = None,
                                         noise: Optional[Any] = None,
                                         uniform: Optional[Any] = None,
                                         **kwargs) -> Dict[str, Any]:
    """image: (B,H,W,C) in [-1,1]; mask: (H,W) bool/float or broadcastable."""
    noise_std = kwargs.get("noise_std", NOISE_STD)
    blur_kernel = kwargs.get("blur_kernel", BLUR_KERNEL_SIZE)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if image.ndim == 3:
        image = image[None]
    device = image.device

    mask_np = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask)
    mask_t = torch.as_tensor(mask_np.astype(np.float32), device=device)
    while mask_t.ndim < image.ndim:
        mask_t = mask_t[None] if mask_t.ndim != 2 else mask_t[..., None]
    mask_t = mask_t.expand(image.shape)

    def drawn_noise(std) -> torch.Tensor:
        z = (_draw(image.shape, generator, device, normal=True) if noise is None
             else torch.as_tensor(np.array(noise), dtype=image.dtype, device=device))
        return z * std

    if intervention_type == "gaussian_noise":
        intervention = drawn_noise(torch.clamp(torch.std(image, unbiased=False) * 0.5,
                                               min=noise_std))
    elif intervention_type == "zero":
        intervention = torch.zeros_like(image)
    elif intervention_type == "mean":
        intervention = image.mean(dim=(1, 2), keepdim=True).expand(image.shape)
    elif intervention_type == "blur":
        k = blur_kernel + 1 if blur_kernel % 2 == 0 else blur_kernel
        intervention = _avg_pool_same(image, k)
    elif intervention_type == "inpaint":
        intervention = _avg_pool_same(image, 5)
    elif intervention_type == "shuffle":
        b, h, w, c = image.shape
        keys = (torch.as_tensor(np.array(uniform), dtype=torch.float32, device=device)
                if uniform is not None else _draw((b, h * w, c), generator, device, normal=False))
        intervention = _shuffle_in_mask(image, torch.as_tensor(mask_np > 0.5, device=device),
                                        keys)
    else:  # "noise", and the reference's fallback for an unknown type
        intervention = drawn_noise(noise_std)

    modified = torch.clamp(image * (1 - mask_t) + intervention * mask_t, -1.0, 1.0)
    diff = torch.abs(image - modified)
    return {
        "modified_image": modified,
        "intervention": intervention,
        "mask_tensor": mask_t,
        "difference": diff,
        "statistics": {
            "intervention_type": intervention_type,
            "mask_coverage": float(mask_t.mean()),
            "mean_difference": float(diff.mean()),
            "max_difference": float(diff.max()),
            "intervention_strength": float(intervention.abs().mean()),
        },
        "parameters": dict(kwargs),
    }
