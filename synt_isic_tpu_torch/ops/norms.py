"""GroupNorm(+SiLU) with f32 statistics and working-dtype arithmetic.

The port of `synt_isic_tpu/ops/norms.py`, plain PyTorch ops (it was never a
Pallas kernel). The standard path normalises an f32 copy of the activation;
on the bf16 sampling path this one keeps the tensor arithmetic in bf16 and
takes only the per-(batch, group) statistics in f32, folded into per-(B, C)
coefficients for one multiply-add. Results differ from the f32 path by
bf16 rounding only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def group_norm_silu_fast(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float = 1e-5,
                         silu: bool = True) -> torch.Tensor:
    """GroupNorm (+ optional SiLU) over the channel axis 1.

    x: (B, C, ...) in any float dtype (bf16 intended). Returns x.dtype.
    """
    b, c = x.shape[0], x.shape[1]
    xg = x.reshape(b, groups, -1)

    # f32-accumulated statistics
    mean = xg.mean(dim=2, dtype=torch.float32)                        # (B, G)
    mean_sq = xg.float().square().mean(dim=2)
    var = (mean_sq - mean.square()).clamp_min(0.0)
    inv = torch.rsqrt(var + eps)                                      # (B, G)

    # fold everything into per-(B, C) affine coefficients in f32, then do a
    # single multiply-add in x's dtype
    scale_f = scale.float().reshape(groups, c // groups)
    bias_f = bias.float().reshape(groups, c // groups)
    a = (inv[:, :, None] * scale_f[None]).reshape(b, c)               # (B, C)
    d = (bias_f[None] - (mean * inv)[:, :, None] * scale_f[None]).reshape(b, c)

    bshape = (b, c) + (1,) * (x.dim() - 2)
    y = x * a.reshape(bshape).to(x.dtype) + d.reshape(bshape).to(x.dtype)
    return F.silu(y) if silu else y
