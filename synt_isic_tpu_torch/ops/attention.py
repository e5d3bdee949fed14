"""Spatial self-attention core, softmax(q k^T / sqrt(D)) v, for the UNet.

`fused_attention` is the port of the Pallas `fused_attention` (both
layouts) in synt_isic_tpu/ops/pallas/attention.py. For a CUDA tensor it
launches the hand-written kernel `csrc/attention_fwd.cu` or raises; for a
CPU tensor it runs `attention_reference`, the plain PyTorch version that the
tests and `chip_smoke.py` hold the kernel against. There is no other route.

q, k, v are (B, H, T, D) tensors of any strides, so a view of a (B, T, C)
projection output (`z.view(B, T, H, D).transpose(1, 2)`) goes in without a
copy, and the kernel's result keeps q's strides, so it reshapes back to
(B, T, C) for free.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import native

KERNEL = "attention_fwd"
HEAD_DIMS = (4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each hand-written kernel, counted where the wrapper launches it
# and nowhere else, so a run can show that its main path went through them.
LAUNCHES = {KERNEL: 0}


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The JAX model's einsum path (`models/unet2d.py` AttentionBlock):
    f32 logits, f32 softmax, probabilities cast to v's dtype, f32 P.V,
    result in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = native.load(KERNEL)
    fn = lib.attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    fast_math: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D) tensors, in q's dtype
    (on CUDA with q's strides where q is dense)."""
    if fast_math:
        raise NotImplementedError("fast_math (bf16 exponentials) is not ported yet")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, T, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, h, t, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {d}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 16)(*q.stride(), *k.stride(), *v.stride(),
                                    *out.stride())
    with torch.cuda.device(q.device):
        err = _lib().attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, t, d, _DTYPE_CODES[q.dtype], strides, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    LAUNCHES[KERNEL] += 1
    return out
