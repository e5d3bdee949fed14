"""Spatial self-attention core, softmax(q k^T / sqrt(D)) v, for the UNet:
forward, backward and the autograd Function that binds them.

The port of synt_isic_tpu/ops/pallas/attention.py:
  * `fused_attention` (both Pallas layouts, with the knobs `fast_math` and
    `heads_per_program`) launches the hand-written kernel
    `csrc/attention_fwd.cu` for a CUDA tensor; it has no gradient, so under
    grad mode it refuses CUDA inputs that require grad;
  * `fused_attention_bwd` (the Pallas recompute backward, with its knob
    `heads_per_program`) launches `csrc/attention_bwd.cu`;
  * `fused_attention_trainable` (the Pallas `custom_vjp`) is the autograd
    Function `FusedAttention`: forward kernel, backward kernel. On CUDA its
    exact forward also writes each row's base-2 log-sum-exp, and it saves
    that and its output for the backward.
Every kernel runs on the tensor cores at every head_dim D >= 1 (up to 64 at
a staged width of 8, 16, 32 or 64 channels, the least one >= D,
`staged_width`, and above 64 in chunks of 64 channels; channels past D
zero-filled inside the kernel), in f32 (3xTF32) and bf16. The bf16 forward
at a staged width of 16 to 256 runs Hopper's warpgroup products (`wgmma`,
counted under WGMMA_KERNEL as well); head_dim 8 and the f32 forward keep
their `mma.sync` kernels, and heads wider than 64 channels (the bf16
forward: wider than 256) run the wide kernels (counted under WIDE_KERNEL
and BWD_WIDE_KERNEL as well), whose blocks form S once per tile for all of
a head's channels and split the channels of each product that gives
channels among their warps (bf16 on `wgmma`, f32 on `mma.sync`).
For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch version (`attention_reference`,
`attention_fast_math_reference`, `attention_bwd_reference`), which the
tests and `chip_smoke.py` hold the kernels against; the fast-math kernels
are also held to `attention_fast_math_kernel_order` (by each kernel's rule,
`fast_math_kernel_order`), the exact f32 forward (3xTF32
on the tensor cores) to `attention_tf32x3_kernel_order`, the bf16 backward to
`attention_bwd_kernel_order` and the f32 one (3xTF32) to
`attention_bwd_tf32x3_kernel_order`, the same maths rounded where the kernel
rounds, and the forward's log-sum-exp to `attention_lse_reference`. There is
no other route.

The UNet calls the wrappers with the same few layouts on every step, so a
CUDA call's checks run once per layout: the verdict, G and the kernel's
packed arguments are kept in `_PLANS`, keyed by everything the checks read,
and a call with a key not seen yet is checked in full first.

`heads_per_program` = G runs G heads per block group with bit-identical
maths, in the forward and the backward alike; as in the JAX package, a G
that does not divide the head count means G = 1 (`_group`), and every G >= 1
that divides it runs. A block of the kernels runs G' heads (`block_group`):
the widest of (1, 2, 4, 8) that divides G with G' times the staged width at
most 64, where the head fills its staged width and every staged tensor's
rows go in 16-byte units (`_wide`: every dense or (B, T, C) layout at a
staged head_dim); the `wgmma` forward and the wide kernels run one head a
block. The launcher runs the call's G heads as G / G' consecutive groups of
G' in one launch, so each head's arithmetic is that of G = 1, and the
launch counts as grouped when G > 1 on a wide layout. At head_dim 8 a
layout that is not wide is copied into fresh contiguous storage first, as
the head_dim-8 kernels have always taken it, so head_dim 8 runs those
kernels at every layout and G. On a CPU tensor G has no effect.

q, k, v (and do) are (B, H, T, D) tensors of any strides, so a view of a
(B, T, C) projection output (`z.view(B, T, H, D).transpose(1, 2)`) goes in
without a copy (the kernels stage each tensor in the largest unit its
layout allows, down to one element), and every result keeps q's strides
(dk and dv those of k and v), so it reshapes back to (B, T, C) for free.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Tuple

import torch

from . import native

KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
# counters of the forward kernel's variants (one source, `attention_fwd.cu`)
FAST_KERNEL = "attention_fwd_fast_math"
GROUPED_KERNEL = "attention_fwd_grouped"
# counter of the bf16 forward's warpgroup-product kernel (staged widths 16 to
# 256, `attention_fwd.cu`), counted beside KERNEL or FAST_KERNEL
WGMMA_KERNEL = "attention_fwd_wgmma"
# counter of the backward kernel's grouped variant (one source, `attention_bwd.cu`)
BWD_GROUPED_KERNEL = "attention_bwd_grouped"
# counters of the wide kernels (`uses_wide`: the f32 forward above 64 channels
# and the bf16 one above 256, `attention_fwd.cu`; the backward above 64,
# `attention_bwd.cu`), counted beside KERNEL or FAST_KERNEL, and BWD_KERNEL
WIDE_KERNEL = "attention_fwd_wide"
BWD_WIDE_KERNEL = "attention_bwd_wide"
# counter of the exact forward launches that a backward without saved
# statistics runs first for its o and log-sum-exp (`attention_fwd.cu`)
STATS_KERNEL = "attention_bwd_stats"
# the heads one block of the `mma.sync` kernels runs (`block_group`)
HEADS_PER_PROGRAM = (1, 2, 4, 8)
# the staged widths of the `mma.sync` templates (8 to 64) and of the bf16
# `wgmma` forward (16 to 256) (`staged_width`)
STAGED_WIDTHS = (8, 16, 32, 64, 128, 256)
# the widest head of the `mma.sync` templates and of the bf16 `wgmma` forward
MAX_MMA_WIDTH, MAX_WGMMA_WIDTH = 64, 256
# G' heads of the staged width at most: D 8 x G' 8, the widest staged row
MAX_GROUP_WIDTH = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each hand-written kernel, counted where the wrapper launches it
# and nowhere else, so a run can show that its main path went through them.
# A forward launch counts under KERNEL (exact softmax) or FAST_KERNEL
# (fast_math), under WGMMA_KERNEL too when it runs the bf16 warpgroup-product
# kernel, and under GROUPED_KERNEL too when it runs G > 1 heads (`_group`) on a
# wide layout, and under WIDE_KERNEL too when it runs the wide kernel. A
# backward launch counts under BWD_KERNEL, under BWD_GROUPED_KERNEL too when it
# runs G > 1 heads per block, and under BWD_WIDE_KERNEL too when it runs the
# wide kernels. The forward launch that gives such a backward its statistics
# counts under STATS_KERNEL only.
LAUNCHES = {KERNEL: 0, FAST_KERNEL: 0, GROUPED_KERNEL: 0, WGMMA_KERNEL: 0, WIDE_KERNEL: 0,
            BWD_KERNEL: 0, BWD_GROUPED_KERNEL: 0, BWD_WIDE_KERNEL: 0, STATS_KERNEL: 0}
LOG2E = 1.4426950408889634


def _scale_log2(head_dim: int) -> float:
    """The kernels' base-2 logit scale, 1/sqrt(D) * log2(e) in f32."""
    return (torch.tensor(1.0 / math.sqrt(head_dim)) * torch.tensor(LOG2E)).item()


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The JAX model's einsum path (`models/unet2d.py` AttentionBlock):
    f32 logits, f32 softmax, probabilities cast to v's dtype, f32 P.V,
    result in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(q.dtype)


def attention_fast_math_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """The Pallas kernel's `fast_math` branch step by step: f32 logits minus
    the row max, cast to bf16 and exponentiated in bf16; the row sum in
    f32; the weights cast to v's dtype; f32 P.V; then the division; the
    result in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    exp = torch.exp(logits.to(torch.bfloat16))
    denom = exp.float().sum(dim=-1, keepdim=True)
    pv = torch.matmul(exp.to(v.dtype).float(), v.float())
    return (pv / denom).to(q.dtype)


def fast_math_step(q: torch.Tensor) -> int:
    """Keys per running-max update of the fast-math kernel that takes
    tensors like q: a staged tile of 64 at every head_dim, in bf16 and f32."""
    return 64


def attention_fast_math_kernel_order(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     step: int, tf32x3: bool = False) -> torch.Tensor:
    """The CUDA kernels' fast-math rounding in plain PyTorch, to hold a
    kernel to a limit that exact attention does not meet. Where the Pallas
    branch (`attention_fast_math_reference`) rounds the natural-log logit
    minus the row's max, the kernels round the base-2 logit (log2(e) folded
    into the scale, in f32) minus the running max, which moves once per
    group of `step` keys (`fast_math_step`: a staged tile of 64; groups
    start at key 0, the last may be short), and
    take `exp2` of that bf16 value in bf16. Here, as there, the weights are
    brought onto the row's max in f32, summed and multiplied into v in f32,
    and the division comes last; the result is in q's dtype.

    `tf32x3` is the f32 tensor-core kernel's rule: the logits are the
    3xTF32 product of the exact f32 kernel (`_tf32x3_matmul` of the scaled
    q and k), and each group's max is taken over the one-pass product of
    the TF32 hi parts (within about 2^-10 of the logits), so the shifted
    logit may lie a little above 0."""
    t = q.shape[-2]
    qs, kt = q.float() * _scale_log2(q.shape[-1]), k.float().transpose(-1, -2)
    if tf32x3:
        logits = _tf32x3_matmul(qs, kt)
        peaks = torch.matmul(tf32_split(qs)[0], tf32_split(kt)[0])   # hi.hi alone
    else:
        logits = peaks = torch.matmul(qs, kt)
    groups = torch.nn.functional.pad(peaks, (0, -t % step), value=-math.inf)
    group_max = groups.unflatten(-1, (-1, step)).amax(dim=-1)
    run_max = group_max.cummax(dim=-1).values.repeat_interleave(step, dim=-1)[..., :t]
    exp = torch.exp2((logits - run_max).to(torch.bfloat16)).float()
    weights = exp * torch.exp2(run_max - run_max[..., -1:])
    pv = torch.matmul(weights, v.float())
    return (pv / weights.sum(dim=-1, keepdim=True)).to(q.dtype)


def fast_math_kernel_order(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """`attention_fast_math_kernel_order` by the rule of the fast-math kernel
    that takes tensors like q: its keys per max update (`fast_math_step`),
    and in f32 the 3xTF32 logits and one-pass tile max."""
    return attention_fast_math_kernel_order(
        q, k, v, fast_math_step(q), tf32x3=q.dtype == torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 x as TF32 (10 mantissa bits) hi + lo, as the f32 tensor-core
    kernel splits its operands: hi rounded to nearest with ties away from
    zero on the 13 low bits (as `cvt.rna.tf32.f32` rounds), lo = x - hi
    (exact) with its 13 low bits cleared (as the tensor cores read it)."""
    def bits(z):
        return z.contiguous().view(torch.int32)

    x = x.float()
    hi = ((bits(x) + 0x1000) & ~0x1FFF).view(torch.float32).view(x.shape)
    return hi, (bits(x - hi) & ~0x1FFF).view(torch.float32).view(x.shape)


def _tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in f32 as the f32 tensor-core kernels form it: both operands
    split (`tf32_split`), lo.hi + hi.lo + hi.hi, the small terms first."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def attention_tf32x3_kernel_order(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """The f32 tensor-core kernel's arithmetic (`attention_fwd.cu`, exact f32)
    in plain PyTorch, to hold the kernel to its own rounding.
    q is scaled to base-2 logits in f32 (1/sqrt(D) * log2(e)), then q, k, v
    and the weights are split into TF32 hi and lo parts (`tf32_split`), and
    each product is lo.hi + hi.lo + hi.hi in f32, the small terms first
    (lo.lo is dropped). The keys go in tiles of 64, the weights of a tile
    taken as p = 2^(s - shift) in f32 against a running shift: on the first
    tile the tile's max of one TF32 product (hi.hi, within about 2^-10 of the
    logits), then, after a tile whose row sum passes 2^16, shift + log2 of
    that sum (the softmax does not depend on the shift). A tile's sum
    and P V are added to the running ones, which follow the shift in f32;
    the division comes last. (The kernel also takes a tile's max first where
    its weights would pass 2^40 against the running shift: logits that jump
    by more than 40 within a row, which this leaves out.) The result is f32."""
    qs = q.float() * _scale_log2(q.shape[-1])
    m = torch.full(q.shape[:-1], -math.inf, device=q.device)
    total = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)

    def shift_to(new):
        c = torch.where(new > m, torch.exp2(m - new), torch.ones_like(m))
        return new, total * c, acc * c[..., None]

    for j in range(0, q.shape[-2], 64):
        kt = k[..., j:j + 64, :].float().transpose(-1, -2)
        if j == 0:
            first = torch.matmul(tf32_split(qs)[0], tf32_split(kt)[0])   # hi.hi alone
            m, total, acc = shift_to(torch.maximum(m, first.amax(dim=-1)))
        p = torch.exp2(_tf32x3_matmul(qs, kt) - m[..., None])
        tile = p.sum(dim=-1)
        total = total + tile
        acc = acc + _tf32x3_matmul(p, v[..., j:j + 64, :].float())
        m, total, acc = shift_to(torch.where(tile > 2.0 ** 16, m + torch.log2(tile), m))
    return acc / total[..., None]


def attention_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv), step for step as the Pallas `_attention_bwd_kernel`:
    probabilities rebuilt in f32 and cast to v's dtype; dv = P^T do and
    dp = do v^T in f32; ds = P (dp - rowsum(dp P)) scale; ds cast to q's
    dtype before dq = ds k and dk = ds^T q; results in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits - logits.amax(dim=-1, keepdim=True)
    exp = torch.exp(logits)
    probs = (exp / exp.sum(dim=-1, keepdim=True)).to(v.dtype).float()
    dv = torch.matmul(probs.transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    row = (dp * probs).sum(dim=-1, keepdim=True)
    ds = (probs * (dp - row) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each query row's base-2 log-sum-exp, log2 sum_j 2^(s_ij) with the
    base-2 logits s = q k^T / sqrt(D) * log2(e), in f32, (B, H, T): what
    the exact forward kernel writes for the backward."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale_log2(q.shape[-1])
    peak = logits.amax(dim=-1, keepdim=True)
    return (peak + torch.log2(torch.exp2(logits - peak).sum(dim=-1, keepdim=True))).squeeze(-1)


def attention_bwd_kernel_order(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               do: torch.Tensor, o: torch.Tensor, lse: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The bf16 backward kernel's rounding in plain PyTorch, step for step,
    from the forward's output `o` (primal dtype) and base-2 log-sum-exp
    `lse`: P = 2^(q k^T * scale * log2(e) - lse) in f32, rounded to v's
    dtype; dv = P^T do and dp = do v^T in f32; delta = do . o in f32;
    ds = P (dp scale - delta scale) rounded to q's dtype; dq = ds k and
    dk = ds^T q in f32; results in q's dtype."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1])).item()
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.exp2(logits * _scale_log2(q.shape[-1]) - lse.float()[..., None])
    probs = probs.to(v.dtype).float()
    dv = torch.matmul(probs.transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    delta = (do.float() * o.float()).sum(dim=-1, keepdim=True)
    ds = (probs * (dp * scale - delta * scale)).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention_bwd_tf32x3_kernel_order(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      do: torch.Tensor, o: torch.Tensor, lse: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 tensor-core backward's arithmetic (`attention_bwd.cu`, f32)
    in plain PyTorch, to hold the kernel to its own rounding,
    from the forward's output `o` and base-2 log-sum-exp `lse`. Every
    product is 3xTF32 (`_tf32x3_matmul`): S = q k^T and dP = do v^T;
    P = 2^(S * scale * log2(e) - lse) with the shift rounded once, as the
    kernel's fma does; delta = do . o; dS = P (dP - delta); dq = dS k summed
    per tile of 64 keys, dv = P^T do and dk = dS^T q per tile of 64 queries,
    the tiles' partial sums added in f32; dq and dk times 1/sqrt(D) last.
    Nothing is rounded below f32. The results are f32."""
    q, k, v, do, o = (z.float() for z in (q, k, v, do, o))
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1])).item()
    s = _tf32x3_matmul(q, k.transpose(-1, -2))
    p = torch.exp2((s.double() * _scale_log2(q.shape[-1]) - lse.double()[..., None]).float())
    dp = _tf32x3_matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    dq, dk, dv = (torch.zeros_like(z) for z in (q, k, v))
    for j in range(0, q.shape[-2], 64):
        tile = slice(j, j + 64)
        dq = dq + _tf32x3_matmul(ds[..., tile], k[..., tile, :])
        dk = dk + _tf32x3_matmul(ds[..., tile, :].transpose(-1, -2), q[..., tile, :])
        dv = dv + _tf32x3_matmul(p[..., tile, :].transpose(-1, -2), do[..., tile, :])
    return dq * scale, dk * scale, dv


def _check(*tensors: torch.Tensor) -> str:
    """Validate one (B, H, T, D) call; returns the device type."""
    q = tensors[0]
    if q.dim() != 4 or any(z.shape != q.shape for z in tensors):
        raise ValueError(f"inputs must share one (B, H, T, D) shape, got "
                         f"{[tuple(z.shape) for z in tensors]}")
    if any(z.device != q.device for z in tensors):
        raise ValueError("inputs must be on one device")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    if q.device.type == "cuda":
        if any(z.dtype != q.dtype for z in tensors) or q.dtype not in _DTYPE_CODES:
            raise ValueError(f"kernel takes float32 or bfloat16 inputs of one "
                             f"dtype, got {[z.dtype for z in tensors]}")
        _check_head_dim(q.shape[-1])
    return q.device.type


def _check_head_dim(head_dim: int) -> None:
    """A CUDA call takes every head_dim >= 1; below 1 raises."""
    if head_dim < 1:
        raise ValueError(f"kernel takes head_dim >= 1, got {head_dim}")


class _FwdArgs(ctypes.Structure):
    """`FwdArgs` of `csrc/attention_fwd.cu`: one checked forward layout."""
    _fields_ = [("strides", ctypes.c_int64 * 16)] + [
        (name, ctypes.c_int32) for name in ("batch", "heads", "seq_len", "head_dim", "dtype",
                                             "heads_per_program", "fast_math")] + [
        ("scale", ctypes.c_float)]


class _BwdArgs(ctypes.Structure):
    """`BwdArgs` of `csrc/attention_bwd.cu`: one checked backward layout."""
    _fields_ = [("strides", ctypes.c_int64 * 32)] + [
        (name, ctypes.c_int32) for name in ("batch", "heads", "seq_len", "head_dim", "dtype",
                                             "heads_per_program")] + [
        ("scale", ctypes.c_float)]


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = native.load(name)
    fn = lib.attention_fwd if name == KERNEL else lib.attention_bwd
    fn.argtypes = [ctypes.c_void_p] * (7 if name == KERNEL else 12)
    fn.restype = ctypes.c_int
    return lib


def staged_width(head_dim: int) -> int:
    """The staged width of a head up to 256 channels, the least of
    STAGED_WIDTHS that holds it: the `mma.sync` templates' (up to 64) and
    the bf16 `wgmma` forward's. The wide kernels stage no width: they walk a
    head in chunks of 64 channels (`staged_channels`)."""
    if head_dim > MAX_WGMMA_WIDTH:
        raise ValueError(f"no staged width above {MAX_WGMMA_WIDTH} channels, got {head_dim}")
    return next(w for w in STAGED_WIDTHS if head_dim <= w)


def staged_channels(head_dim: int) -> int:
    """The channels the kernels stage a head in: its staged width up to 64
    channels, above it the head's 64-channel chunks (the wide kernels). The
    f32 products over channels (S, dP) chain over these in k-steps of 8, so
    the f32 limits against the rounding orders grow as its square root
    (`chip_smoke.py` `tf32_order_tol`)."""
    return staged_width(head_dim) if head_dim <= MAX_MMA_WIDTH else 64 * -(-head_dim // 64)


def uses_wgmma(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a CUDA forward of this dtype and head_dim runs the bf16
    warpgroup-product kernel: bf16 at a staged width of 16 to 256."""
    return dtype == torch.bfloat16 and 8 < head_dim <= MAX_WGMMA_WIDTH


def uses_wide(dtype: torch.dtype, head_dim: int, forward: bool = True) -> bool:
    """Whether a CUDA call of this dtype and head_dim runs the wide kernels:
    heads wider than 64 channels, in the bf16 forward wider than 256."""
    if forward and dtype == torch.bfloat16:
        return head_dim > MAX_WGMMA_WIDTH
    return head_dim > MAX_MMA_WIDTH


def _group(heads: int, heads_per_program: int) -> int:
    """G as the Pallas wrapper takes it: a G that does not divide the head
    count means 1; any G >= 1 that divides it runs."""
    g = int(heads_per_program)
    if g < 1:
        raise ValueError(f"heads_per_program must be >= 1, got {g}")
    return g if heads % g == 0 else 1


def block_group(group: int, head_dim: int, dtype: torch.dtype, wide: bool,
                forward: bool = True) -> int:
    """G', the heads one block runs for a call of G = `group` heads per
    program: the widest of HEADS_PER_PROGRAM that divides G with G' times
    the staged width at most MAX_GROUP_WIDTH, on a wide layout; 1 on any
    other layout, for the `wgmma` forward and for heads wider than 64 (the
    wide kernels). The launch runs the G heads as G / G' consecutive groups
    of G'."""
    if not wide or head_dim > MAX_GROUP_WIDTH or (forward and uses_wgmma(dtype, head_dim)):
        return 1
    width = staged_width(head_dim)
    g = 1
    while 2 * g in HEADS_PER_PROGRAM and group % (2 * g) == 0 and 2 * g * width <= MAX_GROUP_WIDTH:
        g *= 2
    return g


def _wide(*tensors: torch.Tensor) -> bool:
    """Whether the kernels take these tensors at their Wide instances, as
    the launchers decide it: a head that fills the channels it is staged
    in (`staged_channels`), and every row staged in 16-byte units
    (`stage_unit` in `csrc/tensor_core.cuh`: channels contiguous, the
    address and the t, h and b strides in bytes multiples of 16). The kernels run any G there,
    G = 1 elsewhere."""
    return all(z.shape[-1] == staged_channels(z.shape[-1]) and z.stride(-1) == 1
               and z.data_ptr() % 16 == 0
               and all(st * z.element_size() % 16 == 0 for st in z.stride()[:3])
               for z in tensors)


def _copies(*tensors: torch.Tensor) -> Tuple[bool, ...]:
    """Which of these staged tensors a call copies before its launch: at
    head_dim 8, each that is not `_wide` (the head_dim-8 kernels stage
    16-byte rows only); at any other head_dim none."""
    return tuple(z.shape[-1] == 8 and not _wide(z) for z in tensors)


def _staged(z: torch.Tensor, copy: bool) -> torch.Tensor:
    """z, or a contiguous copy in fresh storage (`contiguous()` would return
    a contiguous tensor that starts off 16 bytes as it is)."""
    return z.clone(memory_format=torch.contiguous_format) if copy else z


def _staged_strides(z: torch.Tensor, copy: bool) -> tuple:
    """The strides of `_staged(z, copy)`."""
    if not copy:
        return z.stride()
    b, h, t, d = z.shape
    return (h * t * d, t * d, d, 1)


# LAUNCHES and _PLANS change under this lock: the shards of a mesh run
# launch from one host thread per device
_LOCK = threading.Lock()


def _count(kernels: Tuple[str, ...]) -> None:
    """One launch of each named kernel variant: the only place LAUNCHES
    moves, called by a plan right after its launch."""
    with _LOCK:
        for name in kernels:
            LAUNCHES[name] += 1


# Checked launches, keyed by everything the checks read: shapes, strides,
# dtypes and devices of the tensors, the knobs, and whether the staged
# tensors start on 16 bytes (`_wide`). A call whose key is not here
# goes through every check first, so nothing launches on a layout that was
# not checked, and what the checks refuse raises as before.
_PLANS: dict = {}
_MAX_PLANS = 256


def _remember(key: tuple, plan):
    with _LOCK:
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    return plan


def _launch(fn, args: int, index: int, *pointers) -> None:
    """Call one `extern "C"` launcher with the address of its packed
    arguments on the current stream of device `index`, making that device
    current only when it is not."""
    if torch._C._cuda_getDevice() == index:
        err = fn(args, *pointers, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(args, *pointers, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


class _ForwardPlan:
    """One checked forward layout on CUDA: the kernel's packed arguments,
    which of k and v are copied before staging, and the LAUNCHES keys a
    launch counts under."""
    __slots__ = ("args", "address", "fn", "copy_k", "copy_v", "counts", "index", "lse_shape",
                 "empty")

    def __init__(self, q, k, v, fast_math: bool, group: int, with_lse: bool,
                 counts: Tuple[str, ...]):
        """`group` is G' (`block_group`), the heads one block runs."""
        self.counts, self.index = counts, q.device.index
        self.empty = q.numel() == 0
        b, h, t, d = q.shape
        self.lse_shape = (b, h, t) if with_lse else None
        self.copy_k, self.copy_v = _copies(k, v)
        strides = (q.stride(), _staged_strides(k, self.copy_k), _staged_strides(v, self.copy_v),
                   self.outputs(q)[0].stride())
        self.args = _FwdArgs((ctypes.c_int64 * 16)(*(s for st in strides for s in st)),
                             b, h, t, d, _DTYPE_CODES[q.dtype], group, int(bool(fast_math)),
                             1.0 / math.sqrt(d))
        self.address, self.fn = ctypes.addressof(self.args), _lib(KERNEL).attention_fwd

    def outputs(self, q):
        """(out, lse) as a launch fills them: out like q, lse f32 (B, H, T)
        contiguous where the plan asks for it, else None."""
        lse = None if self.lse_shape is None else q.new_empty(self.lse_shape, dtype=torch.float32)
        return torch.empty_like(q), lse

    def __call__(self, q, k, v):
        """(out, lse), lse each row's base-2 log-sum-exp; one launch, counted."""
        out, lse = self.outputs(q)
        if not self.empty:
            # the copies stay referenced until the launch is queued, so the
            # allocator cannot hand k's storage to v's copy
            k, v = _staged(k, self.copy_k), _staged(v, self.copy_v)
            _launch(self.fn, self.address, self.index, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr())
            _count(self.counts)
        return out, lse


def _forward_key(q, k, v, fast_math, heads_per_program, with_lse) -> tuple:
    return (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
            v.shape, v.stride(), v.dtype, v.device, not (k.data_ptr() | v.data_ptr()) % 16,
            fast_math, heads_per_program, with_lse)


def _forward_plan(q, k, v, fast_math, heads_per_program, with_lse):
    """The plan of a forward call the cache has not seen, after every check;
    None for CPU tensors."""
    device = _check(q, k, v)
    group = _group(q.shape[1], heads_per_program)
    if with_lse and (device != "cuda" or fast_math):
        raise ValueError("the log-sum-exp comes from the exact CUDA kernel only")
    if device == "cpu":
        return None
    wide = q.shape[-1] == 8 or _wide(k, v)
    group = group if wide else 1
    counts = ((FAST_KERNEL if fast_math else KERNEL,)
              + ((WGMMA_KERNEL,) if uses_wgmma(q.dtype, q.shape[-1]) else ())
              + ((WIDE_KERNEL,) if uses_wide(q.dtype, q.shape[-1]) else ())
              + ((GROUPED_KERNEL,) if group > 1 else ()))
    return _remember(_forward_key(q, k, v, fast_math, heads_per_program, with_lse),
                     _ForwardPlan(q, k, v, fast_math,
                                  block_group(group, q.shape[-1], q.dtype, wide), with_lse,
                                  counts))


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fast_math: bool = False, heads_per_program: int = 1,
             with_lse: bool = False):
    """The forward on the tensors' device, no gradient: the kernel on CUDA,
    the plain version on the CPU. `with_lse` (CUDA, exact maths) returns
    (out, lse) with each row's base-2 log-sum-exp."""
    plan = _PLANS.get(_forward_key(q, k, v, fast_math, heads_per_program, with_lse))
    if plan is None:
        plan = _forward_plan(q, k, v, fast_math, heads_per_program, with_lse)
        if plan is None:
            return (attention_fast_math_reference if fast_math else attention_reference)(q, k, v)
    out, lse = plan(q, k, v)
    return (out, lse) if with_lse else out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    fast_math: bool = False, heads_per_program: int = 1,
                    with_lse: bool = False):
    """softmax(q k^T / sqrt(D)) v over (B, H, T, D) tensors, in q's dtype
    (on CUDA with q's strides where q is dense). `fast_math` takes the
    exponentials in bf16 (bf16-level deviation from the exact result);
    `heads_per_program` groups heads per block (identical results).
    `with_lse` (CUDA, exact maths) returns (out, lse) with each row's f32
    base-2 log-sum-exp, the statistics `fused_attention_bwd` reads; the
    output is the same either way. The CUDA kernel has no gradient: under
    grad mode, CUDA inputs that require grad raise (use
    `fused_attention_trainable`)."""
    if ((q.requires_grad or k.requires_grad or v.requires_grad) and q.is_cuda
            and torch.is_grad_enabled()):
        raise RuntimeError("fused_attention has no gradient on CUDA; call "
                           "fused_attention_trainable for inputs that require grad")
    return _forward(q, k, v, fast_math, heads_per_program, with_lse)


class _BackwardPlan:
    """One checked backward layout on CUDA: the kernel's packed arguments,
    which of q, k, v, do are copied before staging, and the LAUNCHES keys a
    launch counts under. With `stats`, a call without o and lse, the exact
    forward plan that computes them first (counted under STATS_KERNEL)."""
    __slots__ = ("args", "address", "fn", "copies", "counts", "index", "stats", "empty")

    def __init__(self, q, k, v, do, o, group: int, wide: bool, stats):
        self.index, self.stats = q.device.index, stats
        self.counts = ((BWD_KERNEL,) + ((BWD_GROUPED_KERNEL,) if group > 1 else ())
                       + ((BWD_WIDE_KERNEL,) if uses_wide(q.dtype, q.shape[-1], False) else ()))
        self.empty = q.numel() == 0
        b, h, t, d = q.shape
        self.copies = _copies(q, k, v, do)
        strides = (*(_staged_strides(z, c) for z, c in zip((q, k, v, do), self.copies)),
                   *(torch.empty_like(z).stride() for z in (q, k, v)),
                   (q if o is None else o).stride())
        self.args = _BwdArgs((ctypes.c_int64 * 32)(*(s for st in strides for s in st)),
                             b, h, t, d, _DTYPE_CODES[q.dtype],
                             block_group(group, d, q.dtype, wide, forward=False),
                             1.0 / math.sqrt(d))
        self.address, self.fn = ctypes.addressof(self.args), _lib(BWD_KERNEL).attention_bwd

    def __call__(self, q, k, v, do, o, lse):
        """(dq, dk, dv); one launch of the two passes, counted (and the
        statistics launch first where the plan has one)."""
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        if self.empty:
            return dq, dk, dv
        b, h, t, _ = q.shape
        if self.stats is not None:
            o, lse = self.stats(q, k, v)
        if any(self.copies):
            q, k, v, do = (_staged(z, c) for z, c in zip((q, k, v, do), self.copies))
        # per query row: delta = do . o (f32 scratch)
        delta = q.new_empty((b, h, t), dtype=torch.float32)
        _launch(self.fn, self.address, self.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), o.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                lse.data_ptr(), delta.data_ptr())
        _count(self.counts)
        return dq, dk, dv


def _backward_plan(q, k, v, do, heads_per_program, o, lse):
    """The plan of a backward call the cache has not seen, after every
    check; None for CPU tensors."""
    device = _check(q, k, v, do)
    group = _group(q.shape[1], heads_per_program)
    if device == "cpu":
        return None
    wide = q.shape[-1] == 8 or _wide(q, k, v, do)
    group = group if wide else 1
    key = _backward_key(q, k, v, do, heads_per_program, o, lse)
    stats = None
    if q.numel():
        if o is None or lse is None:
            stats = _ForwardPlan(q, k, v, False, 1, True, (STATS_KERNEL,))
            o, lse = stats.outputs(q)   # laid out as the statistics launch fills them
        _check(q, o)
        b, h, t, _ = q.shape
        if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
            raise ValueError(f"lse must be a contiguous float32 {(b, h, t)} tensor, got "
                             f"{lse.dtype} {tuple(lse.shape)}")
    return _remember(key, _BackwardPlan(q, k, v, do, o, group, wide, stats))


def _backward_key(q, k, v, do, heads_per_program, o, lse) -> tuple:
    return (q.shape, q.stride(), q.dtype, q.device, k.shape, k.stride(), k.dtype, k.device,
            v.shape, v.stride(), v.dtype, v.device, do.shape, do.stride(), do.dtype, do.device,
            not (q.data_ptr() | k.data_ptr() | v.data_ptr() | do.data_ptr()) % 16,
            heads_per_program,
            None if o is None else (o.shape, o.stride(), o.dtype, o.device),
            None if lse is None else (lse.shape, lse.stride(), lse.dtype, lse.device))


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, heads_per_program: int = 1,
                        o: torch.Tensor = None, lse: torch.Tensor = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v for the output gradient
    `do`, in q's dtype, with the strides of q, k and v where they are dense.
    `heads_per_program` groups heads per block (identical results). One
    call launches the kernel's two passes and counts one launch.

    On CUDA (f32 and bf16) the kernels read the exact forward's output `o`
    and base-2 log-sum-exp `lse` (f32, (B, H, T)), as `FusedAttention` saves
    them; without them one exact forward launch (counted under
    STATS_KERNEL) computes both first."""
    plan = _PLANS.get(_backward_key(q, k, v, do, heads_per_program, o, lse))
    if plan is None:
        plan = _backward_plan(q, k, v, do, heads_per_program, o, lse)
        if plan is None:
            return attention_bwd_reference(q, k, v, do)
    return plan(q, k, v, do, o, lse)


class FusedAttention(torch.autograd.Function):
    """The Pallas `fused_attention_trainable` custom VJP: the forward kernel
    as the primal, the recompute backward kernel as the VJP. Saves q, k, v
    (views of the projections, no copy) and, where the backward reads them
    (CUDA, exact maths), the output and each row's f32 log-sum-exp
    (B*H*T*4 bytes); nothing of size T^2."""

    @staticmethod
    def forward(ctx, q, k, v, fast_math=False, heads_per_program=1):
        ctx.heads_per_program = heads_per_program
        if q.is_cuda and not fast_math:
            out, lse = _forward(q, k, v, False, heads_per_program, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, fast_math, heads_per_program)

    @staticmethod
    def backward(ctx, do):
        q, k, v, *stats = ctx.saved_tensors
        saved = dict(zip(("o", "lse"), stats))
        do = do if do.dtype == q.dtype else do.to(q.dtype)
        return (*fused_attention_bwd(q, k, v, do, ctx.heads_per_program, **saved), None, None)


def fused_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              fast_math: bool = False,
                              heads_per_program: int = 1) -> torch.Tensor:
    """`fused_attention` with a gradient: the same primal, and a backward
    that is the recompute kernel (the exact derivative of the f32-softmax
    forward, up to rounding). With `fast_math` the primal takes bf16
    exponentials while the backward keeps the f32-softmax derivative, as
    the Pallas custom VJP does; `heads_per_program` groups the heads of
    both kernels (identical results)."""
    return FusedAttention.apply(q, k, v, fast_math, heads_per_program)
