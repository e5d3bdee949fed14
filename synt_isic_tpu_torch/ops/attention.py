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
    Function `FusedAttention`: forward kernel, backward kernel. In bf16 at
    head_dim 8 its exact forward also writes each row's base-2 log-sum-exp,
    and it saves that and its output for the backward's tensor-core kernels.
For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain PyTorch version (`attention_reference`,
`attention_fast_math_reference`, `attention_bwd_reference`), which the
tests and `chip_smoke.py` hold the kernels against; the fast-math kernel is
also held to `attention_fast_math_kernel_order` and the bf16 backward to
`attention_bwd_kernel_order`, the same maths rounded where the kernel
rounds, and the forward's log-sum-exp to `attention_lse_reference`. There
is no other route.

`heads_per_program` = G runs G heads per block with bit-identical maths,
in the forward and the backward alike; as in the JAX package, a G that does
not divide the head count means G = 1. The kernels take G in (1, 2, 4, 8).
On a CPU tensor G has no effect.

q, k, v (and do) are (B, H, T, D) tensors of any strides, so a view of a
(B, T, C) projection output (`z.view(B, T, H, D).transpose(1, 2)`) goes in
without a copy, and every result keeps q's strides (dk and dv those of k
and v), so it reshapes back to (B, T, C) for free.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import native

KERNEL = "attention_fwd"
BWD_KERNEL = "attention_bwd"
# counters of the forward kernel's variants (one source, `attention_fwd.cu`)
FAST_KERNEL = "attention_fwd_fast_math"
GROUPED_KERNEL = "attention_fwd_grouped"
# counter of the backward kernel's grouped variant (one source, `attention_bwd.cu`)
BWD_GROUPED_KERNEL = "attention_bwd_grouped"
# counter of the exact forward launches that a bf16 backward without saved
# statistics runs first for its o and log-sum-exp (`attention_fwd.cu`)
STATS_KERNEL = "attention_bwd_stats"
HEAD_DIMS = (4, 8)
HEADS_PER_PROGRAM = (1, 2, 4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each hand-written kernel, counted where the wrapper launches it
# and nowhere else, so a run can show that its main path went through them.
# A forward launch counts under KERNEL (exact softmax) or FAST_KERNEL
# (fast_math), and under GROUPED_KERNEL too when it runs G > 1 heads per
# block. A backward launch counts under BWD_KERNEL, and under
# BWD_GROUPED_KERNEL too when it runs G > 1 heads per block. The forward
# launch that gives such a backward its statistics counts under STATS_KERNEL
# only.
LAUNCHES = {KERNEL: 0, FAST_KERNEL: 0, GROUPED_KERNEL: 0, BWD_KERNEL: 0,
            BWD_GROUPED_KERNEL: 0, STATS_KERNEL: 0}
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
    tensors like q: a staged tile of 64 on the tensor-core kernel (bf16,
    head_dim 8), pairs on the CUDA-core kernel (every other case)."""
    return 64 if q.dtype == torch.bfloat16 and q.shape[-1] == 8 else 2


def attention_fast_math_kernel_order(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     step: int) -> torch.Tensor:
    """The CUDA kernels' fast-math rounding in plain PyTorch, to hold a
    kernel to a limit that exact attention does not meet. Where the Pallas
    branch (`attention_fast_math_reference`) rounds the natural-log logit
    minus the row's max, the kernels round the base-2 logit (log2(e) folded
    into the scale, in f32) minus the running max, which moves once per
    group of `step` keys (`fast_math_step`: 2 on the CUDA-core kernel, 64 on
    the tensor-core one; groups start at key 0, the last may be short), and
    take `exp2` of that bf16 value in bf16. Here, as there, the weights are
    brought onto the row's max in f32, summed and multiplied into v in f32,
    and the division comes last; the result is in q's dtype."""
    t = q.shape[-2]
    logits = torch.matmul(q.float() * _scale_log2(q.shape[-1]), k.float().transpose(-1, -2))
    groups = torch.nn.functional.pad(logits, (0, -t % step), value=-math.inf)
    group_max = groups.unflatten(-1, (-1, step)).amax(dim=-1)
    run_max = group_max.cummax(dim=-1).values.repeat_interleave(step, dim=-1)[..., :t]
    exp = torch.exp2((logits - run_max).to(torch.bfloat16)).float()
    weights = exp * torch.exp2(run_max - run_max[..., -1:])
    pv = torch.matmul(weights, v.float())
    return (pv / weights.sum(dim=-1, keepdim=True)).to(q.dtype)


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
        if q.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"kernel takes head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    return q.device.type


@functools.cache
def _lib(name: str) -> ctypes.CDLL:
    lib = native.load(name)
    if name == KERNEL:
        lib.attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.attention_fwd.restype = ctypes.c_int
    else:
        lib.attention_bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        lib.attention_bwd.restype = ctypes.c_int
    return lib


def _strides(*tensors: torch.Tensor):
    return (ctypes.c_int64 * (4 * len(tensors)))(
        *(s for z in tensors for s in z.stride()))


def _group(heads: int, heads_per_program: int, device: str) -> int:
    """G as the Pallas wrapper takes it: a G that does not divide the head
    count means 1. On CUDA, a G the kernels do not take raises."""
    g = int(heads_per_program)
    if g < 1:
        raise ValueError(f"heads_per_program must be >= 1, got {g}")
    g = g if heads % g == 0 else 1
    if device == "cuda" and g not in HEADS_PER_PROGRAM:
        raise ValueError(f"kernel takes heads_per_program in {HEADS_PER_PROGRAM}, "
                         f"got {g}")
    return g


def _tensor_cores(q: torch.Tensor) -> bool:
    """Whether these CUDA tensors go to the tensor-core kernels: the
    forward, and the backward, which reads the forward's output and
    log-sum-exp."""
    return q.device.type == "cuda" and q.dtype == torch.bfloat16 and q.shape[-1] == 8


def _rows16(z: torch.Tensor) -> torch.Tensor:
    """z itself where each (b, h, t) row starts on 16 bytes with its channels
    contiguous, as the tensor-core kernels stage k and v (and, in the
    backward, q and do), else a contiguous copy in fresh storage (only for
    unusual layouts: the UNet's views and dense tensors pass; `contiguous()`
    would return a contiguous tensor that starts off 16 bytes as it is)."""
    aligned = (z.stride(-1) == 1 and all(st % 8 == 0 for st in z.stride()[:3])
               and z.data_ptr() % 16 == 0)
    return z if aligned else z.clone(memory_format=torch.contiguous_format)


def _launch_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, fast_math: bool,
                    group: int, with_lse: bool):
    """One forward kernel launch on CUDA tensors, counted by the caller:
    (out, lse), lse the f32 (B, H, T) base-2 log-sum-exp when asked for
    (exact maths only), else None. out takes q's strides where q is dense."""
    out = torch.empty_like(q)
    if _tensor_cores(q):
        k, v = _rows16(k), _rows16(v)
    b, h, t, d = q.shape
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        err = _lib(KERNEL).attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, t, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, out), 1.0 / math.sqrt(d), group, int(bool(fast_math)),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError {err}")
    return out, lse


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fast_math: bool = False, heads_per_program: int = 1,
             with_lse: bool = False):
    """The forward on the tensors' device, no gradient: the kernel on CUDA,
    the plain version on the CPU. `with_lse` (CUDA, exact maths) returns
    (out, lse) with each row's base-2 log-sum-exp."""
    device = _check(q, k, v)
    group = _group(q.shape[1], heads_per_program, device)
    if with_lse and (device != "cuda" or fast_math):
        raise ValueError("the log-sum-exp comes from the exact CUDA kernel only")
    if device == "cpu":
        return (attention_fast_math_reference if fast_math else attention_reference)(q, k, v)
    if q.numel() == 0:
        out = torch.empty_like(q)
        return (out, torch.empty(q.shape[:3], device=q.device)) if with_lse else out
    out, lse = _launch_forward(q, k, v, fast_math, group, with_lse)
    LAUNCHES[FAST_KERNEL if fast_math else KERNEL] += 1
    if group > 1:
        LAUNCHES[GROUPED_KERNEL] += 1
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
    if (q.device.type == "cuda" and torch.is_grad_enabled()
            and any(z.requires_grad for z in (q, k, v))):
        raise RuntimeError("fused_attention has no gradient on CUDA; call "
                           "fused_attention_trainable for inputs that require grad")
    return _forward(q, k, v, fast_math, heads_per_program, with_lse)


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, heads_per_program: int = 1,
                        o: torch.Tensor = None, lse: torch.Tensor = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q k^T / sqrt(D)) v for the output gradient
    `do`, in q's dtype, with the strides of q, k and v where they are dense.
    `heads_per_program` groups heads per block (identical results). One
    call launches the kernel's two passes and counts one launch.

    On CUDA in bf16 at head_dim 8 the kernels read the exact forward's
    output `o` and base-2 log-sum-exp `lse` (f32, (B, H, T)), as
    `FusedAttention` saves them; without them one exact forward launch
    (counted under STATS_KERNEL) computes both first. Elsewhere they are
    not used."""
    device = _check(q, k, v, do)
    group = _group(q.shape[1], heads_per_program, device)
    if device == "cpu":
        return attention_bwd_reference(q, k, v, do)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    b, h, t, d = q.shape
    if _tensor_cores(q):
        if o is None or lse is None:
            o, lse = _launch_forward(q, k, v, False, 1, True)
            LAUNCHES[STATS_KERNEL] += 1
        _check(q, o)
        if lse.shape != (b, h, t) or lse.dtype != torch.float32 or not lse.is_contiguous():
            raise ValueError(f"lse must be a contiguous float32 {(b, h, t)} tensor, got "
                             f"{lse.dtype} {tuple(lse.shape)}")
        q, k, v, do = (_rows16(z) for z in (q, k, v, do))
    else:
        # the row's base-2 log-sum-exp, computed by the first launch (f32 scratch)
        o, lse = q, torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    # per query row: delta = do . o (f32 scratch)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _lib(BWD_KERNEL).attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), b, h, t, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, do, dq, dk, dv, o), 1.0 / math.sqrt(d), group,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError {err}")
    LAUNCHES[BWD_KERNEL] += 1
    if group > 1:
        LAUNCHES[BWD_GROUPED_KERNEL] += 1
    return dq, dk, dv


class FusedAttention(torch.autograd.Function):
    """The Pallas `fused_attention_trainable` custom VJP: the forward kernel
    as the primal, the recompute backward kernel as the VJP. Saves q, k, v
    (views of the projections, no copy) and, where the backward reads them
    (CUDA, bf16, head_dim 8, exact maths), the output and each row's f32
    log-sum-exp (B*H*T*4 bytes); nothing of size T^2."""

    @staticmethod
    def forward(ctx, q, k, v, fast_math=False, heads_per_program=1):
        ctx.heads_per_program = heads_per_program
        if _tensor_cores(q) and not fast_math:
            out, lse = _forward(q, k, v, False, heads_per_program, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, fast_math, heads_per_program)

    @staticmethod
    def backward(ctx, do):
        q, k, v, *stats = ctx.saved_tensors
        saved = dict(zip(("o", "lse"), stats))
        return (*fused_attention_bwd(q, k, v, do.to(q.dtype), ctx.heads_per_program, **saved),
                None, None)


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
