"""Tensor parallelism: a UNet whose weights are channel-sharded over a row
of devices.

What GSPMD does for the JAX package when `ShardedSampler` places the UNet
weights by `tp_param_shardings` over a mesh's 'model' axis
(`synt_isic_tpu/parallel/sharded_sampler.py`), written out for eager
PyTorch, as `replicas.py` does for data parallelism:

  * `tp_replica(model, row_devices)` builds from a `UNet2D` (per-class or
    conditional, any dtype) a copy whose sharded weights (`mesh.
    tp_shard_dims`: the output features of every conv, linear and class
    embedding whose width the row's size T divides) are held as T
    contiguous slices, slice i on device i of the row. It is built once per
    (model, row) and shared while the model lives, as `sampling_replica` is;
  * activations live on the row's first device. A sharded layer
    (`ShardedLayer`) copies its input to each distinct device of the row
    (a repeated device needs no copy), each device computes its output
    slice with the full contraction (no partial sums, JAX's output-channel
    rule), and the slices are concatenated on the first device in row
    order. GroupNorm, SiLU, the residual adds, the timestep features and
    the replicated layers (biases and norms ride with their layers;
    `conv_out`'s 3 channels) run on the first device;
  * attention is sharded by heads (`TPAttentionBlock`): the slices of
    `to_q`/`to_k`/`to_v` are contiguous channel ranges, that is contiguous
    heads, so each device runs the attention core (K1, or the trainable
    pair under grad) on its own H/T heads with the block's `fast_math` and
    `heads_per_program`, and the heads are gathered before the sharded
    `to_out`. Where heads_per_program G does not divide H/T (or T does not
    divide H), the block gathers q, k and v and runs the core on the first
    device over all heads, which is what JAX's replicated Pallas call
    computes. `ROUTES` counts each block call by route.

One host thread drives a row: work on different cards is queued in turn
and overlaps on the devices. A copy to a card is `non_blocking` and follows
stream order. A copy to the host blocks until the data has landed, because
the host reads it at once: a CPU shard's layer reads its input, and a row
whose first device is the CPU concatenates the slices there. A row mixes kinds freely: the attention cores take the
kernels wherever a replica on one of the row's devices would (`unet_copy`),
so a shard on a card launches K1 and a shard on the CPU runs its plain
version. There is no NCCL and no CPU fallback: on CUDA devices the kernels
launch or raise.
"""
from __future__ import annotations

import copy
import threading
import weakref
from typing import Dict, List, Sequence

import torch
import torch.nn as nn

from ..models.unet2d import AttentionBlock, Conv2d, Embedding, Linear
from .mesh import canonical, tp_shard_dims
from .replicas import module_device, unet_copy

HEADS = "heads"     # each device runs the core on its own heads
FIRST = "first"     # q, k, v gathered; the core over all heads on the first device
# attention block calls of the tensor-parallel replicas, by route
ROUTES = {HEADS: 0, FIRST: 0}
_LOCK = threading.Lock()


def _count(route: str) -> None:
    with _LOCK:
        ROUTES[route] += 1


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`. A copy to a card is queued in stream order
    (`non_blocking`); a copy to the host blocks until the data has landed,
    since the host reads it at once and a `non_blocking` one lands in pinned
    memory after the call returns."""
    return x.to(device, non_blocking=device.type == "cuda")


def _spread(x: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x on each device of `devices` (x itself on the first), one copy per
    distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {devices[0]: x}
    for d in devices[1:]:
        if d not in copies:
            copies[d] = _to(x, d)
    return [copies[d] for d in devices]


def _gather(parts: Sequence[torch.Tensor], first: torch.device, dim: int) -> torch.Tensor:
    """The slices concatenated along `dim` on `first`, in row order."""
    return torch.cat([p if p.device == first else _to(p, first) for p in parts], dim=dim)


def _slice_module(module: nn.Module, dim: int, start: int, size: int,
                  device: torch.device) -> nn.Module:
    """A copy of a conv, linear or embedding layer holding the output
    features [start, start + size) of its weight's `dim` (and its bias's),
    on `device`."""
    part = copy.deepcopy(module)
    for name in ("weight", "bias"):
        p = getattr(module, name, None)
        if p is None:
            continue
        d = dim if name == "weight" else 0
        piece = p.detach().narrow(d, start, size).contiguous().clone()
        setattr(part, name, nn.Parameter(piece, requires_grad=p.requires_grad))
    if isinstance(module, nn.Conv2d):
        part.out_channels = size
    elif isinstance(module, nn.Linear):
        part.out_features = size
    else:
        part.embedding_dim = size
    return part.to(device)


class ShardedLayer(nn.Module):
    """A conv, linear or embedding layer whose output features are split
    into contiguous slices, slice i on `devices[i]`. Its input (on the first
    device) goes to each device, each computes its slice with the full
    contraction, and the output is the slices concatenated on the first
    device: the channel dim of a conv's NCHW output, the last dim of a
    linear's or an embedding's."""

    def __init__(self, module: nn.Module, devices: Sequence[torch.device], dim: int):
        super().__init__()
        self.devices = list(devices)
        size = module.weight.shape[dim] // len(self.devices)
        self.parts = nn.ModuleList([_slice_module(module, dim, i * size, size, d)
                                    for i, d in enumerate(self.devices)])
        self.out_dim = 1 if isinstance(module, nn.Conv2d) else -1

    def shard_outputs(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Each device's output slice, on its device."""
        return [part(xi) for part, xi in zip(self.parts, _spread(x, self.devices))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _gather(self.shard_outputs(x), self.devices[0], self.out_dim)


class TPAttentionBlock(AttentionBlock):
    """An `AttentionBlock` whose projections are `ShardedLayer`s over a row
    (`devices`), its core sharded by heads (`route` HEADS) or run over all
    heads on the first device (`route` FIRST)."""
    devices: List[torch.device]
    route: str

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _count(self.route)
        if self.route == FIRST:
            # the sharded projections gather q, k and v on the first device
            return super().forward(x)
        b, c, h, w = x.shape
        y = self.tokens(x)
        qs, ks, vs = (layer.shard_outputs(y) for layer in (self.to_q, self.to_k, self.to_v))
        out = _gather([self.merge(self.attend(self.heads(q), self.heads(k), self.heads(v)))
                       for q, k, v in zip(qs, ks, vs)], self.devices[0], -1)
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


def attention_route(channels: int, head_dim: int, tp: int, heads_per_program: int) -> str:
    """HEADS when the row's T devices can each run the core on H/T whole
    heads in groups of G = heads_per_program, else FIRST."""
    heads = channels // head_dim
    per = heads // tp if heads % tp == 0 else 0
    return HEADS if per and per % max(int(heads_per_program), 1) == 0 else FIRST


def _shard(module: nn.Module, name: str, dims: Dict[str, int],
           devices: List[torch.device]) -> nn.Module:
    """`module` as a `ShardedLayer` when its weight is sharded, else
    itself."""
    dim = dims[f"{name}.weight"]
    return module if dim is None else ShardedLayer(module, devices, dim)


def _fused_on_row(model, row: List[torch.device]) -> bool:
    """Whether the row's attention cores take the kernels: where a replica
    on any device of the row would (`unet_copy`'s switch: the model's own on
    a device of its kind, else on for a card). The wrapper then launches K1
    for a shard on a card and runs the plain version for one on the CPU."""
    kind = module_device(model).type
    return any(model.use_fused_attention if d.type == kind else d.type == "cuda"
               for d in row)


def _build(model, row: List[torch.device]):
    tp = len(row)
    base = unet_copy(model, row[0])
    fused = _fused_on_row(model, row)
    dims = tp_shard_dims(base, tp)
    blocks = [name for name, m in base.named_modules() if isinstance(m, AttentionBlock)]
    for name, module in list(base.named_modules()):
        if isinstance(module, AttentionBlock):
            # the block becomes the head-sharded one in place (`base` is a
            # fresh copy); its projections are sharded here, not below
            route = attention_route(module.to_q.in_features, module.head_dim, tp,
                                    module.fused_heads_per_program)
            module.__class__ = TPAttentionBlock
            module.use_fused = fused
            for proj in ("to_q", "to_k", "to_v"):
                setattr(module, proj, _shard(getattr(module, proj), f"{name}.{proj}",
                                             dims, row))
            module.to_out[0] = _shard(module.to_out[0], f"{name}.to_out.0", dims, row)
            module.devices = row
            module.route = route if isinstance(module.to_q, ShardedLayer) else FIRST
        elif isinstance(module, (Conv2d, Linear, Embedding)) and not any(
                name.startswith(b + ".") for b in blocks):
            parent, _, child = name.rpartition(".")
            setattr(base.get_submodule(parent), child, _shard(module, name, dims, row))
    return base


# tensor-parallel replicas, kept while their model lives: {model: {row: replica}}
_TP_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_BUILD_LOCK = threading.Lock()


def tp_replica(model, row_devices: Sequence[torch.device]):
    """The tensor-parallel copy of a sampling `UNet2D` over `row_devices`
    (a mesh row: the 'model' devices of one 'data' shard), built on first
    use and shared while `model` lives. Its activations live on the row's
    first device."""
    row = [canonical(d) for d in row_devices]
    with _BUILD_LOCK:
        per_row = _TP_REPLICAS.setdefault(model, {})
        if tuple(row) not in per_row:
            per_row[tuple(row)] = _build(model, row)
        return per_row[tuple(row)]
