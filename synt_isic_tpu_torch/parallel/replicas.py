"""Module replicas on a mesh's devices, and the per-device work loop.

What XLA does for the JAX package when a jitted function takes replicated
parameters and a batch sharded over a mesh (`synt_isic_tpu/parallel/
mesh.py`, `sharded_sampler.py`; the gradient psum of `train/train_ddpm.py`
`train_class(mesh=)`), written out for eager PyTorch:

  * `replica(module, device)` copies a module to another device from its
    state dict; a `UNet2D` is rebuilt with that device's kernel switches
    (the attention kernel and the f32-statistics GroupNorm on CUDA, the
    plain versions elsewhere), a `LesionClassifier` around a copy of its
    network. The primary's own device keeps the primary itself;
  * `run_per_device(devices, work)` runs `work(i)` for every shard i, one
    host thread per distinct device (under `torch.cuda.device`), the shards
    of one device in order in its thread, and returns the results in shard
    order. One distinct device runs in the calling thread;
  * `Replicas` keeps one replica per distinct device for training: the
    shards' backward passes accumulate into their replica's gradients,
    `reduce_gradients` sums them into the primary's (then `all_reduce`s
    them over the process group when one exists), and `broadcast` copies
    the primary's updated weights back into every replica.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .mesh import Mesh, canonical


def module_device(module) -> torch.device:
    """The device a module (or a `LesionClassifier`) lives on."""
    if hasattr(module, "device") and not isinstance(module, torch.nn.Module):
        return canonical(module.device)
    return canonical(next(module.parameters()).device)


def replica(module, device: torch.device):
    """A copy of `module` on `device`, built from its state dict with that
    device's kernel switches; `module` itself when it already lives there."""
    device = canonical(device)
    if module_device(module) == device:
        return module
    from ..models.classifier import LesionClassifier
    from ..models.unet2d import UNet2D

    if isinstance(module, LesionClassifier):
        net = copy.deepcopy(module.model).to(device)
        return LesionClassifier(net, device=device)
    if isinstance(module, UNet2D):
        return unet_copy(module, device)
    return copy.deepcopy(module).to(device)


def unet_copy(module, device: torch.device):
    """A new `UNet2D` on `device` with `module`'s config, dtypes, weights
    and gradient flags, and that device's kernel switches: the module's
    own on a device of its kind, else the attention kernel and (below f32)
    the f32-statistics GroupNorm on CUDA, the plain versions elsewhere."""
    from ..models.unet2d import UNet2D

    device = canonical(device)
    on_cuda = device.type == "cuda"
    same_kind = module_device(module).type == device.type
    copy_ = UNet2D(module.config, dtype=module.dtype, param_dtype=module.param_dtype,
                   use_fused_attention=(module.use_fused_attention if same_kind
                                        else on_cuda),
                   fast_norm=(module.fast_norm if same_kind
                              else on_cuda and module.dtype != torch.float32),
                   fused_heads_per_program=module.fused_heads_per_program,
                   fused_fast_math=module.fused_fast_math, remat=module.remat)
    copy_.load_state_dict(module.state_dict(), strict=True)
    copy_ = copy_.to(device).train(module.training)
    for src, dst in zip(module.parameters(), copy_.parameters()):
        dst.requires_grad_(src.requires_grad)
    return copy_


# sampling replicas, kept while their primary lives: {primary: {device: replica}}
_SAMPLING_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_SAMPLING_LOCK = threading.Lock()


def sampling_replica(module, device: torch.device):
    """The replica of a read-only module (a sampling UNet, a classifier) on
    `device`, built on first use and shared by every later caller while the
    module lives. Repeated devices share one."""
    device = canonical(device)
    if module_device(module) == device:
        return module
    with _SAMPLING_LOCK:
        per_device = _SAMPLING_REPLICAS.setdefault(module, {})
        if device not in per_device:
            per_device[device] = replica(module, device)
        return per_device[device]


def run_per_device(devices: Sequence[torch.device], work: Callable[[int], Any]) -> List[Any]:
    """`work(i)` for every shard i on `devices[i]`: one thread per distinct
    device, each under that device, shards of a device in order; results in
    shard order. An exception in any shard is raised here."""
    devices = [canonical(d) for d in devices]
    distinct = list(dict.fromkeys(devices))
    results: List[Any] = [None] * len(devices)

    def run_device(dev: torch.device) -> None:
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:
            for i, d in enumerate(devices):
                if d == dev:
                    results[i] = work(i)

    if len(distinct) == 1:
        run_device(distinct[0])
        return results
    with ThreadPoolExecutor(max_workers=len(distinct)) as pool:
        for f in [pool.submit(run_device, d) for d in distinct]:
            f.result()
    return results


def process_group_active() -> bool:
    """A `torch.distributed` process group is initialised (world size 1
    included: its collectives still run)."""
    return torch.distributed.is_available() and torch.distributed.is_initialized()


class Replicas:
    """A training module's replicas over a mesh's 'data' axis: the primary
    on its own device, one copy per other distinct device of the mesh."""

    def __init__(self, module: torch.nn.Module, mesh: Mesh, axis: str = "data"):
        self.primary = module
        self.mesh = mesh
        self.devices = mesh.shard_devices(axis)
        self.models: Dict[torch.device, torch.nn.Module] = {
            d: replica(module, d) for d in dict.fromkeys(self.devices)}
        self.models.setdefault(module_device(module), module)

    def __getitem__(self, device: torch.device) -> torch.nn.Module:
        return self.models[canonical(device)]

    def others(self) -> List[torch.nn.Module]:
        return [m for m in self.models.values() if m is not self.primary]

    def zero_grad(self) -> None:
        for m in self.models.values():
            for p in m.parameters():
                p.grad = None

    def reduce_gradients(self, extra: Optional[torch.Tensor] = None
                         ) -> Optional[torch.Tensor]:
        """Sum every replica's gradients into the primary's, then, when a
        process group exists, `all_reduce` (sum) them across processes in
        one flat buffer, with `extra` (e.g. the loss) appended. Returns the
        reduced `extra`."""
        params = [p for p in self.primary.parameters() if p.requires_grad]
        for other in self.others():
            for p, q in zip(self.primary.parameters(), other.parameters()):
                if q.grad is None:
                    continue
                g = q.grad.to(p.device)
                p.grad = g if p.grad is None else p.grad.add_(g)
        if not process_group_active():
            return extra
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        parts = [g.reshape(-1).float() for g in grads]
        if extra is not None:
            parts.append(extra.detach().reshape(-1).float().to(parts[0].device))
        flat = torch.cat(parts)
        torch.distributed.all_reduce(flat)
        offset = 0
        for p, g in zip(params, grads):
            n = g.numel()
            p.grad = flat[offset:offset + n].view_as(g).to(g.dtype)
            offset += n
        return flat[offset].reshape(()) if extra is not None else None

    @torch.no_grad()
    def broadcast(self) -> None:
        """Copy the primary's weights (and buffers) into every replica."""
        if not self.others():
            return
        src = self.primary.state_dict()
        for other in self.others():
            for name, t in other.state_dict().items():
                t.copy_(src[name])
