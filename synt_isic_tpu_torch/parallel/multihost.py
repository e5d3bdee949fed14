"""The multi-process tier: the same mesh story across processes.

The port of `synt_isic_tpu/parallel/multihost.py`, over
`torch.distributed` instead of `jax.distributed`:

  * `initialize()` joins this process into a process group from torchrun's
    variables (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
    `MASTER_PORT`), with `nccl` for CUDA devices and `gloo` on the CPU; with
    none of them set it is a no-op that returns False, so single-process
    entry points call it unconditionally. A CUDA process owns
    `cuda:LOCAL_RANK` (and, with fewer processes than cards on its host,
    every card whose index is LOCAL_RANK modulo the local process count);
  * `hybrid_mesh()` builds the process's part of a mesh whose 'data' axis
    spans the processes, the local axes staying inside the process;
  * each process loads only its rows of a global batch
    (`local_batch_bounds`), the rows are split over its local devices
    (`global_batch_array`), gradients are summed with `all_reduce`
    (`replicas.Replicas`), and host-side writes go through process 0
    (`host0_only`).

Every function is a no-op in a single process. NCCL refuses two ranks on
one card, so a one-card host runs this tier at world size 1; more ranks
run on the CPU under `gloo`.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, canonical, create_mesh, replicated_sharding, shard_batch

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _active() else 0


def _world() -> int:
    return dist.get_world_size() if _active() else 1


def process_count() -> int:
    return _world()


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: Optional[str] = None) -> bool:
    """Join a process group. Arguments fall back to torchrun's variables;
    with none set anywhere this is a no-op returning False. `device`
    ("cuda", the default, or "cpu") picks the backend; CUDA that is missing
    raises. An already initialised group returns True."""
    if _active():
        return True
    if init_method is None and not any(k in os.environ for k in _ENV):
        return False
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "29500")
        init_method = f"tcp://{addr}:{port}"
    if torch.device(device or "cuda").type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def is_multihost() -> bool:
    return process_count() > 1


def local_devices(device: Optional[str] = None) -> List[torch.device]:
    """This process's devices: on CUDA (the default; raises when there is
    none) the cards whose index is LOCAL_RANK modulo the local process count
    (every card for one process per host); with device='cpu' the one CPU
    device."""
    kind = torch.device(device or "cuda")
    if kind.type != "cuda":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_count = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())
            if i % local_count == local_rank % local_count]


def hybrid_mesh(ici_axes: Optional[Dict[str, int]] = None,
                dcn_axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """This process's part of a mesh whose `dcn_axes` span the processes
    and whose `ici_axes` stay inside the process. The default is pure data
    parallelism: 'data' over the processes times every local device. A name
    in both tiers is one flat axis (processes outer, local devices inner),
    so `mesh.shape['data']` is the global data-parallel size. Only 'data'
    may cross processes. `devices` replaces `local_devices()`, whose CUDA
    cards are the default (the CPU only when passed, as the CPU tests'
    repeated CPU device)."""
    n_proc = process_count()
    devices = [canonical(d) for d in (devices if devices is not None else local_devices())]
    n_local = len(devices)
    dcn_axes = dict(dcn_axes or {"data": n_proc})
    ici_axes = dict(ici_axes or {"data": -1})
    if set(dcn_axes) - {"data"}:
        raise ValueError(f"only the 'data' axis may cross processes, got {dcn_axes}")
    if int(np.prod(list(dcn_axes.values()))) != n_proc:
        raise ValueError(f"dcn_axes {dcn_axes} must multiply to process_count={n_proc}")
    fixed = int(np.prod([s for s in ici_axes.values() if s != -1]))
    free = [n for n, s in ici_axes.items() if s == -1]
    if len(free) > 1:
        raise ValueError("at most one ICI axis may be -1")
    if free:
        if n_local % fixed:
            raise ValueError(f"ICI axes {ici_axes} do not divide {n_local} local devices")
        ici_axes[free[0]] = n_local // fixed
    if int(np.prod(list(ici_axes.values()))) != n_local:
        raise ValueError(f"ici_axes {ici_axes} must multiply to local_device_count={n_local}")
    # 'data' first, so that it is the axis the processes multiply
    names = ["data"] + [n for n in ici_axes if n != "data"]
    local = create_mesh({n: ici_axes.get(n, 1) for n in names}, devices)
    return Mesh(local.devices, local.axis_names, processes=n_proc)


def local_batch_bounds(global_batch: int, process_id: Optional[int] = None,
                       process_count: Optional[int] = None) -> Tuple[int, int]:
    """[start, stop) of the global batch this process loads. The global
    batch must divide by the process count."""
    pid = process_index() if process_id is None else process_id
    n_proc = _world() if process_count is None else process_count
    if global_batch % n_proc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n_proc} processes")
    per = global_batch // n_proc
    return pid * per, (pid + 1) * per


def global_batch_array(local_data, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """This process's slice of a global batch (from `local_batch_bounds`)
    split over its local devices: the shards it holds, in mesh order."""
    return shard_batch(local_data, mesh, axis)


def replicated_global(tree: Any, mesh: Mesh) -> Dict[torch.device, Any]:
    """A host pytree of tensors on every distinct local device of the mesh.
    Every process must hold the same values (`broadcast_from_host0`
    first if not)."""
    from torch.utils._pytree import tree_map

    return {d: tree_map(lambda x: torch.as_tensor(x).to(d), tree)
            for d in replicated_sharding(mesh)}


def _collective_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_from_host0(tree: Any) -> Any:
    """Process 0's pytree on every process (loaded weights, drawn seeds):
    tensors by `broadcast`, other leaves by `broadcast_object_list`. No-op
    in a single process."""
    if not is_multihost():
        return tree
    from torch.utils._pytree import tree_flatten, tree_unflatten

    leaves, spec = tree_flatten(tree)
    dev = _collective_device()
    out = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            buf = leaf.detach().to(dev).contiguous()
            dist.broadcast(buf, src=0)
            out.append(buf.to(leaf.device))
        else:
            box = [leaf]
            dist.broadcast_object_list(box, src=0)
            out.append(box[0])
    return tree_unflatten(out, spec)


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across processes (checkpoint ordering, bench fences)."""
    if is_multihost():
        dist.barrier()


def host0_only(fn, *args, **kwargs):
    """Run a host-side side effect (checkpoint, CSV, artifact writes) on
    process 0 only, then wait for it on every process. If `fn` raises on
    process 0, the failure is broadcast (the broadcast is the barrier) and
    every process raises, instead of going on without the artifact."""
    result = None
    err: Optional[BaseException] = None
    if process_index() == 0:
        try:
            result = fn(*args, **kwargs)
        except Exception as exc:  # re-raised below, after the broadcast
            err = exc
    if is_multihost():
        box = [err is not None]
        dist.broadcast_object_list(box, src=0)
        if box[0] and err is None:
            raise RuntimeError("host0_only: process 0 raised during the side effect")
    if err is not None:
        raise err
    return result


def gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every process's `x` concatenated along `dim` in process order (equal
    shapes on every process). `x` itself in a single process."""
    if not is_multihost():
        return x
    dev = _collective_device()
    local = x.detach().to(dev).contiguous()
    parts = [torch.empty_like(local) for _ in range(process_count())]
    dist.all_gather(parts, local)
    return torch.cat(parts, dim=dim).to(x.device)
