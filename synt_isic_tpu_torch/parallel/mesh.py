"""Device meshes and the batch split over them.

The port of `synt_isic_tpu/parallel/mesh.py`. The JAX package's mesh is a
`jax.sharding.Mesh` and XLA partitions one program over it; here a `Mesh`
is a small record of which device holds which shard, and the port's
callers run one walk (or one forward and backward) per shard on its device
(`sharded_sampler.py`, `replicas.py`). It is not
`torch.distributed.DeviceMesh`, which needs a process group: a mesh here
lives in one process, and the processes of a multi-process run each hold
their own local mesh (`multihost.hybrid_mesh`).

  * `create_mesh(axes, devices)` keeps the JAX rules: -1 means "every
    remaining device", at most one axis is -1, a size that does not divide
    the remaining count raises, and sizes that underfill the devices take
    a prefix of them. The default devices are every local CUDA device;
    with no CUDA and no `devices=` it raises, never drops to the CPU.
  * Unlike JAX, an explicit `devices=` list may repeat a device:
    `[torch.device("cpu")] * 4` is a 4-shard mesh on the one CPU device
    (the CPU tests' mesh), `[cuda:0, cuda:0]` two shards on one card. The
    shards of one device run one after the other on it. `cpu` and `cpu:1`
    both compute on the CPU but are two devices of a mesh, each with its
    own replica and thread (the CPU tests' two-device mesh).
  * Tensor parallelism (a 'model' axis above 1, `tp_param_shardings`) is
    not ported: it raises, naming ROADMAP A8-tp.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

TP_NOT_PORTED = ("tensor parallelism over a 'model' mesh axis is not ported "
                 "(ROADMAP A8-tp)")


def canonical(device: Union[str, torch.device]) -> torch.device:
    """`device` with its index: "cuda" names the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices` (an ndarray of `torch.device`, one axis per name) and the
    axis names. `processes` > 1 marks a multi-process mesh whose first axis
    spans the processes: `shape` reports that axis's global size, while
    `devices` holds this process's devices only."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]
    processes: int = 1

    @property
    def shape(self) -> Dict[str, int]:
        sizes = dict(zip(self.axis_names, self.devices.shape))
        sizes[self.axis_names[0]] *= self.processes
        return sizes

    def shard_devices(self, axis: str = "data") -> List[torch.device]:
        """This process's device of each shard along `axis`, in mesh order.
        Every other axis must be 1: tensor parallelism is not ported."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")
        if any(self.shape[a] > 1 for a in self.axis_names if a != axis):
            raise NotImplementedError(TP_NOT_PORTED)
        return [canonical(d) for d in self.devices.reshape(-1)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def local_cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices= explicitly "
                           "(e.g. [torch.device('cpu')] * n on the CPU)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def create_mesh(axes: Optional[Dict[str, int]] = None,
                devices: Optional[Sequence[Union[str, torch.device]]] = None) -> Mesh:
    """axes: {axis_name: size}, with -1 meaning 'all remaining devices'.
    Default: {'data': -1} over every local CUDA device."""
    devices = [canonical(d) for d in (devices if devices is not None
                                      else local_cuda_devices())]
    axes = dict(axes or {"data": -1})
    n = len(devices)
    names = list(axes)
    sizes: List[Optional[int]] = []
    remaining = n
    for name in names:
        size = int(axes[name])
        if size == -1:
            sizes.append(None)
            continue
        if size < 1 or remaining % size != 0:
            raise ValueError(f"axis {name}={size} does not divide {remaining}")
        sizes.append(size)
        remaining //= size
    if sizes.count(None) > 1:
        raise ValueError("at most one axis may be -1")
    if None in sizes:
        sizes[sizes.index(None)] = remaining
    total = int(np.prod(sizes))
    # a prefix of the devices when the sizes underfill them
    grid = np.empty(total, dtype=object)
    grid[:] = devices[:total]
    return Mesh(grid.reshape(tuple(sizes)), tuple(names))


def data_mesh(n: int, device: Union[str, torch.device, None] = None) -> Mesh:
    """A 1-D 'data' mesh of `n` shards (-1: every local device) for a
    surface's device: on CUDA over the local cards, on the CPU `n` repeats
    of the one CPU device (-1 there is 1)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cpu":
        return create_mesh({"data": -1}, [device] * (1 if n == -1 else int(n)))
    return create_mesh({"data": int(n)})


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def split_rows(n: int, shards: int) -> List[Tuple[int, int]]:
    """[start, stop) of each of `shards` equal contiguous parts of n rows
    (n a multiple of shards), in mesh order."""
    if n % shards:
        raise ValueError(f"{n} rows do not split into {shards} equal shards")
    per = n // shards
    return [(i * per, (i + 1) * per) for i in range(shards)]


def batch_sharding(mesh: Mesh, axis: str = "data") -> List[torch.device]:
    """The placement of a batch sharded on its leading dim over `axis`:
    the device of each contiguous shard, in mesh order."""
    return mesh.shard_devices(axis)


def replicated_sharding(mesh: Mesh) -> List[torch.device]:
    """The placement of a replicated value: one copy per distinct device."""
    return list(dict.fromkeys(canonical(d) for d in mesh.devices.reshape(-1)))


def shard_batch(x, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """A host array or tensor with its leading dim split into the mesh's
    shards, each on its device, in mesh order."""
    x = torch.as_tensor(x)
    devices = batch_sharding(mesh, axis)
    return [x[a:b].to(d) for (a, b), d in zip(split_rows(x.shape[0], len(devices)),
                                               devices)]


def tp_param_shardings(params, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel placement of the UNet weights: not ported."""
    raise NotImplementedError(TP_NOT_PORTED)


def parse_mesh_spec(spec) -> int:
    """The data-parallel size a CLI mesh spec names: 'N', 'auto' (-1, every
    visible device) or 'DxT'; T > 1 raises (tensor parallelism, A8-tp)."""
    spec = str(spec)
    if "x" in spec:
        d, t = spec.split("x", 1)
        if int(t) > 1:
            raise NotImplementedError(TP_NOT_PORTED)
        return int(d)
    return -1 if spec == "auto" else int(spec)


def apply_dp_mesh(generator, spec, device: Union[str, torch.device, None] = None) -> Mesh:
    """Attach a data-parallel mesh to an `ImageGenerator` from a CLI spec:
    a device count ('2'), 'auto' for every visible device, or 'DxT', whose
    T > 1 (tensor parallelism) raises naming ROADMAP A8-tp. Rounds the
    generator's device batch up to a multiple of the dp size, since every
    shorter batch would be padded. `device` (default: the generator's)
    picks CUDA cards, or repeats of the CPU device.

    Callers that derive a coalescing cap from the device batch read
    `generator.batch_size` after this call."""
    if device is None:
        device = generator.model_manager.device
    mesh = data_mesh(parse_mesh_spec(spec), device)
    generator.set_mesh(mesh)
    dp = mesh.shape["data"]
    if generator.batch_size % dp:
        generator.batch_size = -(-generator.batch_size // dp) * dp
    return mesh
