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
  * A 2-D ('data', 'model') mesh is tensor parallelism: each 'data' shard
    walks on its row of 'model' devices (`rows`), its UNet weights
    channel-sharded over the row by `tp_param_shardings`, the JAX rule in
    the port's layouts, and `tensor_parallel.tp_replica` runs the layers as
    GSPMD runs them for JAX. Everything else that shards over 'data' (XAI,
    training) takes the first device of each row, and the 'model' axis
    replicates, as JAX's replicated state does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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

    def rows(self, axis: str = "data", tp_axis: str = "model") -> List[List[torch.device]]:
        """This process's devices of each shard along `axis`, in mesh order:
        for each shard, the devices of its other axes, `tp_axis` outermost
        (on a ('data', 'model') mesh, the 'model' devices of each 'data'
        shard)."""
        names = list(self.axis_names)
        if axis not in names:
            raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")
        others = sorted((a for a in names if a != axis), key=lambda a: a != tp_axis)
        order = [names.index(a) for a in [axis] + others]
        grid = np.transpose(self.devices, order).reshape(self.devices.shape[order[0]], -1)
        return [[canonical(d) for d in row] for row in grid]

    def shard_devices(self, axis: str = "data") -> List[torch.device]:
        """This process's device of each shard along `axis`, in mesh order:
        the first device of each row (`rows`)."""
        return [row[0] for row in self.rows(axis)]

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


def surface_mesh(axes: Dict[str, int], device: Union[str, torch.device, None] = None) -> Mesh:
    """A mesh of `axes` (-1: every remaining device) for a surface's
    device: on CUDA over the local cards, on the CPU repeats of the one CPU
    device, as many as the sizes multiply to (-1 there is 1)."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cpu":
        n = int(np.prod([max(int(s), 1) for s in axes.values()]))
        return create_mesh(axes, [device] * n)
    return create_mesh(axes)


def data_mesh(n: int, device: Union[str, torch.device, None] = None) -> Mesh:
    """A 1-D 'data' mesh of `n` shards (-1: every local device) for a
    surface's device: on CUDA over the local cards, on the CPU `n` repeats
    of the one CPU device (-1 there is 1)."""
    return surface_mesh({"data": int(n)}, device)


def mesh_record(mesh: Mesh) -> Dict[str, Any]:
    """What a sidecar's `block` records of the mesh a block was sampled
    over: `dp_mesh`, its device count (the JAX package's field, which a
    JAX reader still finds), and `mesh`, its axes and devices in mesh order
    (e.g. {"axes": {"data": 1, "model": 2}, "devices": ["cuda:0",
    "cuda:0"]}), so that `--reproduce` rebuilds the same layout, a 'model'
    axis included (`recorded_mesh`)."""
    return {"dp_mesh": int(mesh.devices.size),
            "mesh": {"axes": {name: int(size) for name, size
                              in zip(mesh.axis_names, mesh.devices.shape)},
                     "devices": [str(d) for d in mesh.devices.reshape(-1)]}}


def _present(device: torch.device) -> bool:
    """This host has `device`: the CPU (any index), or a visible card."""
    if device.type == "cpu":
        return True
    return (device.type == "cuda" and torch.cuda.is_available()
            and (device.index or 0) < torch.cuda.device_count())


def recorded_mesh(block: Dict[str, Any],
                  device: Union[str, torch.device, None] = None) -> Optional[Mesh]:
    """The mesh a sidecar's `block` records, for `--reproduce`: exactly the
    recorded axes and devices where it has `mesh` (`mesh_record`); a 1-D
    'data' mesh of `dp_mesh` devices for `device` (`data_mesh`) where it
    has only `dp_mesh` (a sidecar of the JAX package, or of the port before
    it recorded the mesh); None for a block sampled without a mesh. Raises
    LookupError where this host lacks a recorded device, or has fewer cards
    than `dp_mesh`."""
    record = block.get("mesh")
    if record:
        devices = [torch.device(d) for d in record["devices"]]
        missing = sorted({str(d) for d in devices if not _present(d)})
        if missing:
            raise LookupError(f"sidecar block was sampled over the mesh {record['axes']} on "
                              f"{record['devices']}; this host lacks {', '.join(missing)} "
                              f"— the layout cannot be rebuilt here")
        return create_mesh(record["axes"], devices)
    n_dev = int(block.get("dp_mesh") or 0)
    if not n_dev:
        return None
    on_cuda = torch.device(device or "cuda").type == "cuda"
    have = torch.cuda.device_count() if on_cuda else n_dev
    if have < n_dev:
        raise LookupError(f"sidecar block was sampled over a {n_dev}-device mesh; this "
                          f"host has {have} — the layout cannot be rebuilt here")
    return data_mesh(n_dev, device)


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


# the Flax leaf shape the weight carrier makes of a torch leaf of each rank
# is read from a probe whose dims are these distinct sizes
_PROBE = (2, 3, 5, 7, 11, 13)


def _flax_last_dim(key: str, ndim: int) -> int:
    """The dim of a torch leaf that the weight carrier (`io/convert.py`)
    puts last in its Flax leaf: dim 0 (output features) of a conv or
    dense kernel, dim 1 of an embedding table."""
    from ..io.convert import flatten_tree, torch_to_flax

    (leaf,) = flatten_tree(torch_to_flax({key: np.zeros(_PROBE[:ndim], np.float32)},
                                         strip_prefixes=())).values()
    return _PROBE.index(leaf.shape[-1])


def tp_shard_dims(params, tp: int) -> Dict[str, Optional[int]]:
    """`tp_param_shardings` for a 'model' axis of size `tp`."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    dims: Dict[str, Optional[int]] = {}
    for key, value in params.items():
        shape = tuple(value.shape)
        dim = _flax_last_dim(key, len(shape)) if len(shape) >= 2 else None
        # JAX: a leaf of rank >= 2 whose last (Flax) width divides by the
        # axis and is at least the axis size is sharded on it
        dims[key] = dim if dim is not None and shape[dim] % tp == 0 and shape[dim] >= tp \
            else None
    return dims


def tp_param_shardings(params, mesh: Mesh, axis: str = "model") -> Dict[str, Optional[int]]:
    """Tensor-parallel placement of the UNet weights (a state dict, or the
    module): {key: the dim sharded over `axis`, or None where the leaf is
    replicated}. The JAX rule (`synt_isic_tpu/parallel/mesh.py`
    `tp_param_shardings`): a leaf of rank >= 2 is sharded on the dim that
    is last in its Flax leaf (the output features of a conv or dense
    kernel, the features of an embedding table) when the axis size divides
    that width and does not exceed it; biases, norm scales and odd widths
    (`conv_out`'s 3 channels) are replicated. The dim is read through the
    weight carrier, so it cannot drift from the JAX placement. With the
    output features sharded each device computes its channel slice with
    the full contraction: no partial sums."""
    return tp_shard_dims(params, mesh.shape[axis])


def parse_mesh_spec(spec) -> Dict[str, int]:
    """The mesh axes a CLI mesh spec names: 'N' ({'data': N}), 'auto'
    ({'data': -1}, every visible device) or 'DxT' ({'data': D, 'model':
    T}, tensor parallelism over a T-sized 'model' axis)."""
    spec = str(spec)
    if "x" in spec:
        d, t = spec.split("x", 1)
        return {"data": int(d), "model": int(t)}
    return {"data": -1 if spec == "auto" else int(spec)}


def apply_dp_mesh(generator, spec, device: Union[str, torch.device, None] = None) -> Mesh:
    """Attach a device mesh to an `ImageGenerator` from a CLI spec: a
    device count ('2') or 'auto' for every visible device build a 1-D
    data-parallel mesh; 'DxT' ('1x2') a {'data': D, 'model': T} mesh whose
    'model' axis channel-shards the UNet weights (tensor parallelism, the
    latency axis). Rounds the generator's device batch up to a multiple of
    the dp size D, since every shorter batch would be padded. `device`
    (default: the generator's) picks CUDA cards, or repeats of the CPU
    device.

    Callers that derive a coalescing cap from the device batch read
    `generator.batch_size` after this call."""
    if device is None:
        device = generator.model_manager.device
    mesh = surface_mesh(parse_mesh_spec(spec), device)
    generator.set_mesh(mesh)
    dp = mesh.shape["data"]
    if generator.batch_size % dp:
        generator.batch_size = -(-generator.batch_size // dp) * dp
    return mesh
