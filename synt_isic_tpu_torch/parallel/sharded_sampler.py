"""Data-parallel sampling and attribution fan-out over a device mesh.

The port of `synt_isic_tpu/parallel/sharded_sampler.py`. Seeds are split
into contiguous shards along the mesh's 'data' axis, in mesh order; each
shard's walk runs on its device with that device's model replica
(`replicas.sampling_replica`: built once from the primary's state dict,
shared by repeated devices, with the device's own kernel switches), one
host thread per distinct device (`replicas.run_per_device`). On a mesh
with a 'model' axis above 1 (tensor parallelism) a shard walks on its
mesh row with the UNet channel-sharded over the row
(`tensor_parallel.tp_replica`), its activations and its thread on the
row's first device; a multi-process mesh with such an axis raises, as in
the JAX package. The initial noise of every seed is drawn as the unsharded
walk draws it, on the primary sampler's device, and the step noise of
(seed, k) likewise, so an image depends on its seed alone, whatever the
layout, up to the rounding a batch-size- or width-dependent convolution
brings.

A batch that does not divide the shard count is padded cyclically
(`np.resize`, which reaches the padded length even when the pad exceeds
the batch: 1 seed on 4 shards), and the pad rows are dropped from the
images, the noise hashes, the seeds and the trajectory.

In a multi-process run (`multihost`) every process walks its own rows of
the padded batch (`local_batch_bounds`) on its local mesh, and the rows
are gathered across the processes, so each returns the whole batch.

`sharded_scores` gives the same split to a batched scoring function (the
XAI frame batches, fairness corpora).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .mesh import Mesh, canonical, pad_to_multiple, split_rows
from .replicas import run_per_device, sampling_replica
from .tensor_parallel import tp_replica


def _cyclic(n: int, padded: int) -> np.ndarray:
    """Row indices of a batch of n padded cyclically to `padded` rows."""
    return np.resize(np.arange(n), padded)


class ShardedSampler:
    """Wraps a `DiffusionSampler` with a mesh's data-parallel split.

    Tensor parallelism is configured by the mesh itself, as in the JAX
    package: when the mesh has a `tp_axis` ('model') axis above 1, data
    shard i walks on row i of the mesh (its 'model' devices) with the UNet
    channel-sharded over it (`tensor_parallel.tp_replica`), its
    activations on the row's first device; else `tp_axis` is None and each
    shard walks a replica on its device. A 1-D 'data' mesh behaves as
    before."""

    def __init__(self, sampler, mesh: Mesh, axis: str = "data", tp_axis: str = "model"):
        self.sampler = sampler
        self.mesh = mesh
        self.axis = axis
        self.tp_axis = (tp_axis if tp_axis in mesh.axis_names and mesh.shape[tp_axis] > 1
                        else None)
        self.rows = mesh.rows(axis, tp_axis)
        self.devices = [row[0] for row in self.rows]
        self.n_shards = len(self.devices)
        primary = canonical(sampler.device)
        self._samplers: Dict[torch.device, Any] = {}
        for d in dict.fromkeys(self.devices):
            self._samplers[d] = sampler if d == primary else sampler.on_device(d)

    def sample(self, model: torch.nn.Module, seeds: Union[int, np.ndarray],
               capture_trajectory: Union[bool, int] = False,
               class_labels: Union[int, np.ndarray, None] = None,
               initial_noise: Optional[Any] = None,
               step_noise: Optional[Any] = None,
               stream_to_host: bool = False) -> Dict[str, Any]:
        """`DiffusionSampler.sample` over the mesh: the same arguments and
        the same result, the images on the primary sampler's device."""
        from . import multihost

        seeds_arr = np.atleast_1d(np.asarray(seeds, dtype=np.uint32))
        n = len(seeds_arr)
        procs = self.mesh.processes
        if procs > 1 and self.tp_axis is not None:
            # the JAX package refuses it too: the per-layer gathers stay
            # inside one process's cards
            raise NotImplementedError(
                "tensor-parallel sampling is single-process (ICI) only; "
                "use a 1-D 'data' mesh across hosts")
        padded = pad_to_multiple(n, self.n_shards * procs)
        rows = _cyclic(n, padded)
        labels = None
        if class_labels is not None:
            labels = np.broadcast_to(np.atleast_1d(np.asarray(class_labels, np.int64)),
                                     (n,))[rows]
        dev = self.sampler.device
        noise = (self.sampler.initial_noise(seeds_arr) if initial_noise is None
                 else torch.as_tensor(initial_noise, dtype=torch.float32, device=dev))
        from ..diffusion.sampler import noise_hashes

        hashes = noise_hashes(noise)
        rows_t = torch.as_tensor(rows, device=noise.device)
        noise = noise.index_select(0, rows_t)
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, device=dev)
            step_noise = step_noise.index_select(1, rows_t.to(step_noise.device))
        seeds_pad = seeds_arr[rows]

        start, stop = ((0, padded) if procs == 1
                       else multihost.local_batch_bounds(padded))
        spans = [(start + a, start + b) for a, b in split_rows(stop - start, self.n_shards)]

        def walk(i: int) -> Dict[str, Any]:
            d = self.devices[i]
            a, b = spans[i]
            walker = (tp_replica(model, self.rows[i]) if self.tp_axis is not None
                      else sampling_replica(model, d))
            return self._samplers[d].sample(
                walker, seeds_pad[a:b],
                capture_trajectory=capture_trajectory,
                initial_noise=noise[a:b].to(d),
                step_noise=None if step_noise is None else step_noise[:, a:b].to(d),
                class_labels=None if labels is None else labels[a:b],
                stream_to_host=stream_to_host)

        outs = run_per_device(self.devices, walk)
        images = torch.cat([o["images"].to(dev) for o in outs])
        traj = None
        if capture_trajectory:
            frames = [o["trajectory"] for o in outs]
            traj = (np.concatenate(frames, axis=1) if isinstance(frames[0], np.ndarray)
                    else torch.cat([f.to(dev) for f in frames], dim=1))
        if procs > 1:
            images = multihost.gather_rows(images)
            if traj is not None:
                traj = (multihost.gather_rows(torch.as_tensor(traj), dim=1).numpy()
                        if isinstance(traj, np.ndarray)
                        else multihost.gather_rows(traj, dim=1))
        out: Dict[str, Any] = dict(outs[0])
        out.update(images=images[:n], noise_hashes=hashes, seeds=seeds_arr.copy())
        if traj is not None:
            out["trajectory"] = traj[:, :n]
        return out


def sharded_scores(fn: Callable, batch, mesh: Mesh, axis: str = "data",
                   extra_args=()) -> np.ndarray:
    """`fn(shard, *extra_args)` for each shard of `batch` on its device,
    padded cyclically to the shard count and cut back; the rows gathered
    as one numpy array. `fn` finds what it needs on that device from
    `shard.device` (e.g. `replicas.sampling_replica` of a classifier)."""
    batch = torch.as_tensor(np.asarray(batch) if not isinstance(batch, torch.Tensor)
                            else batch)
    n = batch.shape[0]
    devices = mesh.shard_devices(axis)
    padded = pad_to_multiple(n, len(devices))
    if padded != n:
        batch = batch.index_select(0, torch.as_tensor(_cyclic(n, padded),
                                                      device=batch.device))
    spans = split_rows(padded, len(devices))

    def score(i: int):
        d = devices[i]
        a, b = spans[i]
        out = fn(batch[a:b].to(d), *extra_args)
        return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

    return np.concatenate(run_per_device(devices, score))[:n]


def shard_frames(frames: torch.Tensor, mesh: Mesh, axis: str = "data"
                 ) -> Tuple[List[Tuple[torch.device, int, int]], torch.Tensor]:
    """(device, start, stop) of each shard of a frame stack padded to the
    shard count by repeating its last frame (the JAX package's
    `_pad_for_mesh`), and the padded stack."""
    devices = mesh.shard_devices(axis)
    s = frames.shape[0]
    pad = (-s) % len(devices)
    if pad:
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
    return [(d, a, b) for d, (a, b) in zip(devices, split_rows(frames.shape[0],
                                                                len(devices)))], frames
