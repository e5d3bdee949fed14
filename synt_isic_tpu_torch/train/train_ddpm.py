"""Per-class DDPM training: noise-prediction MSE with Adam, in PyTorch.

The port of `synt_isic_tpu/train/train_ddpm.py` (itself parity with the
reference's `train_class`): uniform random timesteps, forward-process
noising from the schedule's alpha-bar table, MSE on epsilon, Adam lr=1e-4,
best-loss checkpointing to `unet_<CLASS>_best.pth` (diffusers keys, f32,
`torch.save`; the JAX package's `load_pth` reads it), every-N-epoch
snapshots, and a resume state.

What differs from the JAX trainer, and why:
  * mixed precision is the same: bf16 compute on the model with f32
    parameters (`UNet2D(dtype=bf16, param_dtype=f32)`), f32 loss and
    gradients, no gradient scaler (bf16 keeps f32's exponent range);
  * on CUDA the attention blocks run the hand-written forward and backward
    kernels (`ops/attention.py`), and GroupNorm the f32-statistics path;
  * PyTorch runs eagerly: the epoch is a plain loop of steps, with no
    compiled epoch scan and no CUDA graph yet. Checkpoints go through the
    async writer (best checkpoint on improvement, coalesced);
  * random numbers come from a `torch.Generator` seeded from
    `config.seed`, not from threefry keys, so draws differ from the JAX
    package's; `train_step` takes injected `t`, `eps` and CFG dropout mask
    `drop` so a test can feed it the JAX draws;
  * the resume state keeps `best_loss`, and a run resumed after its last
    epoch runs no further epoch (the JAX trainer re-runs the last one).
Labelled batches, `(images, labels)` tuples (`train_conditional.py`),
train the class-conditional UNet through the same loop.

Data parallelism (`train_class(mesh=)`, reference `train_ddpm.py:371,
409-417, 495-600`): the global batch must divide by the mesh's 'data'
size. Each step's timesteps, noise and label dropout are drawn once for the
global batch, exactly as the unsharded step draws them, and only then
split into the shards, so a dp step equals the unsharded step up to the
order of the gradient sum. Each shard's forward and backward run on its
device's replica (`parallel.replicas.Replicas`) with loss = its rows' sum
over the global batch size; the replicas' gradients are summed into the
primary's and, when a process group exists, `all_reduce`d across the
processes, and the clip, Adam and the EMA run once on the reduced
gradients before the primary's weights are copied back into every
replica. Across processes (`parallel.multihost`) every process draws the
same global batch and keeps its rows, and checkpoints go through
`host0_only`; a single process keeps the async writer. A 2-D ('data',
'model') mesh trains over its 'data' axis on the first device of each
row: the state is replicated over 'model', as the JAX trainer's
replicated state is, so its step is the D-shard data-parallel step.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..diffusion.schedules import DiffusionSchedule, device_table
from ..io.pth import save_checkpoint
from ..model_manager import resolve_device
from ..models.unet2d import UNet2D, UNet2DConfig
from ..parallel import multihost
from ..parallel.mesh import split_rows
from ..parallel.replicas import Replicas


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX `TrainConfig`, field for field (see its comments for each
    option's rationale). Every default is the reference's behaviour."""
    image_size: int = 128
    batch_size: int = 2
    learning_rate: float = 1e-4
    epochs: int = 50
    num_train_timesteps: int = 1000
    snapshot_every: int = 5
    bf16_compute: bool = True
    seed: int = 0
    # EMA of the weights (0.0 = off); checkpoints then ship the EMA weights,
    # warmup d_t = min(decay, (1+t)/(10+t))
    ema_decay: float = 0.0
    # "constant" (optionally with a linear warmup) or "cosine" (warmup, then
    # cosine decay to lr_end_factor * learning_rate over the run)
    lr_schedule: str = "constant"
    warmup_steps: int = 0
    lr_end_factor: float = 0.05
    # min-SNR loss weighting gamma (0.0 = off)
    min_snr_gamma: float = 0.0
    # deterministic probe loss for best selection every N epochs (0 = off:
    # best selection on the running train loss)
    eval_every: int = 0
    eval_probe_images: int = 16
    eval_t_points: int = 8
    # label dropout to the null class for classifier-free guidance (labelled
    # batches only)
    cond_dropout: float = 0.1
    # offset-noise strength: a per-(image, channel) constant added to eps
    offset_noise: float = 0.0


@dataclasses.dataclass
class TrainState:
    """The model (updated in place), its optimizer, the lr schedule, the
    count of steps taken, the f32 EMA of the weights (None when off), and
    the model's replicas over a data-parallel mesh (None without one)."""
    model: UNet2D
    optimizer: torch.optim.Adam
    lr_schedule: Callable[[int], float]
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    replicas: Optional[Replicas] = None

    def export_params(self) -> Dict[str, torch.Tensor]:
        """The weights checkpoints ship: the EMA when on, else the model's."""
        return self.ema if self.ema is not None else self.model.state_dict()


def ema_update(ema: Dict[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               step: int, decay: float) -> None:
    """In place: ema = d * ema + (1 - d) * params with the warmup
    d = min(decay, (1+step)/(10+step)), so the average is not biased toward
    the random init early on."""
    d = min(decay, (1.0 + step) / (10.0 + step))
    values = [ema[k] for k in ema]
    torch._foreach_mul_(values, d)
    torch._foreach_add_(values, [params[k].detach().float() for k in ema],
                        alpha=1.0 - d)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over `transition_steps`, then
    constant (constant `init_value` for a non-positive length)."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int,
                           total_steps: int, end_factor: float
                           ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule from 0: a linear warmup (clamped
    to total/10) to `peak_lr`, then cosine decay to end_factor * peak over
    the rest of `total_steps`."""
    warmup = min(warmup_steps, max(1, total_steps // 10))
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"cosine schedule needs total_steps > warmup, got "
                         f"{total_steps} <= {warmup}")
    alpha = end_factor if peak_lr != 0.0 else 0.0
    rise = linear_schedule(0.0, peak_lr, warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            return rise(count)
        c = min(count - warmup, decay)
        return peak_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay))
                          + alpha)
    return schedule


def make_lr_schedule(config: TrainConfig,
                     total_steps: Optional[int] = None) -> Callable[[int], float]:
    """lr as a function of the number of updates already made, per
    TrainConfig (optax's convention: the first update reads count 0).
    `total_steps` is required for the cosine schedule."""
    if config.lr_schedule == "constant":
        if config.warmup_steps > 0:
            return linear_schedule(0.0, config.learning_rate, config.warmup_steps)
        return lambda count: config.learning_rate
    if config.lr_schedule == "cosine":
        if not total_steps:
            raise ValueError("cosine lr_schedule needs total_steps "
                             "(epochs x steps-per-epoch)")
        return warmup_cosine_schedule(config.learning_rate, config.warmup_steps,
                                      total_steps, config.lr_end_factor)
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def create_train_state(model: UNet2D, config: TrainConfig,
                       total_steps: Optional[int] = None, mesh=None) -> TrainState:
    """Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) over the model's
    parameters, where they are; the EMA starts as an f32 copy of them.
    With a mesh, the model's replicas on the mesh's other devices."""
    lr = make_lr_schedule(config, total_steps)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr(0),
                                 betas=(0.9, 0.999), eps=1e-8)
    ema = ({k: v.detach().float().clone() for k, v in model.state_dict().items()}
           if config.ema_decay > 0 else None)
    return TrainState(model=model, optimizer=optimizer, lr_schedule=lr, ema=ema,
                      replicas=Replicas(model, mesh) if mesh is not None else None)


def global_rows(state: TrainState, b_local: int) -> Tuple[int, int, int]:
    """(global batch size, first and end row of this process's part) of a
    step whose local batch has `b_local` rows: every process draws the
    step's noise for the global batch and keeps its rows."""
    procs = state.replicas.mesh.processes if state.replicas is not None else 1
    b = b_local * procs
    start = multihost.process_index() * b_local if procs > 1 else 0
    return b, start, start + b_local


def shard_spans(state: TrainState, b_local: int):
    """(device, start, stop) of each shard of a local batch, in mesh order."""
    devices = state.replicas.devices
    return [(d, a, z) for d, (a, z) in zip(devices, split_rows(b_local, len(devices)))]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def make_train_step(schedule: DiffusionSchedule, config: TrainConfig) -> Callable:
    """The train step: (state, batch, generator=None, t=None, eps=None,
    labels=None, drop=None) -> loss, a 0-d f32 tensor on the batch's device
    (no host sync). Updates `state` in place.

    `batch` is NHWC images, or an `(images, labels)` tuple. `t` ((B,) ints)
    and `eps` (the images' shape, offset noise included) are drawn from
    `generator` unless given. `labels` ((B,) class ids) train a conditional
    UNet; where the (B,) bool mask `drop` is set, a label is replaced by
    the null class (the last embedding row). Unless given, `drop` is drawn
    with probability `cond_dropout` (after t and eps)."""
    tables: Dict[torch.device, torch.Tensor] = {}
    T = schedule.num_train_timesteps

    def row_errors(model: UNet2D, batch: torch.Tensor, t: torch.Tensor,
                   eps: torch.Tensor, labels: Optional[torch.Tensor]) -> torch.Tensor:
        """(B,) f32 per-image losses of `model` on its device's rows."""
        dev = batch.device
        if dev not in tables:
            tables[dev] = device_table(schedule.alphas_cumprod, dev)
        b = batch.shape[0]
        t = t.to(dev)
        x0, eps = _nchw(batch.float()), _nchw(eps.to(dev, torch.float32))
        ab_t = tables[dev][t].reshape(b, 1, 1, 1)
        noisy = torch.sqrt(ab_t) * x0 + torch.sqrt(1.0 - ab_t) * eps
        pred = model(noisy, t, None if labels is None else labels.to(dev))
        err = torch.mean((pred.float() - eps) ** 2, dim=(1, 2, 3))
        if config.min_snr_gamma > 0.0:
            snr = (ab_t / (1.0 - ab_t)).reshape(b)
            err = err * (torch.clamp(snr, max=config.min_snr_gamma) / snr)
        return err

    def train_step(state: TrainState, batch: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   labels: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> torch.Tensor:
        if isinstance(batch, (tuple, list)):
            batch, labels = batch
        dev = batch.device
        # drawn for the global batch (the local one without a mesh across
        # processes), then this process's rows kept
        b, lo, hi = global_rows(state, batch.shape[0])
        shape = (b,) + tuple(batch.shape[1:])
        if t is None:
            t = torch.randint(0, T, (b,), generator=generator, device=dev)
        if eps is None:
            eps = torch.randn(shape, generator=generator, device=dev)
            if config.offset_noise > 0.0:
                eps = eps + config.offset_noise * torch.randn(
                    (b, 1, 1, batch.shape[-1]), generator=generator, device=dev)
        if labels is not None:
            labels = labels.to(dev).long()
            if drop is None and config.cond_dropout > 0.0:
                drop = torch.rand(b, generator=generator, device=dev) < config.cond_dropout
            if drop is not None:
                null = state.model.config.num_class_embeds - 1
                labels = torch.where(drop.to(dev)[lo:hi], torch.full_like(labels, null),
                                     labels)
        t, eps = t.to(dev)[lo:hi], eps[lo:hi]
        if state.replicas is None:
            loss = row_errors(state.model, batch, t, eps, labels).mean()
            return apply_gradients(state, loss, config.ema_decay)

        def shard_losses():
            for d, a, z in shard_spans(state, batch.shape[0]):
                yield row_errors(state.replicas[d], batch[a:z].to(d), t[a:z], eps[a:z],
                                 None if labels is None else labels[a:z]).sum() / b

        return apply_sharded_gradients(state, shard_losses(), config.ema_decay)

    return train_step


def apply_gradients(state: TrainState, loss: torch.Tensor, ema_decay: float,
                    clip: Optional[Callable[[Any], Any]] = None) -> torch.Tensor:
    """One update of `state` from `loss`: backward, `clip` on the model's
    parameters when given, an Adam step at the schedule's lr for the count
    of updates made, the EMA, the count. Returns the detached loss."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return _update(state, loss, ema_decay, clip)


def apply_sharded_gradients(state: TrainState, shard_losses, ema_decay: float,
                            clip: Optional[Callable[[Any], Any]] = None) -> torch.Tensor:
    """One data-parallel update: the backward of each shard's loss (each
    on its replica, yielded one at a time so a shard's graph is freed
    before the next is built), the replicas' gradients and the losses summed
    into the primary and across processes, then `apply_gradients`' clip,
    Adam step and EMA, and the new weights copied into every replica.
    Returns the summed, detached loss on the primary's device."""
    state.replicas.zero_grad()
    dev = next(state.model.parameters()).device
    total = None
    for loss in shard_losses:
        loss.backward()
        part = loss.detach().to(dev)
        total = part if total is None else total + part
    return _update(state, state.replicas.reduce_gradients(extra=total), ema_decay, clip)


def _update(state: TrainState, loss: torch.Tensor, ema_decay: float,
            clip: Optional[Callable[[Any], Any]]) -> torch.Tensor:
    """The update from the gradients in place: the clip, Adam at the
    schedule's lr, the EMA, the count, and the replicas' weights."""
    if clip is not None:
        clip(state.model.parameters())
    for group in state.optimizer.param_groups:
        group["lr"] = state.lr_schedule(state.step)
    state.optimizer.step()
    if state.ema is not None:
        ema_update(state.ema, state.model.state_dict(), state.step, ema_decay)
    state.step += 1
    if state.replicas is not None:
        state.replicas.broadcast()
    return loss.detach()


def make_eval_fn(model: UNet2D, schedule: DiffusionSchedule,
                 config: TrainConfig, probe_images: torch.Tensor,
                 probe_labels: Optional[torch.Tensor] = None) -> Callable:
    """Deterministic validation loss: params -> float.

    Unweighted epsilon-MSE on a fixed probe: the `probe_images` (NHWC, on
    the model's device) x `eval_t_points` timesteps stratified over [0, T)
    x noise fixed from a generator seeded with seed + 0x5EED. `params` (a
    state dict, e.g. the EMA) is run through the model's graph without
    touching the model's own weights. `probe_labels` ((n_img,) class ids)
    score a conditional model."""
    dev = probe_images.device
    ab = device_table(schedule.alphas_cumprod, dev)
    T = schedule.num_train_timesteps
    n_img, n_t = probe_images.shape[0], config.eval_t_points
    t_grid = ((2 * torch.arange(n_t, device=dev) + 1) * T) // (2 * n_t)
    gen = torch.Generator(device=dev).manual_seed(config.seed + 0x5EED)
    eps = torch.randn((n_t,) + tuple(probe_images.shape), generator=gen, device=dev)
    x0 = _nchw(probe_images.float())

    @torch.no_grad()
    def eval_fn(params: Mapping[str, torch.Tensor]) -> float:
        losses = []
        for i in range(n_t):
            ab_t = ab[t_grid[i]]
            e = _nchw(eps[i])
            noisy = torch.sqrt(ab_t) * x0 + torch.sqrt(1.0 - ab_t) * e
            t_b = t_grid[i].expand(n_img)
            args = (noisy, t_b) if probe_labels is None else (noisy, t_b, probe_labels)
            pred = torch.func.functional_call(model, dict(params), args)
            losses.append(torch.mean((pred.float() - e) ** 2))
        return float(torch.stack(losses).mean())

    return eval_fn


def train_state_tree(state: TrainState, best_loss: float = float("inf")) -> Dict[str, Any]:
    """Everything a resume needs: weights, optimizer moments and count, the
    step, the EMA and the best loss so far (live tensors, not copies)."""
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step, "ema": state.ema, "best_loss": float(best_loss)}


def _save_tree(tree: Dict[str, Any], path: str) -> None:
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, path)


def save_train_state(state: TrainState, path: str,
                     best_loss: float = float("inf")) -> None:
    """Full mid-run checkpoint (a torch file): weights, optimizer state,
    step, EMA and best loss."""
    _save_tree(train_state_tree(state, best_loss), path)


def resume_snapshot_path(checkpoint_dir, class_name: str) -> Path:
    """The resume snapshot `train_class` keeps for a class in
    `checkpoint_dir` (`save_train_state`'s file): it exists while a run is
    unfinished or was left by one, and `resume=True` continues from it."""
    return Path(checkpoint_dir) / f"train_state_{class_name}.pt"


def restore_train_state(state: TrainState, path: str) -> Dict[str, Any]:
    """Load a `save_train_state` file into a freshly built state of the same
    architecture (in place; shapes are checked by `load_state_dict`).
    Returns the rest of what was saved (`best_loss`)."""
    # loaded on the host: load_state_dict copies the weights and the Adam
    # moments to the parameters' device, and Adam keeps its step counts on
    # the host
    device = next(state.model.parameters()).device
    tree = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(tree["model"], strict=True)
    state.optimizer.load_state_dict(tree["optimizer"])
    state.step = int(tree["step"])
    if state.ema is not None and tree["ema"] is not None:
        state.ema = {k: v.to(device, torch.float32) for k, v in tree["ema"].items()}
    return {"best_loss": float(tree["best_loss"])}


def dataset_color_statistics(dataset, max_images: int = 256):
    """Per-class RGB mean/std for the generator's color postprocessing.

    Datasets with a materialized `.images` stack (ProceduralDataset, [-1,1])
    use it directly; lazy datasets exposing `load_raw` ([0,1],
    SingleClassDataset) load up to `max_images`. None when the dataset
    supports neither."""
    from ..io.color_stats import compute_color_statistics

    imgs = getattr(dataset, "images", None)
    if imgs is not None:
        return compute_color_statistics(np.asarray(imgs[:max_images]),
                                        value_range=(-1.0, 1.0))
    if hasattr(dataset, "load_raw") and len(dataset) > 0:
        n = min(max_images, len(dataset))
        arr = np.stack([dataset.load_raw(i) for i in range(n)])
        return compute_color_statistics(arr, value_range=(0.0, 1.0))
    return None


# the JAX trainer's name for the best/snapshot checkpoint writer
save_checkpoint_torch_format = save_checkpoint


def default_model(config: TrainConfig, device: torch.device,
                  num_class_embeds: Optional[int] = None, remat=False) -> UNet2D:
    """The flagship UNet the trainer builds: bf16 compute (unless
    `bf16_compute` is off) on f32 parameters, and on CUDA the hand-written
    attention kernels and the f32-statistics GroupNorm; the CPU keeps the
    f32 GroupNorm. Weights are initialised from `config.seed`.
    `num_class_embeds` makes it class-conditional; `remat` is `UNet2D`'s."""
    on_cuda = device.type == "cuda"
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        return UNet2D(UNet2DConfig(sample_size=config.image_size,
                                   num_class_embeds=num_class_embeds),
                      dtype=torch.bfloat16 if config.bf16_compute else torch.float32,
                      param_dtype=torch.float32, use_fused_attention=on_cuda,
                      fast_norm=on_cuda, remat=remat)


def _probe(dataset, config: TrainConfig, device: torch.device,
           conditional: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The fixed eval probe, (images, labels or None): the first
    `eval_probe_images` of a materialized dataset, else the first batches
    drawn from a dedicated rng. A conditional model's probe takes labels: a
    labelled pool is class-concatenated, so its probe is evenly spaced
    indices over the pool (a prefix would probe the first class only); lazy
    labelled batches give their own labels."""
    n_probe = config.eval_probe_images
    imgs = getattr(dataset, "images", None)
    labels = None
    if imgs is not None:
        labs = getattr(dataset, "labels", None)
        if labs is not None and conditional:
            idx = np.unique(np.linspace(0, len(labs) - 1, n_probe).astype(np.int64))
            probe = np.asarray(imgs)[idx]
            labels = np.asarray(labs, np.int64)[idx]
        else:
            probe = np.asarray(imgs[:n_probe])
    else:
        rng = np.random.default_rng(config.seed + 1)
        chunks, label_chunks, have = [], [], 0
        for b in dataset.batches(min(n_probe, config.batch_size), rng):
            if isinstance(b, (tuple, list)):
                b, lab = b
                label_chunks.append(np.asarray(lab, np.int64))
            chunks.append(np.asarray(b))
            have += len(chunks[-1])
            if have >= n_probe:
                break
        probe = np.concatenate(chunks)[:n_probe]
        if label_chunks and conditional:
            labels = np.concatenate(label_chunks)[:n_probe]
    return (torch.as_tensor(probe, dtype=torch.float32).to(device),
            None if labels is None else torch.as_tensor(labels).to(device))


def _to_device(batch, device: torch.device):
    """A batch (array, tensor, or an (images, labels) tuple) on `device`."""
    if isinstance(batch, (tuple, list)):
        return tuple(torch.as_tensor(z).to(device) for z in batch)
    return torch.as_tensor(batch).to(device)


def _epoch_batches(dataset, batch_size: int, rng: np.random.Generator,
                   device: torch.device):
    """One epoch of batches on `device` (NHWC f32 images, or (images,
    labels) tuples): one gather for datasets with `epoch_batches`
    (device-resident ones gather on the device), else host batches prepared
    in the background (`prefetch`) and copied over."""
    from .data import prefetch

    if hasattr(dataset, "epoch_batches"):
        stacked = _to_device(dataset.epoch_batches(batch_size, rng), device)
        yield from (zip(*stacked) if isinstance(stacked, tuple) else stacked)
        return
    for batch in prefetch(dataset.batches(batch_size, rng)):
        yield _to_device(batch, device)


def local_rows(batch, rows: Optional[Tuple[int, int]]):
    """This process's rows [start, stop) of a global batch (images, or an
    (images, labels) tuple); the batch itself when `rows` is None."""
    if rows is None:
        return batch
    if isinstance(batch, (tuple, list)):
        return tuple(z[rows[0]:rows[1]] for z in batch)
    return batch[rows[0]:rows[1]]


class _Host0Writer:
    """The `AsyncCheckpointer` interface over `multihost.host0_only`: each
    write runs at once on process 0, every process waiting for it."""

    def submit(self, tree, fn, path, coalesce=None) -> None:
        multihost.host0_only(fn, tree, path)

    def close(self) -> None:
        pass


def checkpoint_writer(multi_process: bool, log=print):
    """The async writer in one process; process 0's synchronous writes,
    with a barrier, across processes (the reference's host0_only path)."""
    if multi_process:
        return _Host0Writer()
    from .async_ckpt import AsyncCheckpointer

    return AsyncCheckpointer(log=log)


def train_class(class_name: str, dataset, checkpoint_dir: str,
                config: TrainConfig = TrainConfig(),
                model: Optional[UNet2D] = None,
                resume: bool = False,
                mesh=None,
                log=print,
                device=None) -> Dict[str, Any]:
    """Full per-class training loop with best-loss + periodic checkpoints
    and resume (weights, optimizer state, step, best loss).

    `device`: CUDA unless the caller names another (raises when CUDA is
    asked for and absent). `model` defaults to `default_model`.

    Resume: the restored step count drives the lr schedule AND the epoch
    loop — a run interrupted after epoch E continues at E+1; a run that had
    finished runs no epoch and keeps its best checkpoint and best loss. The
    data and noise streams restart from the seed, so a resumed run's batch
    order differs from the uninterrupted run's.

    `mesh`: a `parallel.Mesh` with a 'data' axis (on a
    `multihost.hybrid_mesh` it spans the processes): `config.batch_size` is
    the global batch and must divide by the mesh's data size; each step is
    split over the mesh's devices (see the module docstring). `device` is
    then the primary replica's device, which the optimizer and the EMA live
    on. Across processes, checkpoints and statistics are written by
    process 0 only."""
    device = resolve_device(device)
    if mesh is not None:
        mesh.shard_devices("data")   # a mesh without a 'data' axis raises
    if mesh is not None and config.batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {config.batch_size} must be a multiple of the mesh data "
            f"axis size ({mesh.shape['data']}) for dp training")
    model = (model or default_model(config, device)).to(device).train()
    schedule = DiffusionSchedule.create(config.num_train_timesteps)
    steps_per_epoch = max(1, len(dataset) // config.batch_size)
    state = create_train_state(model, config,
                               total_steps=config.epochs * steps_per_epoch, mesh=mesh)
    # across processes every process draws the whole global batch and keeps
    # its rows; process 0 alone writes
    multi = mesh is not None and mesh.processes > 1
    rows = multihost.local_batch_bounds(config.batch_size) if multi else None
    step_fn = make_train_step(schedule, config)

    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    best_path = ckpt_dir / f"unet_{class_name}_best.pth"
    resume_path = resume_snapshot_path(ckpt_dir, class_name)
    start_epoch = 1
    best_loss = float("inf")
    if resume and resume_path.exists():
        best_loss = restore_train_state(state, str(resume_path))["best_loss"]
        start_epoch = state.step // steps_per_epoch + 1
        log(f"[train:{class_name}] resumed from {resume_path} (step "
            f"{state.step}, best loss {best_loss:.5f}); "
            + (f"continuing at epoch {start_epoch}/{config.epochs}"
               if start_epoch <= config.epochs else "all epochs already done"))

    generator = torch.Generator(device=device).manual_seed(config.seed)
    data_rng = np.random.default_rng(config.seed)
    best_val = float("inf")
    history = []

    eval_fn = None
    if config.eval_every > 0:
        conditional = bool(model.config.num_class_embeds)
        eval_fn = make_eval_fn(model, schedule, config,
                               *_probe(dataset, config, device, conditional))

    def select_best(epoch: int, improved_train: bool) -> bool:
        """True when the export weights should become the best checkpoint."""
        nonlocal best_val
        if eval_fn is None:
            return improved_train
        if epoch % config.eval_every and epoch != config.epochs:
            return False
        val = eval_fn(state.export_params())
        if val >= best_val:
            return False
        best_val = val
        return True

    # per-class color statistics for the generator's postprocessing,
    # written up front (data-derived, not model-derived)
    color_stats = dataset_color_statistics(dataset)
    if color_stats is not None:
        from ..io.color_stats import update_color_statistics_file

        multihost.host0_only(update_color_statistics_file, ckpt_dir / "color_statistics.json",
                             class_name, color_stats)

    writer = checkpoint_writer(multi, log)
    loop_ok = False
    try:
        for epoch in range(start_epoch, config.epochs + 1):
            t0 = time.time()
            # losses stay on the device; one host read per epoch
            losses = [step_fn(state, local_rows(batch, rows), generator)
                      for batch in _epoch_batches(dataset, config.batch_size,
                                                  data_rng, device)]
            epoch_loss = (float(torch.stack(losses).mean()) if losses
                          else float("nan"))
            history.append(epoch_loss)
            log(f"[train:{class_name}] epoch {epoch}/{config.epochs} "
                f"loss={epoch_loss:.5f} ({time.time() - t0:.1f}s)")
            improved = math.isfinite(epoch_loss) and epoch_loss < best_loss
            if improved:
                best_loss = epoch_loss
            if select_best(epoch, improved):
                writer.submit(state.export_params(), save_checkpoint,
                              str(best_path), "best")
                log(f"[train:{class_name}] new best "
                    f"({best_val if eval_fn is not None else best_loss:.5f}) "
                    f"-> {best_path}")
            if epoch % config.snapshot_every == 0:
                snap = ckpt_dir / f"unet_{class_name}_epoch{epoch}.pth"
                writer.submit(state.export_params(), save_checkpoint, str(snap))
                writer.submit(train_state_tree(state, best_loss), _save_tree,
                              str(resume_path), "resume")
        writer.submit(train_state_tree(state, best_loss), _save_tree,
                      str(resume_path), "resume")
        loop_ok = True
    finally:
        # always flush queued writes; if the loop itself raised, don't let a
        # writer error mask the original failure
        try:
            writer.close()
        except Exception:
            if loop_ok:
                raise
    result = {"class": class_name, "best_loss": best_loss, "history": history,
              "checkpoint": str(best_path), "steps": state.step}
    if eval_fn is not None:
        result["best_val"] = best_val
    return result
