"""Progressive distillation: halve sampling steps while keeping quality.

The port of `synt_isic_tpu/train/distill.py` (Salimans & Ho, "Progressive
Distillation for Fast Sampling of Diffusion Models", ICLR 2022): a student
is trained so that ONE of its DDIM steps reproduces TWO teacher DDIM steps,
then the step count halves phase by phase (N -> N/2 -> N/4 ...). Every
phase writes `unet_<CLASS>_distill<N>.pth`, an epsilon-predicting UNet2D
with the diffusers keys, which `ModelManager(variant="distill<N>")` loads
and the DDIM sampler runs at N steps on the phase's timestep spacing.

The algebra is the JAX package's: for a student DDIM step t -> t'' the
target x0 is the one for which the student's step lands exactly on the
teacher's two-step endpoint z'':

    eps_implied = (z_t - a_t * x0) / s_t            (DDIM inversion)
    z''         = a'' * x0 + s'' * eps_implied
    =>  x0_target = (z'' - (s''/s_t) z_t) / (a'' - (s''/s_t) a_t)

with a = sqrt(alpha_bar), s = sqrt(1 - alpha_bar), and the loss is the
truncated-SNR weighted x0 error max(SNR(t), snr_floor) * |x0 - target|^2.

What differs from the JAX distiller, and why:
  * PyTorch runs eagerly: one step is one call of the function
    `make_distill_step` returns, on a student `nn.Module` updated in place;
    the JAX `make_distill_scan` (a block of steps as one compiled program)
    has no counterpart. Losses stay on the device and are read once per
    block of batches;
  * the teacher is a second module holding the teacher's f32 weights, run
    under `torch.no_grad()` (the JAX `stop_gradient` on the target): on
    CUDA its two forwards launch the attention forward kernel without the
    log-sum-exp, and the student's forward and backward the trainable pair
    (`FusedAttention`);
  * random numbers come from a `torch.Generator` seeded from
    `config.seed + n_student`, not from threefry keys; the loss takes
    injected `k` (student step indices) and `eps` so a test can feed it the
    JAX draws. Batches are drawn as the JAX loop draws them, from
    `np.random.default_rng(config.seed + n_student)`;
  * the global-norm clip is optax's rule: the gradients are scaled by
    max_norm / norm only when norm >= max_norm, with no epsilon;
  * `history` holds every step's loss (the JAX scan path keeps one mean
    per block), and the log prints one line per block of batches;
  * data parallelism (`mesh`, reference `distill.py:265, 427, 477`) follows
    the trainer's scheme (`train_ddpm.py`): k and eps are drawn for the
    global batch, then split; each shard runs the teacher's two forwards
    and the student's forward and backward on its device's replicas; the
    gradients are summed (and `all_reduce`d across processes) before the
    clip, Adam and the EMA. Across processes checkpoints go through
    `host0_only`. A ('data', 'model') mesh runs over its 'data' axis, the
    state replicated over 'model', as in the trainer.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..diffusion.schedules import DiffusionSchedule, spaced_timesteps
from ..io.pth import save_checkpoint
from ..model_manager import resolve_device
from ..models.unet2d import UNet2D
from ..parallel import multihost
from ..parallel.replicas import Replicas
from .train_ddpm import (TrainConfig, TrainState, _epoch_batches, _nchw, apply_gradients,
                         apply_sharded_gradients, checkpoint_writer, create_train_state,
                         default_model, global_rows, local_rows, shard_spans)


@dataclasses.dataclass(frozen=True)
class DistillConfig:
    """The JAX `DistillConfig`, field for field (see its comments for each
    option's rationale)."""
    num_train_timesteps: int = 1000
    # spacing of the student's inference grid
    timestep_spacing: str = "trailing"
    batch_size: int = 32
    steps_per_phase: int = 2000
    learning_rate: float = 5e-5
    warmup_steps: int = 100
    # cosine decay to lr_end_factor * lr across the phase
    lr_end_factor: float = 0.1
    ema_decay: float = 0.999          # student EMA; 0 = export raw params
    snr_floor: float = 1.0            # truncated-SNR weight max(SNR, floor)
    grad_clip: float = 1.0            # global-norm gradient clip (0 = off)
    clip_teacher_x0: bool = False     # clip pred_x0 in teacher substeps
    # best-export selection on a fixed probe every eval_every steps (0 = off:
    # export the final EMA/raw params)
    eval_every: int = 0
    eval_probe_images: int = 16
    eval_keys: int = 4
    bf16_compute: bool = True
    seed: int = 0


def phase_tables(schedule: DiffusionSchedule, n_student: int,
                 spacing: str = "trailing") -> Dict[str, np.ndarray]:
    """Per-student-step coefficient tables for one distillation phase.

    Returns float64 host arrays of length n_student:
      ts      — student timesteps (the sampler's own grid at n_student)
      t_mid   — teacher midpoint timestep for each student step
      a_t,s_t — sqrt(ab), sqrt(1-ab) at ts
      a_m,s_m — at t_mid
      a_p,s_p — at the student step's destination (1, 0 past the end)
      denom   — a_p - (s_p/s_t) * a_t  (single-step inversion denominator)
      snr     — alpha_bar/(1-alpha_bar) at ts
    """
    ts = spaced_timesteps(schedule.num_train_timesteps, n_student, spacing)
    ab = schedule.alphas_cumprod
    ab_t = ab[ts]
    if spacing == "leading":
        ab_p = schedule.alphas_cumprod_prev(ts, n_student)
        stride = schedule.num_train_timesteps // n_student
        t_prev = ts - stride
    else:
        ab_p = schedule.alphas_cumprod_prev_from(ts)
        t_prev = np.concatenate([ts[1:], np.asarray([-1], ts.dtype)])
    # midpoint on the training-timestep axis; destination -1 (the clean
    # endpoint) midpoints to t//2
    t_mid = (ts + np.maximum(t_prev, -1)) // 2
    t_mid = np.clip(t_mid, 0, schedule.num_train_timesteps - 1)
    ab_m = ab[t_mid]
    a_t, s_t = np.sqrt(ab_t), np.sqrt(1.0 - ab_t)
    a_m, s_m = np.sqrt(ab_m), np.sqrt(1.0 - ab_m)
    a_p, s_p = np.sqrt(ab_p), np.sqrt(np.clip(1.0 - ab_p, 0.0, None))
    denom = a_p - (s_p / s_t) * a_t
    if np.any(denom <= 0):
        raise ValueError("non-increasing SNR along the student grid")
    return {
        "ts": ts.astype(np.int32), "t_mid": t_mid.astype(np.int32),
        "a_t": a_t, "s_t": s_t, "a_m": a_m, "s_m": s_m,
        "a_p": a_p, "s_p": s_p, "denom": denom,
        "snr": ab_t / (1.0 - ab_t),
    }


def implied_x0(z_t, z_end, a_t, s_t, a_p, s_p, denom=None):
    """The x0 for which one DDIM step from (z_t, t) lands exactly on z_end
    (tensors or numpy arrays alike)."""
    ratio = s_p / s_t
    if denom is None:
        denom = a_p - ratio * a_t
    return (z_end - ratio * z_t) / denom


def make_distill_loss(schedule: DiffusionSchedule, config: DistillConfig,
                      n_student: int) -> Callable:
    """The phase's distillation objective:
    loss(student, teacher, batch, generator=None, *, k=None, eps=None,
    params=None) -> 0-d f32 tensor on the batch's device.

    `student` and `teacher` are UNet2D modules; `batch` is NHWC x0 images.
    `k` ((B,) student step indices in [0, n_student)) and `eps` (the
    batch's shape) are drawn from `generator` unless given. `params` (a
    state dict, e.g. the EMA) runs through the student's graph in place of
    its own weights. The teacher's two DDIM substeps run without a
    gradient."""
    tab = phase_tables(schedule, n_student, config.timestep_spacing)
    cols = ("a_t", "s_t", "a_m", "s_m", "a_p", "s_p", "denom", "snr")
    tables: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def device_tables(dev: torch.device) -> Dict[str, torch.Tensor]:
        if dev not in tables:
            tables[dev] = {name: torch.as_tensor(tab[name], dtype=torch.float32,
                                                 device=dev) for name in cols}
            for name in ("ts", "t_mid"):
                tables[dev][name] = torch.as_tensor(tab[name], dtype=torch.int64,
                                                    device=dev)
        return tables[dev]

    def row_losses(student: UNet2D, teacher: UNet2D, batch: torch.Tensor,
                   k: torch.Tensor, eps: torch.Tensor,
                   params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        """(B,) weighted x0 errors of the batch's rows, on its device."""
        dev = batch.device
        tb = device_tables(dev)
        b = batch.shape[0]
        k = k.to(dev).long()
        x0, eps = _nchw(batch.float()), _nchw(eps.to(dev, torch.float32))

        def col(name: str) -> torch.Tensor:
            return tb[name][k].reshape(b, 1, 1, 1)

        at, st, am, sm, ap, sp = (col(n) for n in ("a_t", "s_t", "a_m", "s_m", "a_p", "s_p"))
        ts, t_mid = tb["ts"][k], tb["t_mid"][k]
        z = at * x0 + st * eps
        with torch.no_grad():
            # teacher: two deterministic DDIM substeps t -> t_mid -> t''
            e1 = teacher(z, ts).float()
            x0_1 = (z - st * e1) / at
            if config.clip_teacher_x0:
                x0_1 = x0_1.clamp(-1.0, 1.0)
            z_mid = am * x0_1 + sm * e1
            e2 = teacher(z_mid, t_mid).float()
            x0_2 = (z_mid - sm * e2) / am
            if config.clip_teacher_x0:
                x0_2 = x0_2.clamp(-1.0, 1.0)
            z_end = ap * x0_2 + sp * e2
            x0_target = implied_x0(z, z_end, at, st, ap, sp, denom=col("denom"))

        e_s = (student(z, ts) if params is None
               else torch.func.functional_call(student, dict(params), (z, ts))).float()
        x0_s = (z - st * e_s) / at
        w = torch.clamp(tb["snr"][k], min=config.snr_floor)
        per_img = torch.mean((x0_s - x0_target) ** 2, dim=(1, 2, 3))
        return w * per_img

    def loss_fn(student: UNet2D, teacher: UNet2D, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None, *,
                k: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                params: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
        dev = batch.device
        b = batch.shape[0]
        if k is None:
            k = torch.randint(0, n_student, (b,), generator=generator, device=dev)
        if eps is None:
            eps = torch.randn(batch.shape, generator=generator, device=dev)
        return torch.mean(row_losses(student, teacher, batch, k, eps, params))

    loss_fn.row_losses = row_losses
    return loss_fn


def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the gradients, in place: scaled by
    max_norm / norm when the global f32 norm >= max_norm, else untouched (no
    epsilon; `torch.nn.utils.clip_grad_norm_` divides by norm + 1e-6).
    Returns the norm, without a host synchronisation."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in grads])))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))
    return norm


def create_distill_state(student: UNet2D, config: DistillConfig, mesh=None) -> TrainState:
    """The trainer's state over the student (`create_train_state`): Adam
    (optax's defaults) at the phase's warmup-cosine lr, the EMA as an f32
    copy of the weights when `ema_decay` > 0, and with a mesh the
    student's replicas."""
    return create_train_state(student, TrainConfig(
        learning_rate=config.learning_rate, lr_schedule="cosine",
        warmup_steps=config.warmup_steps, lr_end_factor=config.lr_end_factor,
        ema_decay=config.ema_decay), total_steps=config.steps_per_phase, mesh=mesh)


def make_distill_step(schedule: DiffusionSchedule, config: DistillConfig,
                      n_student: int) -> Callable:
    """One eager distillation step: (state, teacher, batch, generator=None,
    *, k=None, eps=None) -> loss, a 0-d f32 tensor on the device (no host
    sync). The student in `state` takes the gradient (clipped by global norm
    when `grad_clip` > 0), an Adam step at the schedule's lr, and the EMA
    update; the teacher is read only.

    With a data-parallel state (`create_distill_state(mesh=)`), `teacher` is
    the teacher's `Replicas` over the same mesh, and `k` and `eps` (drawn
    or given) are the global batch's; each shard's rows run on its device
    and the reduced gradients take one update."""
    loss_fn = make_distill_loss(schedule, config, n_student)
    clip = (functools.partial(clip_by_global_norm_, max_norm=config.grad_clip)
            if config.grad_clip > 0 else None)

    def step(state: TrainState, teacher, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None, *,
             k: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        if state.replicas is None:
            loss = loss_fn(state.model, teacher, batch, generator, k=k, eps=eps)
            return apply_gradients(state, loss, config.ema_decay, clip)
        dev = batch.device
        b, lo, hi = global_rows(state, batch.shape[0])
        if k is None:
            k = torch.randint(0, n_student, (b,), generator=generator, device=dev)
        if eps is None:
            eps = torch.randn((b,) + tuple(batch.shape[1:]), generator=generator, device=dev)
        k, eps = k.to(dev)[lo:hi], eps.to(dev)[lo:hi]

        def shard_losses():
            for d, a, z in shard_spans(state, batch.shape[0]):
                yield loss_fn.row_losses(state.replicas[d], teacher[d], batch[a:z].to(d),
                                         k[a:z], eps[a:z]).sum() / b

        return apply_sharded_gradients(state, shard_losses(), config.ema_decay, clip)

    return step


def _probe(dataset, config: DistillConfig, n_student: int,
           device: torch.device) -> torch.Tensor:
    """The fixed eval probe: the first `eval_probe_images` drawn from a
    dedicated rng, as the JAX distiller draws them."""
    probe_rng = np.random.default_rng(config.seed + n_student + 1)
    chunks, have = [], 0
    for b in dataset.batches(min(config.eval_probe_images, config.batch_size), probe_rng):
        chunks.append(torch.as_tensor(b).to(device, torch.float32))
        have += len(chunks[-1])
        if have >= config.eval_probe_images:
            break
    return torch.cat(chunks)[:config.eval_probe_images]


def distill_phase(model: UNet2D, schedule: DiffusionSchedule,
                  teacher_params: Mapping[str, torch.Tensor], dataset, n_student: int,
                  config: DistillConfig = DistillConfig(),
                  mesh=None,
                  log=print,
                  teacher: Optional[UNet2D] = None) -> Dict[str, Any]:
    """One halving phase: train a student (init = teacher) whose n_student
    DDIM steps match the teacher's 2x-step trajectories. Returns
    {'params': export params (EMA when enabled, or the best snapshot with
    `eval_every`), 'history': per-step losses, 'n_student'}.

    `model` is the student module (its weights are overwritten with
    `teacher_params`, a state dict) on the phase's device; `teacher` the
    module that holds the teacher's weights (a copy of `model` unless
    given). `mesh`: data-parallel over its 'data' axis; `batch_size` is the
    global batch and must divide by its size."""
    if mesh is not None:
        mesh.shard_devices("data")   # a mesh without a 'data' axis raises
    if mesh is not None and config.batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {config.batch_size} must be a multiple of the mesh data "
            f"axis size ({mesh.shape['data']}) for dp distill")
    if len(dataset) < config.batch_size:
        # both phase loops draw full batches; an undersized dataset would
        # yield zero batches and the while-loop would spin forever
        raise ValueError(
            f"dataset has {len(dataset)} images < batch_size "
            f"{config.batch_size} — shrink batch_size or grow the dataset")
    device = next(model.parameters()).device
    with torch.no_grad():
        model.load_state_dict(teacher_params, strict=True)
        teacher = teacher if teacher is not None else copy.deepcopy(model)
        teacher.load_state_dict(teacher_params, strict=True)
    teacher.requires_grad_(False)
    model.requires_grad_(True)
    state = create_distill_state(model, config, mesh)
    # the teacher's replicas, made once its weights are in
    teachers = Replicas(teacher, mesh) if mesh is not None else teacher
    rows = (multihost.local_batch_bounds(config.batch_size)
            if mesh is not None and mesh.processes > 1 else None)
    step_fn = make_distill_step(schedule, config, n_student)
    generator = torch.Generator(device=device).manual_seed(config.seed + n_student)
    data_rng = np.random.default_rng(config.seed + n_student)
    history: List[float] = []
    done = 0

    # deterministic held-out best-export selection (see DistillConfig)
    eval_fn = None
    val_history: List[float] = []
    best_val = float("inf")
    best_snapshot = None
    last_eval_at = 0
    if config.eval_every > 0:
        probe = _probe(dataset, config, n_student, device)
        loss_probe = make_distill_loss(schedule, config, n_student)
        eval_seeds = [config.seed + 0xD15 + i for i in range(config.eval_keys)]

        @torch.no_grad()
        def eval_fn(export_params) -> float:
            losses = [loss_probe(model, teacher, probe,
                                 torch.Generator(device=device).manual_seed(s),
                                 params=export_params) for s in eval_seeds]
            return float(torch.stack(losses).mean())

    def maybe_eval() -> None:
        """Score the export params and keep the best snapshot."""
        nonlocal best_val, best_snapshot, last_eval_at
        if eval_fn is None:
            return
        if (done - last_eval_at < config.eval_every
                and done < config.steps_per_phase):
            return
        last_eval_at = done
        export = state.export_params()
        val = eval_fn(export)
        val_history.append(val)
        if val < best_val:
            best_val = val
            best_snapshot = {k: v.detach().clone() for k, v in export.items()}

    while done < config.steps_per_phase:
        t0 = time.time()
        losses = []
        for batch in _epoch_batches(dataset, config.batch_size, data_rng, device):
            losses.append(step_fn(state, teachers, local_rows(batch, rows), generator))
            done += 1
            maybe_eval()
            if done >= config.steps_per_phase:
                break
        block = torch.stack(losses).tolist()
        history.extend(block)
        log(f"[distill:{n_student}] step {done}/{config.steps_per_phase} "
            f"loss={sum(block) / len(block):.5f} ({time.time() - t0:.1f}s)")
    export = state.export_params()
    result = {"params": best_snapshot if best_snapshot is not None else export,
              "history": history, "n_student": n_student}
    if eval_fn is not None:
        result["val_history"] = val_history
        result["best_val"] = best_val
    return result


def progressive_distill(teacher_params: Mapping[str, torch.Tensor], dataset,
                        class_name: str, checkpoint_dir: str, start_steps: int,
                        end_steps: int = 4,
                        config: DistillConfig = DistillConfig(),
                        model: Optional[UNet2D] = None,
                        image_size: int = 128,
                        mesh=None,
                        log=print,
                        device=None) -> Dict[str, Any]:
    """Full halving ladder: start_steps -> start/2 -> ... -> end_steps.

    Each phase's student becomes the next phase's teacher. Every phase
    writes `unet_<CLASS>_distill<N>.pth` (diffusers keys, f32), through the
    async writer so the write overlaps the next phase; sample it with
    num_inference_steps=N and the config's timestep_spacing.

    `teacher_params` is a UNet2D state dict; `model` the student module
    (default: the trainer's `default_model` at `image_size`, bf16 compute
    unless `bf16_compute` is off, the kernels on CUDA). `device`: CUDA
    unless the caller names another."""
    if start_steps % 2 or start_steps < 2:
        raise ValueError("start_steps must be even and >= 2")
    if start_steps // 2 < end_steps:
        raise ValueError(
            f"start_steps {start_steps} halves to {start_steps // 2} < "
            f"end_steps {end_steps} — no phase would run (start_steps must "
            f"be at least 2 x end_steps)")
    device = resolve_device(device)
    model = (model or default_model(TrainConfig(image_size=image_size,
                                                bf16_compute=config.bf16_compute,
                                                seed=config.seed), device)).to(device).train()
    teacher = copy.deepcopy(model).requires_grad_(False)
    schedule = DiffusionSchedule.create(config.num_train_timesteps)
    ckpt_dir = Path(checkpoint_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # across processes, process 0 writes each phase (host0_only)
    writer = checkpoint_writer(mesh is not None and mesh.processes > 1, log)
    phases = []
    n = start_steps // 2
    teacher_params = {k: v.to(device, torch.float32) for k, v in teacher_params.items()}
    loop_ok = False
    try:
        while n >= end_steps:
            t0 = time.time()
            result = distill_phase(model, schedule, teacher_params, dataset, n,
                                   config, mesh=mesh, log=log, teacher=teacher)
            path = ckpt_dir / f"unet_{class_name}_distill{n}.pth"
            writer.submit(result["params"], save_checkpoint, str(path))
            log(f"[distill:{n}] phase done in {time.time() - t0:.1f}s -> {path}")
            record = {"n_student": n, "checkpoint": str(path),
                      "final_loss": result["history"][-1]}
            if "best_val" in result:
                record["best_val"] = result["best_val"]
            phases.append(record)
            # the next phase loads these into both modules before its first
            # step changes the student, so no copy is needed
            teacher_params = result["params"]
            if n == end_steps:
                break
            n = max(n // 2, end_steps)
        loop_ok = True
    finally:
        # flush queued writes; don't let a writer error mask a phase error
        try:
            writer.close()
        except Exception:
            if loop_ok:
                raise
    return {"class": class_name, "phases": phases,
            "timestep_spacing": config.timestep_spacing}
