"""Steady-state training-step timing on a CUDA device.

The port of `synt_isic_tpu/train/benchmark.py`: the flagship UNet, with
the `remat` mode asked for, at bf16 compute on f32 parameters, the hand-written
attention forward and backward kernels and the f32-statistics GroupNorm,
reference-parity TrainConfig (constant lr, no EMA); device-resident inputs
whose contents vary per step; timed after one warm-up step, on the host
clock between two `torch.cuda.synchronize()`. Then PROFILE_STEPS more
steps run under `torch.profiler`, whose device-side times give the device's
busy time per step, its idle share of the timed step and the attention
kernels' part.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Union

import torch

__all__ = ["device_seconds", "measure_train_step"]

PROFILE_STEPS = 3


def device_seconds(prof) -> tuple:
    """(all, attention) seconds of device activity in a profiler window:
    the device-side events (kernels, copies, sets), and those of the
    hand-written attention kernels."""
    from torch.autograd import DeviceType

    busy = attention = 0.0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            busy += evt.self_device_time_total * 1e-6
            if "attention_" in evt.key:
                attention += evt.self_device_time_total * 1e-6
    return busy, attention


def measure_train_step(remat_mode: Union[bool, str] = False, batch: int = 32,
                       steps: int = 30, size: int = 128,
                       device: str = "cuda", profile: bool = True) -> Dict[str, Any]:
    """Time the flagship training step with `UNet2D(remat=remat_mode)`;
    returns raw (unrounded) metrics: remat (the mode's name), sec_per_step,
    img_per_s, loss (of the last step), batch, steps, peak_bytes (the
    step's peak allocated device memory) and device (the card's name);
    from the PROFILE_STEPS steps under `torch.profiler`,
    device_busy_s_per_step, idle_share (1 - busy / sec_per_step) and
    attention_s_per_step, each None where the profiler recorded no device
    time or, with `profile=False`, did not run (a sweep of many rows skips
    its seconds of set-up and trace processing). Raises without CUDA: a
    CPU time is not this number."""
    from ..diffusion.schedules import DiffusionSchedule
    from ..model_manager import resolve_device
    from .train_ddpm import (TrainConfig, create_train_state, default_model,
                             make_train_step)

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_train_step times a CUDA device, not {dev}")
    cfg = TrainConfig(batch_size=batch, image_size=size)
    model = default_model(cfg, dev, remat=remat_mode).to(dev).train()
    state = create_train_state(model, cfg)
    step_fn = make_train_step(DiffusionSchedule.create(), cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((batch, size, size, 3), generator=gen, device=dev)

    step_fn(state, base, gen)            # first-call set-up (cuDNN, kernels)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        loss = step_fn(state, base * (1.0 + 1e-4 * i), gen)
    torch.cuda.synchronize(dev)
    sec = (time.perf_counter() - t0) / steps
    result = {"remat": model.remat, "batch": batch, "steps": steps,
              "sec_per_step": sec, "img_per_s": batch / sec, "loss": float(loss),
              "peak_bytes": torch.cuda.max_memory_allocated(dev),
              "device": torch.cuda.get_device_name(dev),
              "device_busy_s_per_step": None, "idle_share": None,
              "attention_s_per_step": None}
    if not profile:
        return result
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    with profiler(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_STEPS):
            step_fn(state, base * (1.0 - 1e-4 * (i + 1)), gen)
        torch.cuda.synchronize(dev)
    busy, attention = (s / PROFILE_STEPS for s in device_seconds(prof))
    if busy > 0:
        result.update(device_busy_s_per_step=busy, idle_share=1.0 - busy / sec,
                      attention_s_per_step=attention)
    return result
