"""Steady-state training-step timing on a CUDA device.

The port of `synt_isic_tpu/train/benchmark.py` without `remat` (not ported
yet): the flagship UNet at bf16 compute on f32 parameters, the hand-written
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
from typing import Any, Dict

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


def measure_train_step(batch: int = 32, steps: int = 30, size: int = 128,
                       device: str = "cuda") -> Dict[str, Any]:
    """Time the flagship training step; returns raw (unrounded) metrics:
    sec_per_step, img_per_s, loss (of the last step), batch, steps,
    peak_bytes (the step's peak allocated device memory) and device (the
    card's name); from the PROFILE_STEPS steps under `torch.profiler`,
    device_busy_s_per_step, idle_share (1 - busy / sec_per_step) and
    attention_s_per_step, each None where the profiler recorded no device
    time. Raises without CUDA: a CPU time is not this number."""
    from ..diffusion.schedules import DiffusionSchedule
    from ..model_manager import resolve_device
    from .train_ddpm import (TrainConfig, create_train_state, default_model,
                             make_train_step)

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"measure_train_step times a CUDA device, not {dev}")
    cfg = TrainConfig(batch_size=batch, image_size=size)
    model = default_model(cfg, dev).to(dev).train()
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
    result = {"batch": batch, "steps": steps, "sec_per_step": sec,
              "img_per_s": batch / sec, "loss": float(loss),
              "peak_bytes": torch.cuda.max_memory_allocated(dev),
              "device": torch.cuda.get_device_name(dev)}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(PROFILE_STEPS):
            step_fn(state, base * (1.0 - 1e-4 * (i + 1)), gen)
        torch.cuda.synchronize(dev)
    busy, attention = (s / PROFILE_STEPS for s in device_seconds(prof))
    seen = busy > 0
    result.update(device_busy_s_per_step=busy if seen else None,
                  idle_share=1.0 - busy / sec if seen else None,
                  attention_s_per_step=attention if seen else None)
    return result
