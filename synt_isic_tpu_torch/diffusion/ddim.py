"""DDIM update — the accelerated-stride sampler variant.

The standard DDIM update with optional eta-noise, sharing the
precomputed-table design of `ddpm.py`: float64 host math, float32 tables on
the device, one table read per coefficient per step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .schedules import DiffusionSchedule, device_table, spaced_timesteps


@dataclasses.dataclass(frozen=True)
class DDIMParams:
    timesteps: torch.Tensor         # int64 (S,) — descending train-timesteps
    inv_sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor
    dir_coeff: torch.Tensor         # sqrt(1 - ab_prev - sigma^2)
    sigma: torch.Tensor             # eta-scaled stochasticity (0 => deterministic)
    num_inference_steps: int
    stochastic: bool                # any sigma > 0, known on the host
    clip_sample: bool = True
    clip_sample_range: float = 1.0

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_inference_steps: int,
               eta: float = 0.0, dtype=torch.float32, clip_sample: bool = True,
               timestep_spacing: str = "leading", device=None) -> "DDIMParams":
        ts = spaced_timesteps(schedule.num_train_timesteps, num_inference_steps,
                              timestep_spacing)
        ab_t = schedule.alphas_cumprod[ts]
        ab_prev = (schedule.alphas_cumprod_prev(ts, num_inference_steps)
                   if timestep_spacing == "leading"
                   else schedule.alphas_cumprod_prev_from(ts))
        variance = (1.0 - ab_prev) / (1.0 - ab_t) * (1.0 - ab_t / ab_prev)
        sigma = eta * np.sqrt(np.clip(variance, 0.0, None))
        sigma = np.where(ts > 0, sigma, 0.0)
        dir_coeff = np.sqrt(np.clip(1.0 - ab_prev - sigma ** 2, 0.0, None))
        return cls(
            timesteps=torch.from_numpy(ts).to(device),
            inv_sqrt_alphas_cumprod=device_table(1.0 / np.sqrt(ab_t), device, dtype),
            sqrt_one_minus_alphas_cumprod=device_table(np.sqrt(1.0 - ab_t), device, dtype),
            sqrt_alphas_cumprod_prev=device_table(np.sqrt(ab_prev), device, dtype),
            dir_coeff=device_table(dir_coeff, device, dtype),
            sigma=device_table(sigma, device, dtype),
            num_inference_steps=num_inference_steps,
            stochastic=bool(np.any(sigma > 0)),
            clip_sample=clip_sample,
        )


def ddim_step(x: torch.Tensor, eps_pred: torch.Tensor, k: int,
              params: DDIMParams, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    dt = x.dtype
    c_inv = params.inv_sqrt_alphas_cumprod[k].to(dt)
    c_eps = params.sqrt_one_minus_alphas_cumprod[k].to(dt)
    c_prev = params.sqrt_alphas_cumprod_prev[k].to(dt)
    c_dir = params.dir_coeff[k].to(dt)

    pred_x0 = (x - c_eps * eps_pred) * c_inv
    if params.clip_sample:
        r = params.clip_sample_range
        pred_x0 = pred_x0.clamp(-r, r)
    x_prev = c_prev * pred_x0 + c_dir * eps_pred
    if noise is not None:
        x_prev = x_prev + params.sigma[k].to(dt) * noise
    return x_prev
