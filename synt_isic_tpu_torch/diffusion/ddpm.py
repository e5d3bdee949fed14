"""DDPM reverse-process update from precomputed coefficient tables.

Semantics match diffusers' `DDPMScheduler.step` with the reference config
(`variance_type="fixed_small"`, `clip_sample=True`, epsilon prediction,
'leading' timestep spacing), as the JAX package's `diffusion/ddpm.py`
transcribes it: float64 host tables cast to float32 device tables, so one
step is
    x0   = clip((x - c_eps[k] * eps) * c_inv[k], -1, 1)
    x'   = c_x0[k] * x0 + c_xt[k] * x + c_std[k] * z
with the coefficients read on the device by the step index.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .schedules import DiffusionSchedule, device_table, spaced_timesteps


@dataclasses.dataclass(frozen=True)
class DDPMParams:
    """Per-inference-step coefficient tables, shape (S,) each."""
    timesteps: torch.Tensor         # int64 (S,) — descending train-timesteps
    inv_sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    pred_original_coeff: torch.Tensor
    current_sample_coeff: torch.Tensor
    posterior_std: torch.Tensor     # 0 at the final (t==0) step
    num_inference_steps: int
    stochastic: bool                # any posterior_std > 0, known on the host
    clip_sample: bool = True
    clip_sample_range: float = 1.0

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_inference_steps: int,
               dtype=torch.float32, clip_sample: bool = True,
               timestep_spacing: str = "leading", device=None) -> "DDPMParams":
        ts = spaced_timesteps(schedule.num_train_timesteps, num_inference_steps,
                              timestep_spacing)
        ab_t = schedule.alphas_cumprod[ts]
        ab_prev = (schedule.alphas_cumprod_prev(ts, num_inference_steps)
                   if timestep_spacing == "leading"
                   else schedule.alphas_cumprod_prev_from(ts))
        alpha_cur = ab_t / ab_prev
        beta_cur = 1.0 - alpha_cur
        beta_prod_t = 1.0 - ab_t
        beta_prod_prev = 1.0 - ab_prev

        pred_original_coeff = np.sqrt(ab_prev) * beta_cur / beta_prod_t
        current_sample_coeff = np.sqrt(alpha_cur) * beta_prod_prev / beta_prod_t
        # fixed_small posterior variance, clamped like the reference scheduler
        variance = np.clip(beta_prod_prev / beta_prod_t * beta_cur, 1e-20, None)
        std = np.sqrt(variance)
        std = np.where(ts > 0, std, 0.0)  # no noise at the final step

        return cls(
            timesteps=torch.from_numpy(ts).to(device),
            inv_sqrt_alphas_cumprod=device_table(1.0 / np.sqrt(ab_t), device, dtype),
            sqrt_one_minus_alphas_cumprod=device_table(np.sqrt(beta_prod_t), device, dtype),
            pred_original_coeff=device_table(pred_original_coeff, device, dtype),
            current_sample_coeff=device_table(current_sample_coeff, device, dtype),
            posterior_std=device_table(std, device, dtype),
            num_inference_steps=num_inference_steps,
            stochastic=bool(np.any(std > 0)),
            clip_sample=clip_sample,
        )


def ddpm_step(x: torch.Tensor, eps_pred: torch.Tensor, k: int,
              params: DDPMParams, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One reverse step x_{t_k} -> x_{t_{k+1}} (k is the step index 0..S-1).

    `noise` must be standard normal of x's shape (ignored automatically at
    the final step where posterior_std == 0).
    """
    dt = x.dtype
    c_inv = params.inv_sqrt_alphas_cumprod[k].to(dt)
    c_eps = params.sqrt_one_minus_alphas_cumprod[k].to(dt)
    c_x0 = params.pred_original_coeff[k].to(dt)
    c_xt = params.current_sample_coeff[k].to(dt)

    pred_x0 = (x - c_eps * eps_pred) * c_inv
    if params.clip_sample:
        r = params.clip_sample_range
        pred_x0 = pred_x0.clamp(-r, r)
    x_prev = c_x0 * pred_x0 + c_xt * x
    if noise is not None:
        x_prev = x_prev + params.posterior_std[k].to(dt) * noise
    return x_prev


def add_noise(schedule: DiffusionSchedule, sample: torch.Tensor,
              noise: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
    """Forward process q(x_t | x_0)."""
    ab = device_table(schedule.alphas_cumprod, sample.device,
                      sample.dtype)[timesteps]
    shape = (-1,) + (1,) * (sample.dim() - 1)
    return ab.sqrt().reshape(shape) * sample + (1.0 - ab).sqrt().reshape(shape) * noise
