"""DPM-Solver++(2M): the second-order multistep ODE sampler, and its SDE
variant.

The port of `synt_isic_tpu/diffusion/dpm.py` (Lu et al. 2022,
arXiv:2211.01095, data-prediction form). With alpha_t = sqrt(abar_t),
sigma_t = sqrt(1 - abar_t), lambda_t = log(alpha / sigma) and
h_k = lambda_{k+1} - lambda_k:

    x0_k    = clip((x_k - sigma_k eps) / alpha_k)
    D_k     = x0_k + c2_k (x0_k - x0_{k-1})            c2_k = h_k / (2 h_{k-1})
    x_{k+1} = (sigma_{k+1} / sigma_k) x_k + alpha_{k+1} (1 - e^{-h_k}) D_k

The first step (no history) and the final step (h = inf, so e^{-h} = 0 and
the update collapses to x = D) run first order (c2 = 0). The SDE variant
(`sde=True`) weighs x by an extra e^{-h}, the x0 term by 1 - e^{-2h}, and
adds sigma_{k+1} sqrt(1 - e^{-2h}) z, z ~ N(0, I).

The coefficients are float64 host maths placed on the device as float32
tables, read by the step index, as in `ddpm.py`; the sampler threads the
(x, x0_prev) pair through the walk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .schedules import DiffusionSchedule, device_table, spaced_timesteps


@dataclasses.dataclass(frozen=True)
class DPMSolverParams:
    """Per-inference-step coefficient tables, shape (S,) each."""
    timesteps: torch.Tensor           # int64 (S,) — descending train-timesteps
    inv_alpha: torch.Tensor           # 1/alpha_k for the x0 prediction
    sigma: torch.Tensor               # sigma_k for the x0 prediction
    sample_coeff: torch.Tensor        # sigma_{k+1}/sigma_k (0 at the final step)
    d_coeff: torch.Tensor             # alpha_{k+1}(1-e^{-h}) (1 at the final step)
    c2: torch.Tensor                  # h_k/(2 h_{k-1}); 0 at k=0 and k=S-1
    noise_coeff: torch.Tensor         # sigma_{k+1} sqrt(1-e^{-2h}); zeros (ODE)
    num_inference_steps: int
    stochastic: bool                  # the SDE draws step noise, known on the host
    clip_sample: bool = True
    clip_sample_range: float = 1.0
    sde: bool = False

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_inference_steps: int,
               dtype=torch.float32, clip_sample: bool = True,
               timestep_spacing: str = "leading", sde: bool = False,
               device=None) -> "DPMSolverParams":
        S = num_inference_steps
        ts = spaced_timesteps(schedule.num_train_timesteps, S, timestep_spacing)
        ab_t = schedule.alphas_cumprod[ts]
        ab_next = (schedule.alphas_cumprod_prev(ts, S)   # 1.0 past the end
                   if timestep_spacing == "leading"
                   else schedule.alphas_cumprod_prev_from(ts))

        alpha = np.sqrt(ab_t)
        sigma = np.sqrt(1.0 - ab_t)
        alpha_next = np.sqrt(ab_next)
        sigma_next = np.sqrt(1.0 - ab_next)            # exactly 0 at the final step

        with np.errstate(divide="ignore"):
            lam = np.log(alpha / sigma)
            lam_next = np.log(alpha_next / np.where(sigma_next > 0, sigma_next, 1.0))
            lam_next = np.where(sigma_next > 0, lam_next, np.inf)
        h = lam_next - lam                              # > 0; inf at the final step

        with np.errstate(over="ignore"):
            exp_mh = np.where(np.isinf(h), 0.0, np.exp(-np.where(np.isinf(h), 0.0, h)))
        if sde:
            exp_m2h = exp_mh * exp_mh
            sample_coeff = (sigma_next / sigma) * exp_mh      # 0 at the final step
            d_coeff = alpha_next * (1.0 - exp_m2h)
            noise_coeff = sigma_next * np.sqrt(1.0 - exp_m2h)  # 0 at the final step
        else:
            sample_coeff = sigma_next / sigma                # 0 at the final step
            d_coeff = alpha_next * (1.0 - exp_mh)
            noise_coeff = np.zeros(S)

        # c2[0] = 0 (no history yet); c2[S-1] = 0 (lower-order final, h = inf)
        c2 = np.zeros(S)
        if S > 2:
            c2[1:S - 1] = h[1:S - 1] / (2.0 * h[0:S - 2])

        return cls(
            timesteps=torch.from_numpy(ts).to(device),
            inv_alpha=device_table(1.0 / alpha, device, dtype),
            sigma=device_table(sigma, device, dtype),
            sample_coeff=device_table(sample_coeff, device, dtype),
            d_coeff=device_table(d_coeff, device, dtype),
            c2=device_table(c2, device, dtype),
            noise_coeff=device_table(noise_coeff, device, dtype),
            num_inference_steps=S,
            stochastic=bool(sde),
            clip_sample=clip_sample,
            sde=bool(sde),
        )


def dpm_solver_step(x: torch.Tensor, x0_prev: torch.Tensor, eps_pred: torch.Tensor,
                    k: int, params: DPMSolverParams,
                    noise: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One multistep update. Returns (x_{k+1}, x0_k); the caller threads
    x0_k back in as the next step's x0_prev (ignored at k = 0, where
    c2 = 0). `noise` is the SDE's standard normal of x's shape; the ODE
    ignores it, and None runs the SDE's mean path."""
    dt = x.dtype
    c_inv = params.inv_alpha[k].to(dt)
    c_sig = params.sigma[k].to(dt)
    c_xt = params.sample_coeff[k].to(dt)
    c_d = params.d_coeff[k].to(dt)
    c2 = params.c2[k].to(dt)

    x0 = (x - c_sig * eps_pred) * c_inv
    if params.clip_sample:
        r = params.clip_sample_range
        x0 = x0.clamp(-r, r)
    d = x0 + c2 * (x0 - x0_prev)
    x_next = c_xt * x + c_d * d
    if params.sde and noise is not None:
        x_next = x_next + params.noise_coeff[k].to(dt) * noise
    return x_next, x0
