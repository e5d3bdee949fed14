r"""UniPC: the unified predictor-corrector sampler (order 2, data
prediction).

The port of `synt_isic_tpu/diffusion/unipc.py` (Zhao et al. 2023,
arXiv:2302.04867). With alpha, sigma, lambda as in `dpm.py` and
J1(h) = h - 1 + e^{-h}, one model evaluation per step at the predicted
sample x_k first corrects the previous step (the trapezoidal rule through
the new endpoint), then predicts the next one:

    x_corr  = (sigma_k/sigma_{k-1}) x_{k-1}
              + alpha_k (1 - e^{-h_{k-1}}) [x0_{k-1} + (x0_k - x0_{k-1}) / 2]
    x_{k+1} = (sigma_{k+1}/sigma_k) x_corr
              + alpha_{k+1} [(1 - e^{-h_k}) x0_k + J1(h_k) (x0_k - x0_{k-1}) / h_{k-1}]

At k = 0 the corrector passes x_k through and the slope term is zero, as it
is at the final step (h = inf), where the update is x = x0_k. Deterministic
by construction. The float64 host tables become float32 device tables read
by the step index; the sampler threads (x_pred, x_prev, x0_prev) through
the walk, and the walk's sample is x_pred, the predictor's output.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .schedules import DiffusionSchedule, device_table, spaced_timesteps


def _j1(h: np.ndarray) -> np.ndarray:
    """J1(h) = \\int_0^h e^{u-h} u du = h - 1 + e^{-h} (elementwise)."""
    with np.errstate(over="ignore"):
        return np.where(np.isinf(h), np.inf,
                        h - 1.0 + np.exp(-np.where(np.isinf(h), 0.0, h)))


@dataclasses.dataclass(frozen=True)
class UniPCParams:
    """Per-inference-step coefficient tables, shape (S,) each; index k is
    the current step (model evaluated at timesteps[k])."""
    timesteps: torch.Tensor           # int64 (S,) — descending train-timesteps
    inv_alpha: torch.Tensor           # 1/alpha_k for the x0 prediction
    sigma: torch.Tensor               # sigma_k for the x0 prediction
    # corrector (re-integrates [lambda_{k-1}, lambda_k]; pass-through at k=0)
    c_pass: torch.Tensor              # 1 at k=0 else 0
    c_xt: torch.Tensor                # sigma_k / sigma_{k-1}
    c_d0: torch.Tensor                # alpha_k (1 - e^{-h_{k-1}})
    c_d1: torch.Tensor                # alpha_k (1 - e^{-h_{k-1}}) / 2 (trapezoid)
    # predictor (integrates [lambda_k, lambda_{k+1}])
    p_xt: torch.Tensor                # sigma_{k+1} / sigma_k   (0 at the final step)
    p_d0: torch.Tensor                # alpha_{k+1} (1 - e^{-h_k}) (1 at the final step)
    p_d1: torch.Tensor                # alpha_{k+1} J1(h_k) / h_{k-1}; 0 at k=0, S-1
    num_inference_steps: int
    stochastic: bool = False          # deterministic by construction
    clip_sample: bool = True
    clip_sample_range: float = 1.0

    @classmethod
    def create(cls, schedule: DiffusionSchedule, num_inference_steps: int,
               dtype=torch.float32, clip_sample: bool = True,
               timestep_spacing: str = "leading", device=None) -> "UniPCParams":
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
            exp_mh = np.where(np.isinf(h), 0.0,
                              np.exp(-np.where(np.isinf(h), 0.0, h)))

        p_xt = sigma_next / sigma                       # 0 at the final step
        p_d0 = alpha_next * (1.0 - exp_mh)              # 1 at the final step
        p_d1 = np.zeros(S)
        if S > 2:
            # slope from history: m = (x0_k - x0_{k-1}) / h_{k-1}
            p_d1[1:S - 1] = alpha_next[1:S - 1] * _j1(h[1:S - 1]) / h[0:S - 2]

        c_pass = np.zeros(S)
        c_pass[0] = 1.0
        c_xt = np.zeros(S)
        c_d0 = np.zeros(S)
        c_d1 = np.zeros(S)
        if S > 1:
            c_xt[1:] = sigma[1:] / sigma[:S - 1]
            c_d0[1:] = alpha[1:] * (1.0 - exp_mh[:S - 1])
            c_d1[1:] = 0.5 * c_d0[1:]

        def table(a):
            return device_table(a, device, dtype)

        return cls(
            timesteps=torch.from_numpy(ts).to(device),
            inv_alpha=table(1.0 / alpha), sigma=table(sigma),
            c_pass=table(c_pass), c_xt=table(c_xt),
            c_d0=table(c_d0), c_d1=table(c_d1),
            p_xt=table(p_xt), p_d0=table(p_d0), p_d1=table(p_d1),
            num_inference_steps=S, clip_sample=clip_sample,
        )


def unipc_step(x_pred: torch.Tensor, x_prev: torch.Tensor, x0_prev: torch.Tensor,
               eps_pred: torch.Tensor, k: int, params: UniPCParams
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One correct-then-predict update from the model evaluation at the
    predicted sample. Returns (x_pred_{k+1}, x_corr_k, x0_k), which the
    caller threads back in as the next step's (x_pred, x_prev, x0_prev). At
    k = 0 the corrector passes x_pred through, and x_prev and x0_prev take
    coefficients 0."""
    dt = x_pred.dtype
    x0 = (x_pred - params.sigma[k].to(dt) * eps_pred) * params.inv_alpha[k].to(dt)
    if params.clip_sample:
        r = params.clip_sample_range
        x0 = x0.clamp(-r, r)
    d1 = x0 - x0_prev
    x_corr = (params.c_pass[k].to(dt) * x_pred
              + params.c_xt[k].to(dt) * x_prev
              + params.c_d0[k].to(dt) * x0_prev
              + params.c_d1[k].to(dt) * d1)
    x_next = (params.p_xt[k].to(dt) * x_corr
              + params.p_d0[k].to(dt) * x0
              + params.p_d1[k].to(dt) * d1)
    return x_next, x_corr, x0
