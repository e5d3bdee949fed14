"""Diffusion noise schedules as precomputed device tables.

The reference drives sampling through diffusers' `DDPMScheduler` configured
with `num_train_timesteps=1000, beta_schedule="squaredcos_cap_v2",
prediction_type="epsilon"` (reference `core/generator/image_generator.py:290-296`,
`core/generator/model_manager.py:196-209`, math in `README.md:64-112`).

All per-timestep scalars (betas, alphas-cumprod and the DDPM posterior
coefficients) are computed once on the host in float64, then placed on the
device as float32 tables, so a sampling step reads them by index with no
host-side scheduler math and no host sync per step.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def betas_squaredcos_cap_v2(num_train_timesteps: int = 1000, max_beta: float = 0.999) -> np.ndarray:
    """Squared-cosine (capped) beta schedule.

    beta_i = min(1 - alpha_bar((i+1)/T) / alpha_bar(i/T), max_beta) with
    alpha_bar(t) = cos^2((t + 0.008) / 1.008 * pi / 2) — the schedule the
    reference selects by name (`image_generator.py:293`).
    """
    def alpha_bar(t: float) -> float:
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = np.empty(num_train_timesteps, dtype=np.float64)
    for i in range(num_train_timesteps):
        t1 = i / num_train_timesteps
        t2 = (i + 1) / num_train_timesteps
        betas[i] = min(1.0 - alpha_bar(t2) / alpha_bar(t1), max_beta)
    return betas


def betas_linear(num_train_timesteps: int = 1000, beta_start: float = 1e-4,
                 beta_end: float = 0.02) -> np.ndarray:
    """Linear schedule (used by the legacy generator,
    reference `diffusion/diffusion_generator.py:123-128`)."""
    return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)


def leading_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """'leading' timestep spacing: t_k = round(k * T // S), descending.

    Matches the reference scheduler's `set_timesteps` (steps clamped to
    [1, 1000] upstream, `model_manager.py:204-209`): for S=50, T=1000 the
    trajectory visits t = 980, 960, ..., 20, 0.
    """
    if not 1 <= num_inference_steps <= num_train_timesteps:
        raise ValueError(
            f"num_inference_steps must be in [1, {num_train_timesteps}], got {num_inference_steps}")
    step_ratio = num_train_timesteps // num_inference_steps
    timesteps = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].copy()
    return timesteps.astype(np.int64)


def trailing_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """'trailing' timestep spacing: round(arange(T, 0, -T/S)) - 1, descending.

    Beyond-reference quality option ("Common Diffusion Noise Schedules and
    Sample Steps are Flawed", Lin et al. 2023): leading spacing never
    visits t = T-1, so at S=20 pure N(0,1) noise enters the model labeled
    t=950 — a train/sample mismatch that grows as S shrinks. Trailing
    spacing always starts at t = T-1 (for T=1000, S=20: 999, 949, ..., 49)
    and is the standard fix for few-step sampling. The reverse walk's
    "previous" alpha-bars must then come from the VISITED sequence
    (`DiffusionSchedule.alphas_cumprod_prev_from`), not a fixed stride.
    """
    if not 1 <= num_inference_steps <= num_train_timesteps:
        raise ValueError(
            f"num_inference_steps must be in [1, {num_train_timesteps}], got {num_inference_steps}")
    step = num_train_timesteps / num_inference_steps
    ts = np.round(np.arange(num_train_timesteps, 0, -step)) - 1
    return ts[:num_inference_steps].astype(np.int64)


def spaced_timesteps(num_train_timesteps: int, num_inference_steps: int,
                     spacing: str = "leading") -> np.ndarray:
    if spacing == "leading":
        return leading_timesteps(num_train_timesteps, num_inference_steps)
    if spacing == "trailing":
        return trailing_timesteps(num_train_timesteps, num_inference_steps)
    raise ValueError(f"unknown timestep_spacing: {spacing!r}")


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable schedule tables (host float64 → device float32).

    Fields are 1-D arrays of length `num_train_timesteps`.
    """
    num_train_timesteps: int
    beta_schedule: str
    betas: np.ndarray             # float64 host
    alphas: np.ndarray
    alphas_cumprod: np.ndarray
    prediction_type: str = "epsilon"

    @classmethod
    def create(cls, num_train_timesteps: int = 1000,
               beta_schedule: str = "squaredcos_cap_v2",
               prediction_type: str = "epsilon",
               beta_start: float = 1e-4, beta_end: float = 0.02) -> "DiffusionSchedule":
        if beta_schedule == "squaredcos_cap_v2":
            betas = betas_squaredcos_cap_v2(num_train_timesteps)
        elif beta_schedule == "linear":
            betas = betas_linear(num_train_timesteps, beta_start, beta_end)
        else:
            raise ValueError(f"unknown beta_schedule: {beta_schedule}")
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        return cls(num_train_timesteps=num_train_timesteps,
                   beta_schedule=beta_schedule,
                   betas=betas, alphas=alphas, alphas_cumprod=alphas_cumprod,
                   prediction_type=prediction_type)

    def alphas_cumprod_prev(self, timesteps: np.ndarray, num_inference_steps: int) -> np.ndarray:
        """alpha_bar at the previous visited timestep (1.0 past the end).

        Fixed-stride form — exact for 'leading' spacing (reference
        scheduler semantics; leading grids are always uniform because the
        stride is T//S floored). For non-uniform grids ('trailing' at
        S ∤ T) use `alphas_cumprod_prev_from`."""
        prev_t = timesteps - self.num_train_timesteps // num_inference_steps
        prev = np.where(prev_t >= 0, self.alphas_cumprod[np.clip(prev_t, 0, None)], 1.0)
        return prev

    def alphas_cumprod_prev_from(self, timesteps: np.ndarray) -> np.ndarray:
        """alpha_bar at the NEXT visited (lower) timestep of a descending
        grid; 1.0 after the last visited step (the x0 endpoint). Equals
        `alphas_cumprod_prev` on uniform grids and is correct on any grid."""
        return np.concatenate([self.alphas_cumprod[timesteps[1:]],
                               np.ones(1, dtype=self.alphas_cumprod.dtype)])

    def device_tables(self, device=None, dtype=torch.float32):
        """The full tables as device tensors (indexed by t on the device)."""
        return {
            "betas": device_table(self.betas, device, dtype),
            "alphas": device_table(self.alphas, device, dtype),
            "alphas_cumprod": device_table(self.alphas_cumprod, device, dtype),
        }


def device_table(values: np.ndarray, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """A float64 host table rounded to float32 on the host (as numpy does)
    and copied to `device` in `dtype`."""
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(
        device=device, dtype=dtype)
