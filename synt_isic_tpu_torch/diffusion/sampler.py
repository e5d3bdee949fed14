"""DDPM/DDIM sampler: the reverse walk as a loop of device work.

The port of `synt_isic_tpu/diffusion/sampler.py` for the single-state
schedulers (`ddpm`, `ddim`). The JAX sampler compiles the walk into one
`lax.scan`; here it is a Python loop over steps whose timesteps and
coefficients are device tables read by index, so the loop issues work to
the device and never waits for it (no `.item()`, no host sync per step).

Seed contract, kept in shape (PyTorch cannot reproduce JAX's threefry
bits, so the numbers differ from the JAX package's for the same seed):
  * one independent stream per image seed: the initial noise of an image
    comes from a `torch.Generator` seeded with its seed alone;
  * step-k noise is a pure function of (seed, k): a generator seeded from
    `np.random.SeedSequence([seed, k + 1])`;
  * so no image depends on which other images share its batch;
  * `noise_hash` is the SHA-256 of an image's initial noise as f32 NHWC
    bytes, recorded in sidecars.

Public tensors are NHWC, as in the JAX package; the model is called NCHW.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from .ddim import DDIMParams, ddim_step
from .ddpm import DDPMParams, ddpm_step
from .schedules import DiffusionSchedule


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 50
    scheduler: str = "ddpm"   # ddpm | ddim
    ddim_eta: float = 0.0
    image_size: int = 128
    channels: int = 3
    dtype: torch.dtype = torch.float32   # compute dtype of the walk
    clip_sample: bool = True
    deterministic_posterior: bool = False  # skip the posterior noise
                                           # (golden tests / mean-path mode)
    # 'leading' = reference scheduler parity; 'trailing' always visits t = T-1
    timestep_spacing: str = "leading"

    def __post_init__(self):
        if self.scheduler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown scheduler: {self.scheduler}")
        if self.timestep_spacing not in ("leading", "trailing"):
            raise ValueError(f"unknown timestep_spacing: {self.timestep_spacing!r}")


def save_indices(num_steps: int, save_every: int,
                 timesteps: Optional[np.ndarray] = None,
                 num_train_timesteps: Optional[int] = None) -> List[int]:
    """Frame indices a captured trajectory keeps.

    Normal mode: every `save_every`-th step index plus always the last.
    Absolute-t mode (save_every >= num_steps): indices whose train-timestep
    is closest to each multiple of save_every, plus t=0 and t_max, the walk
    bounded by the schedule's horizon (else the largest timestep present).
    """
    idx = set(range(0, num_steps, save_every))
    idx.add(num_steps - 1)
    if save_every >= num_steps and timesteps is not None:
        t_list = [int(t) for t in timesteps]
        horizon = int(num_train_timesteps) if num_train_timesteps else max(t_list)
        desired = {0, max(t_list)}
        k = 0
        while k <= horizon:
            desired.add(k)
            k += max(1, int(save_every))
        for dt in desired:
            idx.add(min(range(len(t_list)), key=lambda i: abs(t_list[i] - dt)))
    return sorted(idx)


def noise_hash(noise: np.ndarray) -> str:
    """SHA-256 (first 16 hex chars) of the initial noise as f32 bytes."""
    return hashlib.sha256(np.ascontiguousarray(noise, dtype=np.float32).tobytes()).hexdigest()[:16]


def _step_seed(seed: int, k: int) -> int:
    """The generator seed of image `seed`'s noise at step `k`."""
    return int(np.random.SeedSequence([int(seed), k + 1]).generate_state(1, np.uint64)[0])


class DiffusionSampler:
    """The reverse walk for one (schedule, config) on one device.

    `sample(model, seeds)` calls `model(x_nchw, t_batch) -> eps` once per
    step; any `nn.Module` with that contract will do (the port's `UNet2D`).
    """

    def __init__(self, schedule: DiffusionSchedule,
                 config: SamplerConfig = SamplerConfig(),
                 device: Union[str, torch.device] = "cuda"):
        self.schedule = schedule
        self.config = config
        self.device = torch.device(device)
        if config.scheduler == "ddpm":
            self.params = DDPMParams.create(
                schedule, config.num_inference_steps,
                clip_sample=config.clip_sample,
                timestep_spacing=config.timestep_spacing, device=self.device)
            self._step = ddpm_step
        else:
            self.params = DDIMParams.create(
                schedule, config.num_inference_steps, eta=config.ddim_eta,
                clip_sample=config.clip_sample,
                timestep_spacing=config.timestep_spacing, device=self.device)
            self._step = ddim_step
        self.timesteps = self.params.timesteps.cpu().numpy()

    # -- seed plumbing ------------------------------------------------------------
    def _normal(self, seed: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device).manual_seed(seed)
        return torch.randn(shape, generator=g, device=self.device)

    def initial_noise(self, seeds: Union[int, np.ndarray]) -> torch.Tensor:
        """(B, H, W, C) f32 standard normal, one independent stream per seed."""
        cfg = self.config
        shape = (cfg.image_size, cfg.image_size, cfg.channels)
        return torch.stack([self._normal(int(s), shape)
                            for s in np.atleast_1d(seeds)])

    def step_noise(self, seeds: np.ndarray, k: int) -> torch.Tensor:
        """(B, C, H, W) standard normal for step `k`, a function of (seed, k)."""
        cfg = self.config
        shape = (cfg.channels, cfg.image_size, cfg.image_size)
        return torch.stack([self._normal(_step_seed(s, k), shape) for s in seeds])

    def _kept_steps(self, capture: Union[bool, int]) -> List[int]:
        """Step indices whose result a trajectory keeps."""
        steps = self.config.num_inference_steps
        if capture is True:
            return list(range(steps))
        if not capture:
            return []
        return save_indices(steps, int(capture), self.timesteps,
                            self.schedule.num_train_timesteps)

    # -- public API ------------------------------------------------------------------
    def sample(self, model: torch.nn.Module, seeds: Union[int, np.ndarray],
               capture_trajectory: Union[bool, int] = False,
               initial_noise: Optional[Any] = None,
               step_noise: Optional[Any] = None) -> Dict[str, Any]:
        """Denoise from seed(s). Returns final images (B, H, W, C) f32 in
        about [-1, 1] on the device, plus the trajectory when requested:
        `True` keeps every step ((S, B, H, W, C)); an int n keeps only the
        frames at `save_indices(steps, n)` and returns those indices too.

        `initial_noise` ((B, H, W, C)) replaces the seed-derived noise and
        `step_noise` ((S, B, H, W, C)) the seed-derived posterior noise:
        injected noise lets tests hold the walk against another
        implementation.
        """
        cfg = self.config
        seeds_arr = np.atleast_1d(np.asarray(seeds, dtype=np.uint32))
        batch = int(seeds_arr.shape[0])
        noise = (self.initial_noise(seeds_arr) if initial_noise is None
                 else torch.as_tensor(initial_noise, dtype=torch.float32,
                                      device=self.device))
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, device=self.device)
        stochastic = self.params.stochastic and not cfg.deterministic_posterior
        keep = self._kept_steps(capture_trajectory)

        frames = []
        x = noise.permute(0, 3, 1, 2).to(cfg.dtype).contiguous()
        with torch.inference_mode():
            for k in range(cfg.num_inference_steps):
                t = self.params.timesteps[k].expand(batch)
                eps = model(x, t).to(cfg.dtype)
                if step_noise is not None:
                    z = step_noise[k].permute(0, 3, 1, 2).to(cfg.dtype)
                elif stochastic:
                    z = self.step_noise(seeds_arr, k).to(cfg.dtype)
                else:
                    z = None
                x = self._step(x, eps, k, self.params, z)
                if k in keep:
                    frames.append(x.float().permute(0, 2, 3, 1))

        out: Dict[str, Any] = {
            "images": x.float().permute(0, 2, 3, 1),
            # hashed after the walk is queued, so the copy does not delay it
            "noise_hashes": [noise_hash(n) for n in noise.cpu().numpy()],
            "timesteps": self.timesteps.copy(),
            "seeds": seeds_arr.copy(),
        }
        if capture_trajectory:
            out["trajectory"] = torch.stack(frames)
        if capture_trajectory and capture_trajectory is not True:
            out["save_indices"] = keep
        return out


def to_uint8_images(images) -> np.ndarray:
    """[-1,1] NHWC float (tensor or array) -> uint8 numpy, the reference's
    de-normalization."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    arr = np.asarray(images, dtype=np.float32)
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)
