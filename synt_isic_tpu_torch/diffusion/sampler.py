"""DDPM/DDIM sampler: the reverse walk as a loop of device work.

The port of `synt_isic_tpu/diffusion/sampler.py` for the single-state
schedulers (`ddpm`, `ddim`), unconditional and class-conditional with
classifier-free guidance (CFG). The JAX sampler compiles the walk into one
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
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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
    # CFG weight of a conditional sampler: eps = eps_u + g (eps_c - eps_u).
    # g <= 1 runs one plain conditional forward per step; g > 1 runs the
    # conditional and null branches as ONE 2B-batched forward. Ignored by
    # unconditional samplers.
    guidance_scale: float = 0.0
    # per-class weights indexed by class id; on a conditional sampler it
    # overrides guidance_scale: every step runs the 2B-batched forward and
    # each sample combines with g = table[label]
    guidance_table: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.scheduler not in ("ddpm", "ddim"):
            raise ValueError(f"unknown scheduler: {self.scheduler}")
        if self.timestep_spacing not in ("leading", "trailing"):
            raise ValueError(f"unknown timestep_spacing: {self.timestep_spacing!r}")
        if self.guidance_scale < 0.0:
            raise ValueError(f"guidance_scale must be >= 0, got {self.guidance_scale}")
        if self.guidance_table is not None:
            # frozen dataclass: normalise through object.__setattr__
            object.__setattr__(self, "guidance_table",
                               tuple(float(g) for g in self.guidance_table))
            if any(g < 0.0 for g in self.guidance_table):
                raise ValueError("guidance_table entries must be >= 0, got "
                                 f"{self.guidance_table}")


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
    `conditional=True` calls `model(x_nchw, t_batch, class_labels)` instead;
    `sample()` then requires `class_labels`, and guidance (`guidance_scale`
    > 1 or a `guidance_table`) runs against `null_label`, the checkpoint's
    unconditional embedding row.
    """

    def __init__(self, schedule: DiffusionSchedule,
                 config: SamplerConfig = SamplerConfig(),
                 device: Union[str, torch.device] = "cuda",
                 conditional: bool = False,
                 null_label: Optional[int] = None):
        self.schedule = schedule
        self.config = config
        self.device = torch.device(device)
        self.conditional = bool(conditional)
        self.null_label = null_label
        if (self.conditional and null_label is None
                and (config.guidance_scale > 1.0 or config.guidance_table is not None)):
            raise ValueError("guided sampling (guidance_scale > 1 or a "
                             "guidance_table) requires null_label "
                             "(the unconditional embedding index)")
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

    # -- epsilon predictor (conditional / CFG dispatch) ---------------------------
    def _make_predict(self, labels: Optional[torch.Tensor]) -> Callable:
        """(model, x, t_batch) -> eps in the compute dtype, for a batch whose
        class ids are `labels` (None for an unconditional sampler). Guided
        sampling runs ONE forward over [x, x], [t, t], [labels, null] at
        batch 2B and combines eps_u + g (eps_c - eps_u) in the compute
        dtype; a guidance table gathers each sample's g by its label."""
        cfg = self.config
        if not self.conditional:
            return lambda model, x, t: model(x, t).to(cfg.dtype)
        g = float(cfg.guidance_scale)
        if cfg.guidance_table is None and g <= 1.0:
            return lambda model, x, t: model(x, t, labels).to(cfg.dtype)
        b = labels.shape[0]
        labels2 = torch.cat([labels, torch.full_like(labels, int(self.null_label))])
        if cfg.guidance_table is not None:
            table = torch.tensor(cfg.guidance_table, dtype=torch.float32,
                                 device=self.device)
            g = table[labels].to(cfg.dtype).reshape(b, 1, 1, 1)

        def predict(model, x, t):
            eps2 = model(torch.cat([x, x]), torch.cat([t, t]), labels2).to(cfg.dtype)
            return eps2[b:] + g * (eps2[:b] - eps2[b:])

        return predict

    def _labels(self, class_labels, batch: int) -> Optional[torch.Tensor]:
        """(B,) int64 class ids on the device; a scalar broadcasts. Required
        by a conditional sampler, refused by an unconditional one."""
        if not self.conditional:
            if class_labels is not None:
                raise ValueError("class_labels passed to an unconditional sampler")
            return None
        if class_labels is None:
            raise ValueError("conditional sampler requires class_labels")
        labels = torch.as_tensor(np.asarray(class_labels, np.int64).reshape(-1))
        return labels.expand(batch).to(self.device)

    # -- public API ------------------------------------------------------------------
    def sample(self, model: torch.nn.Module, seeds: Union[int, np.ndarray],
               capture_trajectory: Union[bool, int] = False,
               initial_noise: Optional[Any] = None,
               step_noise: Optional[Any] = None,
               class_labels: Optional[Union[int, np.ndarray]] = None
               ) -> Dict[str, Any]:
        """Denoise from seed(s). Returns final images (B, H, W, C) f32 in
        about [-1, 1] on the device, plus the trajectory when requested:
        `True` keeps every step ((S, B, H, W, C)); an int n keeps only the
        frames at `save_indices(steps, n)` and returns those indices too.

        `initial_noise` ((B, H, W, C)) replaces the seed-derived noise and
        `step_noise` ((S, B, H, W, C)) the seed-derived posterior noise:
        injected noise lets tests hold the walk against another
        implementation.

        `class_labels` (a scalar or (B,) int ids) is required for a
        conditional sampler and refused otherwise; a scalar broadcasts.
        """
        cfg = self.config
        seeds_arr = np.atleast_1d(np.asarray(seeds, dtype=np.uint32))
        batch = int(seeds_arr.shape[0])
        predict = self._make_predict(self._labels(class_labels, batch))
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
                eps = predict(model, x, t)
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
