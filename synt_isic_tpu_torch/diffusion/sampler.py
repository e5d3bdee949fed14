"""The diffusion sampler: the reverse walk as a loop of device work.

The port of `synt_isic_tpu/diffusion/sampler.py`: the five schedulers
(`ddpm`, `ddim`, the multistep `dpm_solver` / `dpm_solver_sde` and `unipc`),
unconditional and class-conditional with classifier-free guidance (CFG),
img2img and inpainting, and trajectory capture (every step, windowed, or
streamed to host memory). The JAX sampler compiles the walk into one
`lax.scan`; here it is a Python loop over steps whose timesteps and
coefficients are device tables read by index, so the loop issues work to
the device and never waits for it (no `.item()`, no host sync per step).

The walk carries one of three states: `simple` (ddpm, ddim) carries x;
`dpm` carries (x, x0_prev = 0); `unipc` carries (x_pred, x_prev = x,
x0_prev = 0). Its sample, each captured frame and the final image, is the
first element: for UniPC the predictor's output, not the corrected one.

Seed contract, kept in shape (PyTorch cannot reproduce JAX's threefry
bits, so the numbers differ from the JAX package's for the same seed):
  * one independent stream per image seed: the initial noise of an image
    comes from a `torch.Generator` seeded with its seed alone;
  * step-k noise (the DDPM posterior's, the DDIM eta's and the SDE's) is a
    pure function of (seed, k): a generator seeded from
    `np.random.SeedSequence([seed, k + 1])`; the inpainting noise of step k
    is that of (seed, S + k), disjoint from it, as the JAX package's
    `fold_in(key, S + 1 + k)` is from `fold_in(key, k + 1)`;
  * so no image depends on which other images share its batch;
  * `noise_hash` is the SHA-256 of an image's initial noise as f32 NHWC
    bytes, recorded in sidecars. On CUDA the noise goes to pinned host
    memory by a copy queued before the first UNet call and is hashed when
    `noise_hashes` is first read, so `sample()` returns without waiting for
    the device.

Public tensors are NHWC, as in the JAX package; the model is called NCHW.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .ddim import DDIMParams, ddim_step
from .ddpm import DDPMParams, ddpm_step
from .dpm import DPMSolverParams, dpm_solver_step
from .schedules import DiffusionSchedule, device_table
from .unipc import UniPCParams, unipc_step

SCHEDULERS = ("ddpm", "ddim", "dpm_solver", "dpm_solver_sde", "unipc")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    num_inference_steps: int = 50
    scheduler: str = "ddpm"   # ddpm | ddim | dpm_solver | dpm_solver_sde | unipc
    ddim_eta: float = 0.0
    image_size: int = 128
    channels: int = 3
    dtype: torch.dtype = torch.float32   # compute dtype of the walk
    clip_sample: bool = True
    deterministic_posterior: bool = False  # skip the step noise
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
        if self.scheduler not in SCHEDULERS:
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


class HostCopy:
    """A tensor's copy in host memory, started now and read later. On CUDA
    the copy goes into a pinned buffer, queued without blocking on the
    current stream behind the work that makes the tensor, with an event
    recorded behind it: `numpy()` waits on that event alone, never on work
    queued after it. Elsewhere the tensor already is in host memory."""

    def __init__(self, tensor: torch.Tensor):
        tensor = tensor.detach()
        self._ready = None
        if tensor.device.type != "cuda":
            self._host = tensor
            return
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        self._host.copy_(tensor, non_blocking=True)
        self._ready = torch.cuda.Event()
        self._ready.record()

    def numpy(self) -> np.ndarray:
        if self._ready is not None:
            self._ready.synchronize()
        return self._host.numpy()


class NoiseHashes(collections.abc.Sequence):
    """The `noise_hash` of each image of a block, computed from a
    `HostCopy` of its initial noise when first read."""

    def __init__(self, noise: HostCopy):
        self._noise: Optional[HostCopy] = noise
        self._hashes: List[str] = []

    def _list(self) -> List[str]:
        if self._noise is not None:
            self._hashes = [noise_hash(n) for n in self._noise.numpy()]
            self._noise = None
        return self._hashes

    def __getitem__(self, index):
        return self._list()[index]

    def __len__(self) -> int:
        return len(self._list())


def noise_hashes(noise: torch.Tensor) -> Sequence[str]:
    """The hashes of a block's initial noise (B, H, W, C): on CUDA a
    `NoiseHashes` whose copy is queued now, elsewhere the list itself."""
    if noise.device.type == "cuda":
        return NoiseHashes(HostCopy(noise))
    return [noise_hash(n) for n in noise.numpy()]


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
        # where the seed streams are drawn: a shard of a mesh run draws on
        # the primary's device, so its noise is the unsharded run's
        self.noise_device = self.device
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
        elif config.scheduler in ("dpm_solver", "dpm_solver_sde"):
            self.params = DPMSolverParams.create(
                schedule, config.num_inference_steps,
                clip_sample=config.clip_sample,
                timestep_spacing=config.timestep_spacing,
                sde=config.scheduler == "dpm_solver_sde", device=self.device)
            self._step = None   # multistep: `_advance` calls dpm_solver_step
        elif config.scheduler == "unipc":
            self.params = UniPCParams.create(
                schedule, config.num_inference_steps,
                clip_sample=config.clip_sample,
                timestep_spacing=config.timestep_spacing, device=self.device)
            self._step = None   # multistep: `_advance` calls unipc_step
        else:
            self.params = DDIMParams.create(
                schedule, config.num_inference_steps, eta=config.ddim_eta,
                clip_sample=config.clip_sample,
                timestep_spacing=config.timestep_spacing, device=self.device)
            self._step = ddim_step
        self.timesteps = self.params.timesteps.cpu().numpy()
        self._family = ("unipc" if config.scheduler == "unipc"
                        else "dpm" if config.scheduler.startswith("dpm_solver")
                        else "simple")
        # whether a step draws noise of its own, known on the host
        self._stochastic = self.params.stochastic and not config.deterministic_posterior

    def on_device(self, device: Union[str, torch.device]) -> "DiffusionSampler":
        """This sampler's walk on another device (its tables there), drawing
        its seed streams where this one draws them."""
        other = DiffusionSampler(self.schedule, self.config, device,
                                 conditional=self.conditional, null_label=self.null_label)
        other.noise_device = self.noise_device
        return other

    # -- seed plumbing ------------------------------------------------------------
    def _normal(self, seed: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.noise_device).manual_seed(seed)
        return torch.randn(shape, generator=g, device=self.noise_device).to(self.device)

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

    # -- the walk ------------------------------------------------------------------
    def _init_carry(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if self._family == "dpm":
            return (x, torch.zeros_like(x))
        if self._family == "unipc":
            return (x, x, torch.zeros_like(x))
        return (x,)

    def _advance(self, carry, eps: torch.Tensor, k: int,
                 z: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """The carry after step k from the model's eps at carry[0]."""
        if self._family == "unipc":
            return unipc_step(*carry, eps, k, self.params)
        if self._family == "dpm":
            return dpm_solver_step(*carry, eps, k, self.params, z)
        return (self._step(carry[0], eps, k, self.params, z),)

    def _noise_at(self, seeds: np.ndarray, k: int, injected: Optional[torch.Tensor],
                  i: int) -> Optional[torch.Tensor]:
        """Step k's noise (B, C, H, W) in the compute dtype: the i-th entry
        of the injected NHWC noise when given, else drawn from the (seed, k)
        streams when the walk draws any, else None."""
        if injected is not None:
            return injected[i].permute(0, 3, 1, 2).to(self.config.dtype)
        if self._stochastic:
            return self.step_noise(seeds, k).to(self.config.dtype)
        return None

    # -- public API ------------------------------------------------------------------
    def sample(self, model: torch.nn.Module, seeds: Union[int, np.ndarray],
               capture_trajectory: Union[bool, int] = False,
               initial_noise: Optional[Any] = None,
               step_noise: Optional[Any] = None,
               class_labels: Optional[Union[int, np.ndarray]] = None,
               stream_to_host: bool = False) -> Dict[str, Any]:
        """Denoise from seed(s). Returns final images (B, H, W, C) f32 in
        about [-1, 1] on the device, plus the trajectory when requested:
        `True` keeps every step ((S, B, H, W, C)); an int n keeps only the
        frames at `save_indices(steps, n)` and returns those indices too.
        On CUDA it returns once the walk is queued, without waiting for the
        device; `noise_hashes` waits for the initial noise's copy alone.

        `stream_to_host=True` (with either capture mode) copies each kept
        frame to host memory as the walk goes (on CUDA: pinned buffers,
        non-blocking copies on a side stream behind an event), so the
        device holds one frame at a time; the trajectory comes back as host
        numpy (n_saved, B, H, W, C) with `save_indices`.

        `initial_noise` ((B, H, W, C)) replaces the seed-derived noise and
        `step_noise` ((S, B, H, W, C)) the seed-derived step noise (the DDPM
        posterior's, DDIM's at eta > 0, the SDE's): injected noise lets
        tests hold the walk against another implementation.

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
        # queued before the walk: reading the hashes waits for the noise alone
        hashes = noise_hashes(noise)
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, device=self.device)
        streamed = bool(stream_to_host and capture_trajectory)
        keep = self._kept_steps(capture_trajectory)
        kept = set(keep)
        frames = _HostFrames(self.device) if streamed else []

        carry = self._init_carry(noise.permute(0, 3, 1, 2).to(cfg.dtype).contiguous())
        with torch.inference_mode():
            for k in range(cfg.num_inference_steps):
                t = self.params.timesteps[k].expand(batch)
                eps = predict(model, carry[0], t)
                carry = self._advance(carry, eps, k,
                                      self._noise_at(seeds_arr, k, step_noise, k))
                if k in kept:
                    frames.append(carry[0].float().permute(0, 2, 3, 1))

        out: Dict[str, Any] = {
            "images": carry[0].float().permute(0, 2, 3, 1),
            "noise_hashes": hashes,
            "timesteps": self.timesteps.copy(),
            "seeds": seeds_arr.copy(),
        }
        if streamed:
            out["trajectory"] = frames.numpy()
            out["save_indices"] = keep
        elif capture_trajectory:
            out["trajectory"] = torch.stack(frames)
            if capture_trajectory is not True:
                out["save_indices"] = keep
        return out

    def img2img(self, model: torch.nn.Module, seeds: Union[int, np.ndarray],
                init_image, strength: float = 0.6, mask=None,
                capture_trajectory: bool = False,
                class_labels: Optional[Union[int, np.ndarray]] = None,
                initial_noise: Optional[Any] = None,
                step_noise: Optional[Any] = None,
                inpaint_noise: Optional[Any] = None) -> Dict[str, Any]:
        """SDEdit-style image-to-image with optional RePaint-style
        inpainting, for the single-state schedulers (ddpm, ddim); the
        multistep ones raise, since their histories cannot start mid-walk.

        `init_image` ((H, W, C) or (B, H, W, C), f32 in [-1, 1]) is
        forward-noised to the grid step `k0 = S - max(1, round(strength S))`
        (x = sqrt(ab) init + sqrt(1 - ab) noise, with the initial noise of
        `sample`, so the `noise_hashes` contract carries over) and denoised
        over the remaining steps. `mask` ((H, W), (H, W, 1) or (B, H, W,
        1 or C); 1 = regenerate, 0 = keep) re-imposes the known region at
        each step's noise level after the step, so the result equals `init`
        exactly where mask == 0.

        `initial_noise`, `step_noise` and `inpaint_noise` inject the noise
        as in `sample`: step and inpaint noise hold the executed steps only,
        (steps_to_run, B, H, W, C). Returns the `sample()` dict plus
        `strength`, `start_index` (k0) and `t_start`; a captured trajectory
        holds the executed steps only.
        """
        if self._family != "simple":
            raise NotImplementedError(
                "img2img/inpainting requires a single-step-state scheduler "
                "(ddpm or ddim); multistep solver histories cannot start "
                "mid-walk")
        cfg = self.config
        s = float(strength)
        if not 0.0 < s <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        seeds_arr = np.atleast_1d(np.asarray(seeds, dtype=np.uint32))
        batch = int(seeds_arr.shape[0])
        predict = self._make_predict(self._labels(class_labels, batch))
        shape = (cfg.image_size, cfg.image_size, cfg.channels)
        init = torch.as_tensor(init_image, dtype=torch.float32, device=self.device)
        if init.dim() == 3:
            init = init[None]
        if tuple(init.shape) not in ((batch,) + shape, (1,) + shape):
            raise ValueError(f"init_image shape {tuple(init.shape)} incompatible "
                             f"with batch {batch} and image shape {shape}")
        init = init.expand((batch,) + shape)
        m = None
        if mask is not None:
            m = torch.as_tensor(mask, dtype=torch.float32, device=self.device)
            if m.dim() == 2:
                m = m[None, :, :, None]
            elif m.dim() == 3:
                m = m[None]
            if (tuple(m.shape[1:3]) != shape[:2]
                    or m.shape[-1] not in (1, cfg.channels)
                    or m.shape[0] not in (1, batch)):
                raise ValueError(f"mask shape {tuple(m.shape)} incompatible with "
                                 f"image shape {shape} and batch {batch}")

        num_steps = cfg.num_inference_steps
        # Python's round: half to even, as the JAX package rounds
        steps_to_run = max(1, int(round(s * num_steps)))
        k0 = num_steps - steps_to_run
        t_start = int(self.timesteps[k0])
        ab0 = float(np.asarray(self.schedule.alphas_cumprod, dtype=np.float64)[t_start])
        noise = (self.initial_noise(seeds_arr) if initial_noise is None
                 else torch.as_tensor(initial_noise, dtype=torch.float32,
                                      device=self.device))
        hashes = noise_hashes(noise)
        x_start = (float(np.float32(np.sqrt(ab0))) * init
                   + float(np.float32(np.sqrt(1.0 - ab0))) * noise)
        if step_noise is not None:
            step_noise = torch.as_tensor(step_noise, device=self.device)
        if inpaint_noise is not None:
            inpaint_noise = torch.as_tensor(inpaint_noise, device=self.device)

        dt = cfg.dtype
        frames = []
        x = x_start.permute(0, 3, 1, 2).to(dt).contiguous()
        with torch.inference_mode():
            if m is not None:
                # the noise level after step k: ab of the next grid timestep,
                # 1 (clean) after the final step
                ab_np = np.asarray(self.schedule.alphas_cumprod, dtype=np.float32)
                ab_after = device_table(np.append(ab_np[self.timesteps[1:]], np.float32(1.0)),
                                        self.device)
                known_img = init.permute(0, 3, 1, 2).to(dt)
                regen = m.permute(0, 3, 1, 2).to(dt)
            for i, k in enumerate(range(k0, num_steps)):
                t = self.params.timesteps[k].expand(batch)
                eps = predict(model, x, t)
                x = self._step(x, eps, k, self.params,
                               self._noise_at(seeds_arr, k, step_noise, i))
                if m is not None:
                    z = (inpaint_noise[i].permute(0, 3, 1, 2).to(dt)
                         if inpaint_noise is not None
                         else self.step_noise(seeds_arr, num_steps + k).to(dt))
                    ab = ab_after[k].to(dt)
                    known = ab.sqrt() * known_img + (1.0 - ab).sqrt() * z
                    x = regen * x + (1.0 - regen) * known
                if capture_trajectory:
                    frames.append(x.float().permute(0, 2, 3, 1))

        out: Dict[str, Any] = {
            "images": x.float().permute(0, 2, 3, 1),
            "noise_hashes": hashes,
            "timesteps": self.timesteps.copy(),
            "seeds": seeds_arr.copy(),
            "strength": s,
            "start_index": k0,
            "t_start": t_start,
        }
        if capture_trajectory:
            out["trajectory"] = torch.stack(frames)   # (steps_to_run, B, H, W, C)
        return out

    def sample_single(self, model: torch.nn.Module, seed: int,
                      capture_trajectory: bool = False,
                      class_labels: Optional[int] = None) -> Dict[str, Any]:
        return self.sample(model, np.asarray([seed], dtype=np.uint32),
                           capture_trajectory=capture_trajectory,
                           class_labels=class_labels)


class _HostFrames:
    """Trajectory frames copied to host memory as the walk goes. On CUDA
    each frame goes into a pinned buffer by a non-blocking copy on a side
    stream that waits on an event recorded after the frame, so the copies
    overlap the next steps and the device keeps no frame once its copy is
    done; elsewhere the frame already is in host memory."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.frames: List[torch.Tensor] = []

    def append(self, frame: torch.Tensor) -> None:
        frame = frame.contiguous()
        if self.stream is None:
            self.frames.append(frame)
            return
        ready = torch.cuda.Event()
        ready.record()
        host = torch.empty(frame.shape, dtype=frame.dtype, pin_memory=True)
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ready)
            host.copy_(frame, non_blocking=True)
        frame.record_stream(self.stream)   # freed only after the copy
        self.frames.append(host)

    def numpy(self) -> np.ndarray:
        if self.stream is not None:
            self.stream.synchronize()
        return np.stack([f.numpy() for f in self.frames])


def to_uint8_images(images) -> np.ndarray:
    """[-1,1] NHWC float (tensor or array) -> uint8 numpy, the reference's
    de-normalization."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    arr = np.asarray(images, dtype=np.float32)
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)
