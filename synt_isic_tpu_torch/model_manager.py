"""Model registry: per-class UNet checkpoints -> UNet2D modules on a device.

The port of `synt_isic_tpu/model_manager.py` for the per-class
(unconditional) models without a conversion cache: class discovery from
`unet_<CLASS>_<variant>.pth`, `load_model` with full manifest validation,
`create_sampler` with the training schedule.

The device is CUDA unless the caller names another; there is no silent
drop to the CPU. On CUDA the sampling model runs the hand-written attention
kernel, and for a compute dtype below f32 also the f32-statistics GroupNorm
(`ops/norms.py`) — the same switch the JAX package makes on a TPU.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from .diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from .io.manifest import expected_unet2d_state_shapes, normalize_key, validate_state_dict
from .io.pth import load_checkpoint
from .models.unet2d import UNet2D, UNet2DConfig
from .utils.logging import Logger
from .utils.paths import PathManager


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """`device`, or CUDA when None; raises if CUDA is asked for and absent."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


class ModelManager:
    def __init__(self, checkpoints_dir: Optional[str] = None,
                 logger: Optional[Logger] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 model_config: Optional[UNet2DConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 variant: str = "best"):
        self.device = resolve_device(device)
        self.path_manager = PathManager()
        self.checkpoints_dir = Path(checkpoints_dir) if checkpoints_dir \
            else self.path_manager.get_checkpoints_dir()
        # 'best' = reference naming unet_<CLASS>_best.pth; other variants are
        # same-architecture files unet_<CLASS>_<variant>.pth
        self.variant = variant
        self.logger = logger or Logger("model_manager")
        self.config = model_config or UNet2DConfig()
        self.dtype = dtype  # compute dtype; recorded in sidecars
        on_cuda = self.device.type == "cuda"
        self.use_fused_attention = on_cuda
        self.fast_norm = on_cuda and dtype != torch.float32
        self.schedule = DiffusionSchedule.create()
        self.loaded_models: Dict[str, UNet2D] = {}
        self.model_metadata: Dict[str, Dict[str, Any]] = {}
        self._samplers: Dict[tuple, DiffusionSampler] = {}

    # -- discovery ----------------------------------------------------------------
    def get_available_classes(self) -> List[str]:
        return self.path_manager.get_available_classes(str(self.checkpoints_dir))

    def checkpoint_path(self, class_name: str) -> Path:
        return self.checkpoints_dir / f"unet_{class_name}_{self.variant}.pth"

    def available_variants(self, class_name: str) -> List[str]:
        """Checkpoint variants present for a class, by filename convention."""
        prefix = f"unet_{class_name}_"
        return sorted(p.stem[len(prefix):]
                      for p in self.checkpoints_dir.glob(f"{prefix}*.pth"))

    # -- load ---------------------------------------------------------------------------
    def sample_model(self) -> UNet2D:
        """A fresh sampling UNet2D for this manager's device and dtype."""
        return UNet2D(self.config, dtype=self.dtype,
                      use_fused_attention=self.use_fused_attention,
                      fast_norm=self.fast_norm)

    def load_model(self, class_name: str,
                   checkpoint_path: Optional[str] = None) -> bool:
        if class_name in self.loaded_models:
            return True
        path = Path(checkpoint_path) if checkpoint_path else self.checkpoint_path(class_name)
        if not path.exists():
            self.logger.log_error(f"checkpoint not found for {class_name}: {path}")
            return False
        t0 = time.time()
        try:
            state = load_checkpoint(str(path))
        except (OSError, RuntimeError, ValueError, pickle.UnpicklingError) as exc:
            self.logger.log_error(f"failed to read checkpoint for {class_name}: {exc}")
            return False
        # full key/shape validation against the diffusers manifest: a
        # checkpoint that does not match the architecture fails here, never
        # samples garbage
        manifest = expected_unet2d_state_shapes(**dataclasses.asdict(self.config))
        problems = validate_state_dict(state, manifest)
        if problems:
            more = f" (+{len(problems) - 8} more)" if len(problems) > 8 else ""
            self.logger.log_error(
                f"checkpoint for {class_name} does not match the UNet2D "
                f"architecture: {'; '.join(problems[:8])}{more}")
            return False
        state = {normalize_key(k): v for k, v in state.items()
                 if not k.endswith("num_batches_tracked")}
        model = self.sample_model()
        model.load_state_dict(state, strict=True)
        self.loaded_models[class_name] = model.to(self.device).eval()
        self.model_metadata[class_name] = {
            "model_path": str(path),
            "loaded_at": time.time(),
            "device": str(self.device),
            "load_seconds": round(time.time() - t0, 3),
        }
        self.logger.log_info(f"model loaded for class {class_name} "
                             f"({self.model_metadata[class_name]['load_seconds']}s)")
        return True

    # -- samplers -------------------------------------------------------------------------
    def create_sampler(self, inference_steps: int = 50, scheduler: str = "ddpm",
                       ddim_eta: float = 0.0, dtype: torch.dtype = torch.float32,
                       timestep_spacing: str = "leading") -> DiffusionSampler:
        """Sampler with the training schedule (T=1000, squaredcos_cap_v2,
        epsilon) and inference steps clamped to [1, 1000]. Cached per
        setting."""
        steps = max(1, min(1000, int(inference_steps)))
        key = (steps, scheduler, ddim_eta, dtype, timestep_spacing)
        if key not in self._samplers:
            cfg = SamplerConfig(num_inference_steps=steps, scheduler=scheduler,
                                ddim_eta=ddim_eta, timestep_spacing=timestep_spacing,
                                image_size=self.config.sample_size,
                                channels=self.config.in_channels, dtype=dtype)
            self._samplers[key] = DiffusionSampler(self.schedule, cfg, self.device)
        return self._samplers[key]
