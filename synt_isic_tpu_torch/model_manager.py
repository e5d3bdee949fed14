"""Model registry: per-class UNet checkpoints -> UNet2D modules on a device.

The port of `synt_isic_tpu/model_manager.py`: class discovery from
`unet_<CLASS>_<variant>.pth`, `load_model` with full manifest validation
(and, with a `CacheManager`, a raw copy of the checkpoint under its content
hash; the port loads the `.pth` natively, so there is no converted-array
cache), `create_sampler` with the training schedule, the attention tuning
knobs, validation, info, `change_device` and unloading.

Conditional mode (`conditional=True`): ONE class-conditional checkpoint,
`unet_conditional_<variant>.pth` with the `.json` metadata that lists its
classes (written by `train/train_conditional.py`), serves every class.
`load_model(<class>)` aliases the one resident model under each class key,
so no second copy of the weights reaches the device, and the samplers take
per-image class labels and classifier-free guidance.

The device is CUDA unless the caller names another; there is no silent
drop to the CPU. On CUDA the sampling model runs the hand-written attention
kernel, and for a compute dtype below f32 also the f32-statistics GroupNorm
(`ops/norms.py`) — the same switch the JAX package makes on a TPU. The
attention knobs (`set_attention_tuning`) likewise act only where the kernel
runs.
"""
from __future__ import annotations

import dataclasses
import json
import pickle
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from .cache import CacheManager
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
                 cache_manager: Optional[CacheManager] = None,
                 logger: Optional[Logger] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 model_config: Optional[UNet2DConfig] = None,
                 dtype: torch.dtype = torch.float32,
                 variant: str = "best",
                 conditional: bool = False):
        self.path_manager = PathManager()
        self.checkpoints_dir = Path(checkpoints_dir) if checkpoints_dir \
            else self.path_manager.get_checkpoints_dir()
        # 'best' = reference naming unet_<CLASS>_best.pth; other variants are
        # same-architecture files unet_<CLASS>_<variant>.pth
        self.variant = variant
        self.cache = cache_manager
        self.logger = logger or Logger("model_manager")
        self.config = model_config or UNet2DConfig()
        self.conditional = bool(conditional)
        self._cond_classes: List[str] = []
        if self.conditional:
            meta = self._read_conditional_metadata()
            self._cond_classes = list(meta["classes"])
            self.config = dataclasses.replace(
                self.config, num_class_embeds=int(meta.get(
                    "num_class_embeds", len(self._cond_classes) + 1)))
        self.dtype = dtype  # compute dtype; recorded in sidecars
        self._set_device(device)
        # attention kernel knobs: heads per block (identical results) and
        # bf16 exponentials (changes output bytes, so generators record it
        # in sidecars and --reproduce sets it again)
        self.attention_heads_per_program = 1
        self.attention_fast_math = False
        self.schedule = DiffusionSchedule.create()
        self.loaded_models: Dict[str, UNet2D] = {}
        self.model_metadata: Dict[str, Dict[str, Any]] = {}
        self._samplers: Dict[tuple, DiffusionSampler] = {}

    def _set_device(self, device: Optional[Union[str, torch.device]]) -> None:
        """Take `device` and the kernel switches that follow from it: the
        attention kernel on CUDA, and there the f32-statistics GroupNorm for
        a compute dtype below f32."""
        self.device = resolve_device(device)
        on_cuda = self.device.type == "cuda"
        self.use_fused_attention = on_cuda
        self.fast_norm = on_cuda and self.dtype != torch.float32

    def _rebuild(self) -> None:
        """Rebuild every loaded model through `sample_model` on this
        manager's device, with the same weights, and drop the samplers.
        Class keys that alias one model (conditional mode) keep sharing
        one rebuilt model."""
        old_models = dict(self.loaded_models)
        rebuilt: Dict[int, UNet2D] = {}
        for cls, old in old_models.items():
            if id(old) not in rebuilt:
                model = self.sample_model().to(self.device)
                model.load_state_dict(old.state_dict(), strict=True)
                rebuilt[id(old)] = model.eval()
            self.loaded_models[cls] = rebuilt[id(old)]
        self._samplers.clear()

    # -- conditional mode -----------------------------------------------------------
    def _conditional_checkpoint_path(self) -> Path:
        return self.checkpoints_dir / f"unet_conditional_{self.variant}.pth"

    def _read_conditional_metadata(self) -> Dict[str, Any]:
        """The class list and embedding-table size of the conditional
        checkpoint, from the JSON beside it. Raises without it: class ids
        mean nothing without the list."""
        meta_path = self._conditional_checkpoint_path().with_suffix(".json")
        if not meta_path.exists():
            raise FileNotFoundError(
                f"conditional checkpoint metadata not found: {meta_path} "
                "(train/train_conditional.py writes it next to the .pth)")
        meta = json.loads(meta_path.read_text(encoding="utf-8"))
        if not meta.get("classes"):
            raise ValueError(f"no classes listed in {meta_path}")
        return meta

    def class_id(self, class_name: str) -> int:
        """The embedding row of a class (conditional mode)."""
        return self._cond_classes.index(class_name)

    @property
    def null_label(self) -> int:
        """The unconditional (CFG dropout) embedding row: the last one."""
        return int(self.config.num_class_embeds) - 1

    # -- discovery ----------------------------------------------------------------
    def get_available_classes(self) -> List[str]:
        if self.conditional:
            return list(self._cond_classes)
        return self.path_manager.get_available_classes(str(self.checkpoints_dir))

    def checkpoint_path(self, class_name: str) -> Path:
        if self.conditional:
            return self._conditional_checkpoint_path()
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
                      fast_norm=self.fast_norm,
                      fused_heads_per_program=self.attention_heads_per_program,
                      fused_fast_math=self.attention_fast_math)

    def load_model(self, class_name: str,
                   checkpoint_path: Optional[str] = None) -> bool:
        if class_name in self.loaded_models:
            return True
        if self.conditional:
            if class_name not in self._cond_classes:
                self.logger.log_error(
                    f"class {class_name} not in the conditional checkpoint's "
                    f"classes {self._cond_classes}")
                return False
            # the one model may already be resident under another class key
            for other, model in self.loaded_models.items():
                self.loaded_models[class_name] = model
                self.model_metadata[class_name] = dict(self.model_metadata[other])
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
        if self.cache is not None:
            # one cache entry for the shared conditional checkpoint
            self.cache.cache_model("conditional" if self.conditional else class_name,
                                   str(path))
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
                       timestep_spacing: str = "leading",
                       guidance_scale: float = 0.0,
                       guidance_table=None) -> DiffusionSampler:
        """Sampler with the training schedule (T=1000, squaredcos_cap_v2,
        epsilon) and inference steps clamped to [1, 1000]. Cached per
        setting.

        In conditional mode the sampler takes per-image `class_labels`;
        `guidance_scale` > 1 runs classifier-free guidance against the
        checkpoint's null row, and `guidance_table` (a tuple indexed by
        class id) gives every class its own weight. Both are ignored by an
        unconditional manager."""
        steps = max(1, min(1000, int(inference_steps)))
        table = (tuple(float(g) for g in guidance_table)
                 if (guidance_table is not None and self.conditional) else None)
        scale = float(guidance_scale) if self.conditional else 0.0
        key = (steps, scheduler, ddim_eta, dtype, timestep_spacing, scale, table)
        if key not in self._samplers:
            cfg = SamplerConfig(num_inference_steps=steps, scheduler=scheduler,
                                ddim_eta=ddim_eta, timestep_spacing=timestep_spacing,
                                image_size=self.config.sample_size,
                                channels=self.config.in_channels, dtype=dtype,
                                guidance_scale=scale, guidance_table=table)
            self._samplers[key] = DiffusionSampler(
                self.schedule, cfg, self.device, conditional=self.conditional,
                null_label=self.null_label if self.conditional else None)
        return self._samplers[key]

    def set_attention_tuning(self, heads_per_program: Optional[int] = None,
                             fast_math: Optional[bool] = None) -> None:
        """Rebuild the sampling models with the attention kernel's knobs.

        `heads_per_program` runs G heads per block: identical results.
        `fast_math` takes the softmax exponentials in bf16: the output
        changes at bf16 level, so it is recorded in sidecars and honoured by
        `--reproduce`. On a device other than CUDA the sampling model has no
        kernel and the knobs change nothing but the record. Clears the
        sampler cache, as the JAX package does."""
        if heads_per_program is not None:
            self.attention_heads_per_program = int(heads_per_program)
        if fast_math is not None:
            self.attention_fast_math = bool(fast_math)
        self._rebuild()

    # -- unload -------------------------------------------------------------------------
    def unload_model(self, class_name: str) -> bool:
        if class_name not in self.loaded_models:
            return False
        del self.loaded_models[class_name]
        self.model_metadata.pop(class_name, None)
        self.logger.log_info(f"model unloaded for class {class_name}")
        return True

    def unload_all_models(self) -> bool:
        for cls in list(self.loaded_models):
            self.unload_model(cls)
        return True

    # -- validation / info ------------------------------------------------------------
    def validate_model(self, class_name: str) -> bool:
        """The model is loaded, every parameter lies on this manager's
        device, and `conv_in` has the configured shape."""
        model = self.loaded_models.get(class_name)
        if model is None:
            self.logger.log_warning(f"model for {class_name} not loaded")
            return False
        devices = {p.device for p in model.parameters()}
        # "cuda" names the current card, whose parameters say "cuda:0"
        want = self.device
        if want.type == "cuda" and want.index is None:
            want = torch.device("cuda", torch.cuda.current_device())
        if devices != {want}:
            self.logger.log_warning(
                f"model {class_name} on wrong device(s): {devices} != {self.device}")
            return False
        cfg = self.config
        return tuple(model.conv_in.weight.shape) == (
            cfg.block_out_channels[0], cfg.in_channels, 3, 3)

    def get_loaded_models_info(self) -> Dict[str, Dict[str, Any]]:
        info = {}
        for cls, model in self.loaded_models.items():
            n_params = sum(p.numel() for p in model.parameters())
            info[cls] = {
                "parameters": n_params,
                "parameters_millions": round(n_params / 1e6, 2),
                **self.model_metadata.get(cls, {}),
            }
        return info

    def change_device(self, device: Union[str, torch.device]) -> bool:
        """Move every loaded model to another device. The models are rebuilt
        with the kernel switches of the new device (the attention kernel and
        the f32-statistics GroupNorm on CUDA, the plain versions elsewhere),
        and the samplers, which hold device tables, are dropped and rebuilt
        on demand."""
        self._set_device(device)
        self._rebuild()
        for cls in self.loaded_models:
            self.model_metadata[cls]["device"] = str(self.device)
        return True

    def cleanup(self) -> None:
        self.unload_all_models()
        self._samplers.clear()
