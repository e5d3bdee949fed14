"""Typed configuration system: the port's own copy of
`synt_isic_tpu/utils/config.py`, with the same keys and defaults, so one
config file serves both packages.

A plain nested-dict config with the reference's keys/defaults (reference
`core/config/config_manager.py:28-207`, `xai/XAI.py:183-272`), JSON
persistence with recursive user-overlay merge, project-root relative path
resolution, and env-var overrides for the XAI knobs (`XAI_SAVE_EVERY_N`,
`XAI_INFERENCE_STEPS`, `XAI_GENERATION_SEED`, `XAI_TARGET_CLASS`,
`XAI_DDPM_MODEL_PATH`) preserved verbatim. `ImageGenerator` reads
`compute.*`, `generation.*` and the paths from it. The `compute` keys that
name a mesh (`mesh_axes`) or buffer donation (`donate_sampler_state`)
belong to the JAX package and are kept only so the files stay
interchangeable.
"""
from __future__ import annotations

import copy
import json
import logging
import os
import platform
from pathlib import Path
from typing import Any, Dict, Optional

CLASS_NAMES = ["MEL", "NV", "BCC", "AKIEC", "BKL", "DF", "VASC"]
NUM_CLASSES = len(CLASS_NAMES)


def default_config() -> Dict[str, Any]:
    """Defaults mirroring reference `config_manager.py:43-70`, plus the
    sampler section (`compute`) and the XAI flag registry
    (`XAI.py:183-272`) folded in as first-class keys."""
    return {
        "paths": {
            "checkpoints": "checkpoints",
            "output": "generated_images",
            "cache": "core/cache",
            "logs": "core/logs",
            "models": "models",
        },
        "generation": {
            "image_size": 128,
            "train_timesteps": 1000,
            "inference_timesteps": 50,
            "batch_size": 1,
            "seed_mode": "random",  # "random" or "fixed"
            "seed_value": 42,
            "xai_frequency": 1,
        },
        "ui": {
            "theme": "light",
            "language": "ru",
            "auto_save": True,
        },
        "advanced": {
            "enable_color_postprocessing": True,
            "enable_xai": False,
            "max_concurrent_generations": 2,
        },
        # --- sampler settings (not in reference) ---
        "compute": {
            "dtype": "float32",          # sampler compute dtype: float32 | bfloat16
            "scheduler": "ddpm",   # ddpm | ddim | dpm_solver | dpm_solver_sde | unipc
            "ddim_eta": 0.0,
            "mesh_axes": {"data": -1},   # -1 = all available devices on 'data'
            "donate_sampler_state": True,
            # class-conditional single-checkpoint mode (one
            # unet_conditional_<variant>.pth serves every class) + CFG
            # weight (0/1 = plain conditional; >1 = guided)
            "conditional": False,
            "guidance_scale": 0.0,
        },
        # --- XAI flag registry (reference XAI.py:183-272) ---
        "xai": {
            "inference_steps": 50,
            "save_every_n_steps": 5,
            "generation_seed": 42,
            "top_k_percent": 10,
            "bottom_k_percent": 10,
            "ig_n_steps": 50,
            "shap_n_samples": 512,
            "shap_patch_size": 16,
            "intervention_types": ["blur"],
            "noise_std": 0.5,
            "blur_kernel_size": 5,
            "alpha_level": 0.1,
            "n_bootstrap": 1000,
            "n_permutations": 10000,
            # opt-in axiom-faithful Time-SHAP stage (permutation-sampled
            # Shapley values over timesteps — reference README.md:198-207)
            "coalitional_shap": False,
            "coalitional_permutations": 256,
        },
    }


def _merge(dst: Dict, src: Dict) -> None:
    """Recursive user-over-default merge (reference `config_manager.py:83-92`)."""
    for key, value in src.items():
        if key in dst and isinstance(value, dict) and isinstance(dst[key], dict):
            _merge(dst[key], value)
        else:
            dst[key] = value


def _user_config_path() -> str:
    """Per-OS user config path (reference `config_manager.py:28-39`)."""
    if platform.system() == "Windows":
        config_dir = os.path.join(os.getenv("APPDATA", ""), "ISICGenerator")
    elif platform.system() == "Darwin":
        config_dir = os.path.expanduser("~/Library/Application Support/ISICGenerator")
    else:
        config_dir = os.path.expanduser("~/.config/ISICGenerator")
    os.makedirs(config_dir, exist_ok=True)
    return os.path.join(config_dir, "config.json")


def apply_env_overrides(config: Dict[str, Any], env: Optional[Dict[str, str]] = None) -> None:
    """XAI env-var flags, preserved from the reference subprocess protocol
    (`XAI.py:243-262`, `XAI.py:588,639`; set at `main.py:1558-1563`)."""
    env = os.environ if env is None else env

    def _int(name: str) -> Optional[int]:
        raw = env.get(name)
        if raw is None:
            return None
        try:
            return int(raw)
        except (TypeError, ValueError):
            return None

    v = _int("XAI_SAVE_EVERY_N")
    if v is not None and v > 0:
        config["xai"]["save_every_n_steps"] = v
    v = _int("XAI_INFERENCE_STEPS")
    if v is not None and v > 0:
        config["xai"]["inference_steps"] = v
    v = _int("XAI_GENERATION_SEED")
    if v is not None:
        config["xai"]["generation_seed"] = v
    if env.get("XAI_TARGET_CLASS"):
        config["xai"]["target_class"] = env["XAI_TARGET_CLASS"]
    if env.get("XAI_DDPM_MODEL_PATH"):
        config["xai"]["ddpm_model_path"] = env["XAI_DDPM_MODEL_PATH"]
    if env.get("XAI_IMAGE_PATH"):
        config["xai"]["image_path"] = env["XAI_IMAGE_PATH"]
    if env.get("XAI_COALITIONAL_SHAP"):
        config["xai"]["coalitional_shap"] = (
            env["XAI_COALITIONAL_SHAP"] in ("1", "true", "yes"))
    v = _int("XAI_COALITIONAL_PERMUTATIONS")
    if v is not None and v > 0:
        config["xai"]["coalitional_permutations"] = v


class ConfigManager:
    """JSON config with user overlay, path resolution and live persistence.

    API parity with reference `ConfigManager` (`config_manager.py:123-206`):
    get_path / get_generation_param / update_generation_param / get / set /
    save_config / export_config / import_config / reset_to_defaults.
    """

    def __init__(self, config_file: Optional[str] = None,
                 project_root: Optional[str] = None,
                 create_dirs: bool = True):
        self.config_file = config_file or _user_config_path()
        self.project_root = str(Path(project_root).resolve()) if project_root else str(Path.cwd())
        self.config = self._load()
        apply_env_overrides(self.config)
        self._resolve_paths(create_dirs=create_dirs)

    # -- loading / persistence -------------------------------------------------
    def _load(self) -> Dict[str, Any]:
        config = default_config()
        if os.path.exists(self.config_file):
            try:
                with open(self.config_file, "r", encoding="utf-8") as f:
                    _merge(config, json.load(f))
            except Exception as exc:  # corrupt user config falls back to defaults
                logging.warning("config load failed (%s); using defaults", exc)
        return config

    def _resolve_paths(self, create_dirs: bool = True) -> None:
        """Anchor relative paths at the project root, CWD-independent
        (reference `config_manager.py:94-107`)."""
        for key, val in self.config["paths"].items():
            if not os.path.isabs(val):
                self.config["paths"][key] = os.path.join(self.project_root, val)
            if create_dirs:
                os.makedirs(self.config["paths"][key], exist_ok=True)

    def save_config(self) -> bool:
        try:
            os.makedirs(os.path.dirname(self.config_file) or ".", exist_ok=True)
            with open(self.config_file, "w", encoding="utf-8") as f:
                json.dump(self.config, f, indent=2, ensure_ascii=False)
            return True
        except Exception as exc:
            logging.error("config save failed: %s", exc)
            return False

    # -- getters / setters -------------------------------------------------------
    def get_path(self, key: str) -> str:
        return self.config["paths"][key]

    def get_generation_param(self, key: str) -> Any:
        return self.config["generation"][key]

    def update_generation_param(self, key: str, value: Any) -> None:
        self.config["generation"][key] = value
        self.save_config()

    def get_xai_param(self, key: str) -> Any:
        return self.config["xai"][key]

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self.config
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, dotted: str, value: Any, persist: bool = True) -> None:
        parts = dotted.split(".")
        node = self.config
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
        if persist:
            self.save_config()

    # -- import / export ----------------------------------------------------------
    def export_config(self, path: str) -> bool:
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(self.config, f, indent=2, ensure_ascii=False)
            return True
        except Exception:
            return False

    def import_config(self, path: str) -> bool:
        try:
            with open(path, "r", encoding="utf-8") as f:
                _merge(self.config, json.load(f))
            self._resolve_paths()
            self.save_config()
            return True
        except Exception:
            return False

    def reset_to_defaults(self) -> None:
        self.config = default_config()
        self._resolve_paths()
        self.save_config()

    def copy(self) -> Dict[str, Any]:
        return copy.deepcopy(self.config)
