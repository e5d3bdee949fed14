"""`.pth` checkpoint reading and writing.

Checkpoints are raw diffusers `UNet2DModel` state dicts saved with
`torch.save` (`unet_<CLASS>_best.pth`), or files in the same zip format
written by the JAX package's torch-free `save_pth`; `torch.load` reads both,
and the JAX package's `load_pth` reads what `save_checkpoint` writes.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Mapping

import torch


def unwrap_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """Tolerate full training checkpoints that wrap the weights in a
    `model_state_dict` container."""
    if ("model_state_dict" in state
            and isinstance(state["model_state_dict"], dict)):
        return state["model_state_dict"]
    return state


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in `path`, as CPU tensors. `weights_only=True` refuses
    anything but tensors and plain containers."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError(f"{path} did not contain a state_dict (got {type(state)})")
    return unwrap_state_dict(state)


def save_checkpoint(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write `state_dict` (diffusers keys) as f32 CPU tensors with
    `torch.save`. The file is written beside `path` and renamed over it, so
    a reader never sees half a checkpoint."""
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in state_dict.items()}
    path = Path(path)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)
