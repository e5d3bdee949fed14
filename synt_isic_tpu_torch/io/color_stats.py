"""Per-class color statistics + postprocessing.

Parity with the reference's two postprocessing variants:
  * GUI engine: mean/std matching with scale clipped to [0.6, 1.4] and
    alpha=0.35 blend with the original
    (`core/generator/image_generator.py:502-545`);
  * console engine: plain mean shift
    (`diffusion/console_generator_server.py:129-168`).
Statistics come from `checkpoints/color_statistics.json` keyed by class with
`{"rgb": {"mean": [r,g,b], "std": [r,g,b]}}` (`image_generator.py:142-170`).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np


def compute_color_statistics(images: np.ndarray,
                             value_range=(-1.0, 1.0)) -> Dict[str, Any]:
    """Per-class RGB mean/std in uint8 units from an image stack.

    `images`: (N,H,W,3), uint8 or float in `value_range`. Returns the
    per-class entry schema of `checkpoints/color_statistics.json`
    (`{"rgb": {"mean": [r,g,b], "std": [r,g,b]}}`, reference
    `core/generator/image_generator.py:142-170`) — training emits this so
    the generator's color postprocessing stage has real targets."""
    arr = np.asarray(images)
    if arr.dtype == np.uint8:
        scaled = arr.astype(np.float32)
    else:
        lo, hi = value_range
        scaled = (arr.astype(np.float32) - lo) * (255.0 / (hi - lo))
    mean = scaled.mean(axis=tuple(range(scaled.ndim - 1)))
    std = scaled.std(axis=tuple(range(scaled.ndim - 1)))
    return {"rgb": {"mean": [round(float(v), 3) for v in mean],
                    "std": [round(float(v), 3) for v in std]},
            "n_images": int(arr.shape[0])}


def update_color_statistics_file(path, class_name: str,
                                 stats: Dict[str, Any]) -> None:
    """Merge one class's statistics into `color_statistics.json`.

    Safe against concurrent per-class trainings sharing one checkpoints
    dir: the read-merge-replace runs under an advisory file lock (so a
    parallel writer cannot drop this class's entry) and the temp file is
    per-process (no interleaved partial writes)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    lock_path = p.with_name(p.name + ".lock")
    lock = open(lock_path, "w")
    try:
        try:
            import fcntl
            fcntl.flock(lock, fcntl.LOCK_EX)
        except ImportError:          # non-POSIX: best-effort, unlocked
            pass
        existing = load_color_statistics(p)
        existing[class_name] = stats
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(existing, indent=2), encoding="utf-8")
        tmp.replace(p)
    finally:
        lock.close()


def load_color_statistics(path) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        return {}
    try:
        with open(p, "r", encoding="utf-8") as f:
            return json.load(f)
    except Exception:
        return {}


def apply_color_postprocessing(img_uint8: np.ndarray, stats: Optional[Dict[str, Any]],
                               alpha: float = 0.35,
                               scale_clip=(0.6, 1.4)) -> np.ndarray:
    """Moment-matching variant (GUI engine). img_uint8: (H,W,3) uint8."""
    if not stats or "rgb" not in stats or "mean" not in stats.get("rgb", {}):
        return img_uint8
    rgb = stats["rgb"]
    target_mean = np.asarray(rgb.get("mean", [128, 128, 128]), dtype=np.float32)
    target_std = np.asarray(rgb.get("std", [50, 50, 50]), dtype=np.float32)
    arr = img_uint8.astype(np.float32)
    current_mean = arr.mean(axis=(0, 1))
    current_std = np.maximum(arr.std(axis=(0, 1)), 1e-6)
    scale = np.clip(target_std / current_std, scale_clip[0], scale_clip[1])
    shifted = (arr - current_mean) * scale + target_mean
    blended = alpha * shifted + (1.0 - alpha) * arr
    return np.clip(blended, 0, 255).astype(np.uint8)


def apply_mean_shift_postprocessing(img_uint8: np.ndarray,
                                    stats: Optional[Dict[str, Any]]) -> np.ndarray:
    """Mean-shift-only variant (console engine)."""
    if not stats or "rgb" not in stats or "mean" not in stats.get("rgb", {}):
        return img_uint8
    target_mean = np.asarray(stats["rgb"]["mean"], dtype=np.float32)
    arr = img_uint8.astype(np.float32)
    correction = target_mean - arr.mean(axis=(0, 1))
    return np.clip(arr + correction, 0, 255).astype(np.uint8)
