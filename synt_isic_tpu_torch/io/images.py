"""Image export + sidecar metadata.

Parity with the reference's artifact contract:
  * `[-1,1] -> uint8 PNG` conversion (`core/generator/image_generator.py:440-454`);
  * per-image sidecar JSON with seed / steps / scheduler config / model
    metadata / noise hash for exact regeneration
    (`image_generator.py:456-477`);
  * JPEG quality-95 output for the console dataset path
    (`diffusion/console_generator_server.py:275`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
from PIL import Image


def tensor_to_pil(image: np.ndarray) -> Image.Image:
    """(H,W,3) or (1,H,W,3) float in [-1,1] -> PIL RGB."""
    arr = np.asarray(image, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip((arr + 1.0) / 2.0, 0.0, 1.0)
    return Image.fromarray((arr * 255.0).astype(np.uint8))


def save_image(image: np.ndarray, path: str, quality: int = 95,
               png_compress_level: Optional[int] = None) -> None:
    """`png_compress_level` (0-9, None = PIL default 6) trades PNG size for
    encode speed: level 1 measures ~3x faster on lesion-like images on this
    host and the write stage bounds production throughput at few-step
    sampler configs. It changes the PNG's BYTES (not pixels), so callers
    that set it must record it for the byte-identity reproduce contract
    (ImageGenerator writes it into the sidecar scheduler block)."""
    pil = tensor_to_pil(image) if not isinstance(image, Image.Image) else image
    path = str(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        pil.save(path, quality=quality)
    elif png_compress_level is not None:
        pil.save(path, compress_level=int(png_compress_level))
    else:
        pil.save(path)


def write_sidecar_metadata(image_path: str, *, class_name: str,
                           seed: Optional[int], inference_steps: int,
                           model_metadata: Optional[Dict[str, Any]] = None,
                           device: str = "cuda",
                           noise_hash: Optional[str] = None,
                           scheduler: Optional[Dict[str, Any]] = None,
                           extra: Optional[Dict[str, Any]] = None) -> Path:
    """Writes `<image>.json` next to the image (reference
    `image_generator.py:456-474` field set)."""
    meta = {
        "filename": Path(image_path).name,
        "class": class_name,
        "seed": int(seed) if seed is not None else None,
        "inference_steps": int(inference_steps),
        "scheduler": scheduler or {
            "num_train_timesteps": 1000,
            "beta_schedule": "squaredcos_cap_v2",
            "prediction_type": "epsilon",
        },
        "model": model_metadata or {},
        "device": device,
        "noise_hash": noise_hash,
    }
    if extra:
        # additive top-level fields (e.g. the img2img provenance block) —
        # only written when present so noise-only sidecars stay unchanged
        meta.update(extra)
    meta_path = Path(image_path).with_suffix(".json")
    with open(meta_path, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=2, ensure_ascii=False)
    return meta_path
