"""Procedural class-conditional lesion-like dataset — asset-free training.

A copy of `synt_isic_tpu/train/procedural.py` (the images are the same
numpy arrays, bit for bit); `ProceduralDataset(device=...)` holds the set as
one torch tensor on that device and gathers its batches there.

The reference trains on the real ISIC-2018 archive
(`diffusion/train_diffusion.py:85-114`), which cannot ship with this repo.
This module synthesizes a *learnable* class-conditional image distribution
with the same tensor contract ([-1,1] NHWC at the training resolution) so
the full train → checkpoint → sample → XAI → FID loop can close end to end
without any downloaded asset.

Each class has distinct, learnable structure (so FID between classes is
large and a DDPM visibly converges onto it):
  * MEL  — large dark irregular blob with internal darker speckle;
  * NV   — compact round brown blob, smooth boundary;
  * VASC — bright red annulus (ring) on pale skin.
All on a skin-tone background with low-frequency texture; every image is
drawn from a per-index seeded stream, so dataset contents are independent
of batch order and process count (same discipline as the sampler's
per-seed noise).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

_CLASS_PARAMS: Dict[str, Dict] = {
    # color: lesion RGB in [0,1]; radius: base radius fraction; wobble:
    # boundary irregularity amplitude; ring: annulus instead of disk;
    # speckle: internal dark speckle amplitude
    "MEL":  {"color": (0.22, 0.13, 0.10), "radius": 0.30, "wobble": 0.35,
             "ring": False, "speckle": 0.5},
    "NV":   {"color": (0.45, 0.28, 0.18), "radius": 0.22, "wobble": 0.08,
             "ring": False, "speckle": 0.1},
    "VASC": {"color": (0.75, 0.15, 0.15), "radius": 0.28, "wobble": 0.12,
             "ring": True,  "speckle": 0.0},
    # remaining ISIC classes reuse the three structural families with
    # shifted palettes so any class name from the taxonomy works
    "BCC":  {"color": (0.72, 0.45, 0.40), "radius": 0.20, "wobble": 0.20,
             "ring": False, "speckle": 0.3},
    "AKIEC": {"color": (0.80, 0.55, 0.45), "radius": 0.26, "wobble": 0.30,
              "ring": False, "speckle": 0.4},
    "BKL":  {"color": (0.40, 0.30, 0.20), "radius": 0.24, "wobble": 0.15,
             "ring": False, "speckle": 0.6},
    "DF":   {"color": (0.55, 0.40, 0.33), "radius": 0.16, "wobble": 0.10,
             "ring": True,  "speckle": 0.2},
}


def _low_freq_noise(rng: np.random.Generator, size: int, cells: int = 8,
                    amp: float = 1.0) -> np.ndarray:
    """Smooth noise: a coarse grid bilinearly upsampled to (size, size)."""
    coarse = rng.normal(0.0, 1.0, (cells, cells)).astype(np.float32)
    # separable bilinear upsample without scipy: interp along each axis
    src = np.linspace(0, cells - 1, size, dtype=np.float32)
    i0 = np.clip(src.astype(np.int32), 0, cells - 2)
    frac = src - i0
    rows = coarse[i0] * (1 - frac[:, None]) + coarse[i0 + 1] * frac[:, None]
    cols = rows[:, i0] * (1 - frac[None, :]) + rows[:, i0 + 1] * frac[None, :]
    return amp * cols


def _blend_params(p: Dict, q: Dict, w: float) -> Dict:
    """Interpolate two class-parameter dicts: scalars and colors lerp;
    the boolean `ring` crosses over at w=0.5 (so heavily blended images
    genuinely take the confuser's topology, not just its palette)."""
    out = {}
    for k in ("radius", "wobble", "speckle"):
        out[k] = (1.0 - w) * p[k] + w * q[k]
    out["color"] = tuple((1.0 - w) * np.asarray(p["color"])
                         + w * np.asarray(q["color"]))
    out["ring"] = q["ring"] if w > 0.5 else p["ring"]
    return out


def procedural_image(class_name: str, index: int, size: int = 128,
                     seed: int = 0, hard: float = 0.0) -> np.ndarray:
    """One (size,size,3) float32 image in [-1,1], fully determined by
    (class_name, index, seed, size, hard).

    `hard` in [0,1] controls class confusability (the
    default classes are so well separated that a classifier saturates at
    100% held-out accuracy, which degenerates every downstream CFI/stats
    distribution). With hard>0 each image's parameters are blended toward
    a per-index-random confuser class by w ~ U(0, hard): a share of
    images land near the decision boundary, so a classifier trained on
    the hard stream operates at realistic (non-saturated) accuracy with
    soft probability vectors — mirroring the reference's confusable
    7-class ISIC problem."""
    p = _CLASS_PARAMS.get(class_name, _CLASS_PARAMS["NV"])
    # stable across processes (Python's str hash is salted per run)
    import hashlib
    digest = hashlib.md5(
        f"{class_name}:{int(index)}:{int(seed)}".encode()).hexdigest()
    rng = np.random.default_rng(int(digest[:8], 16))
    if hard > 0.0:
        others = [c for c in _CLASS_PARAMS if c != class_name]
        confuser = others[int(rng.integers(len(others)))]
        w = float(rng.uniform(0.0, min(max(hard, 0.0), 1.0)))
        p = _blend_params(p, _CLASS_PARAMS[confuser], w)

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size - 0.5
    # skin background with gentle texture
    base = np.asarray([0.86, 0.70, 0.62], np.float32) \
        + rng.normal(0, 0.03, 3).astype(np.float32)
    img = np.broadcast_to(base, (size, size, 3)).copy()
    img += _low_freq_noise(rng, size, cells=6, amp=0.04)[..., None]

    # lesion mask: wobbly-radius disk (or annulus)
    cx, cy = rng.uniform(-0.08, 0.08, 2)
    ang = np.arctan2(yy - cy, xx - cx)
    rad = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    r0 = p["radius"] * rng.uniform(0.85, 1.15)
    wob = np.zeros_like(ang)
    for k in range(2, 6):
        wob += rng.normal(0, p["wobble"] / k) * np.sin(k * ang + rng.uniform(0, 6.28))
    boundary = r0 * (1.0 + wob)
    edge = 0.02 + 0.02 * rng.uniform()
    mask = 1.0 / (1.0 + np.exp((rad - boundary) / edge))      # soft disk
    if p["ring"]:
        inner = 1.0 / (1.0 + np.exp((rad - 0.55 * boundary) / edge))
        mask = np.clip(mask - inner, 0.0, 1.0)

    color = np.asarray(p["color"], np.float32) \
        + rng.normal(0, 0.02, 3).astype(np.float32)
    lesion = np.broadcast_to(color, (size, size, 3)).copy()
    if p["speckle"] > 0:
        spots = _low_freq_noise(rng, size, cells=16, amp=p["speckle"])
        lesion *= np.clip(1.0 - 0.5 * np.maximum(spots, 0.0), 0.3, 1.0)[..., None]
    img = img * (1.0 - mask[..., None]) + lesion * mask[..., None]
    img += rng.normal(0, 0.01, img.shape).astype(np.float32)  # sensor noise
    return (np.clip(img, 0.0, 1.0) * 2.0 - 1.0).astype(np.float32)


def procedural_images(class_name: str, n: int, size: int = 128,
                      seed: int = 0, start_index: int = 0,
                      hard: float = 0.0) -> np.ndarray:
    return np.stack([procedural_image(class_name, start_index + i, size,
                                      seed, hard=hard)
                     for i in range(n)])


class ProceduralDataset:
    """Training-dataset protocol (`batches(batch_size, rng)` + `__len__`)
    over the procedural distribution — drop-in for `train_class`.

    `device` (a torch device) puts the whole set there ONCE as one
    (N, H, W, C) f32 tensor and yields batches gathered on that device, so
    no per-step host->device batch copy is made. Without it, batches are
    host numpy arrays. The host rng draws the same permutations either way,
    so the batch SEQUENCE is identical to the JAX package's."""

    def __init__(self, class_name: str, n_images: int = 256,
                 image_size: int = 128, seed: int = 0, device=None):
        import torch

        self.class_name = class_name
        self.image_size = image_size
        # materialize once: n_images at 128² f32 is ~50 MB at n=256
        self.images = procedural_images(class_name, n_images, image_size, seed)
        self._device_images = (torch.from_numpy(self.images).to(device)
                               if device is not None else None)

    def __len__(self) -> int:
        return len(self.images)

    def _gather(self, idx: np.ndarray):
        if self._device_images is None:
            return self.images[idx]
        import torch

        return self._device_images[torch.from_numpy(idx).to(
            self._device_images.device)]

    def batches(self, batch_size: int, rng: np.random.Generator):
        order = rng.permutation(len(self.images))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            yield self._gather(order[start:start + batch_size])

    def epoch_batches(self, batch_size: int, rng: np.random.Generator):
        """The whole epoch's batches stacked (S,B,H,W,C) in one gather, for
        `train_class`'s epoch path. Draws the SAME rng permutation as
        `batches`, so the data order is path-independent."""
        order = rng.permutation(len(self.images))
        s = len(order) // batch_size
        return self._gather(order[: s * batch_size].reshape(s, batch_size))
