"""Fréchet distance between image-set feature distributions (FID).

The port of `synt_isic_tpu/metrics/fid.py` ("FID parity with the PyTorch
reference at fixed seeds", BASELINE.md). Two embeddings:

  * STANDARD: Inception-v3 pool3 (2048-d) — `InceptionFeatureExtractor`,
    used automatically when `checkpoints/inception_v3.pth` (torchvision
    weights: `python -m synt_isic_tpu_torch.app.download_models`, or
    `scripts/convert_inception.py` where torchvision is installed) is
    present. These numbers are comparable to published torchvision-FID
    figures.
  * FALLBACK: the lesion classifier's penultimate 512-d features
    (`ResNet18.penultimate`) — `FeatureExtractor`. With the SAME extractor
    on both sides the Fréchet distance remains a valid comparison metric
    between sample sets, but absolute values are NOT comparable to
    Inception-FID and results are labeled accordingly.

Feature extraction runs on the extractor's device (CUDA unless the caller
names another; raises without it) in chunks, under `torch.no_grad()`, with
its convolutions and matrix products in full f32: TF32 is switched off for
the extractor's own calls and restored afterwards, so an FID value does not
move with a process-wide TF32 setting. The Fréchet math (covariance sqrtm)
and the weight-free pixel embedding run on the host (numpy / scipy).
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Union

import numpy as np
import torch
from scipy import linalg

from ..generator import tf32_as_recorded
from ..model_manager import resolve_device
from ..models.classifier import LesionClassifier, preprocess_for_classifier
from ..models.inception_v3 import (POOL3_FEATURES, load_inception_params,
                                   preprocess_for_inception, random_inception)

# the TF32 switches as an f32 sidecar records them: both off
FULL_F32 = {"tf32": {"cudnn": False, "matmul": False}}


class FeatureExtractor:
    """Batched image -> classifier-feature embedding on the classifier's
    device. Without a classifier, the seeded random one on `device`."""

    def __init__(self, classifier: Optional[LesionClassifier] = None,
                 batch_size: int = 64,
                 device: Optional[Union[str, torch.device]] = None):
        self.classifier = classifier or LesionClassifier.random_init(device=device)
        self.batch_size = batch_size

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (N,H,W,3) float in [-1,1] -> (N,512) float32."""
        clf = self.classifier
        chunks = []
        with torch.no_grad(), tf32_as_recorded(FULL_F32):
            for start in range(0, len(images), self.batch_size):
                x = clf.as_input(images[start:start + self.batch_size])
                chunks.append(clf.model.penultimate(preprocess_for_classifier(x)).cpu().numpy())
        return np.concatenate(chunks) if chunks else np.zeros((0, 512), np.float32)


class InceptionFeatureExtractor:
    """Standard FID embedding: Inception-v3 pool3, 2048-d, batched on the
    device.

    `params_path=None` uses seeded random weights (`random_inception(0)`:
    structurally valid FID for tests; NOT comparable to published numbers —
    pass real torchvision weights for that). `dtype` is the convolutions'
    compute type (f32 by default, the reference's contract)."""

    def __init__(self, params_path: Optional[str] = None, batch_size: int = 32,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        if params_path:
            model = load_inception_params(params_path, dtype)
            self.pretrained = True
        else:
            model = random_inception(0, dtype)
            self.pretrained = False
        self.model = model.to(self.device).requires_grad_(False)
        self.batch_size = batch_size

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (N,H,W,3) float in [-1,1] -> (N,2048) float32."""
        chunks = []
        with torch.no_grad(), tf32_as_recorded(FULL_F32):
            for start in range(0, len(images), self.batch_size):
                x = torch.as_tensor(np.asarray(images[start:start + self.batch_size]),
                                    dtype=torch.float32).to(self.device)
                chunks.append(self.model.pool3_features(preprocess_for_inception(x))
                              .cpu().numpy())
        return (np.concatenate(chunks) if chunks
                else np.zeros((0, POOL3_FEATURES), np.float32))


class PixelFeatureExtractor:
    """Deterministic, weight-free embedding for Fréchet comparisons:
    average-pool each image to a (grid × grid) RGB thumbnail and flatten
    (grid²·3 dims).

    Captures the color distribution and coarse spatial structure with NO
    learned weights. This exists because a random-init CNN embedding is an
    unreliable judge — it can rank pure noise closer to data than visibly
    structured samples — so when neither Inception weights nor a trained
    classifier are available this is the trustworthy convergence check.
    Values are NOT comparable to Inception-FID."""

    def __init__(self, grid: int = 8):
        self.grid = int(grid)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (N,H,W,3) float in [-1,1] -> (N, grid²·3) float32.

        Cells are near-equal index buckets (no cropping), so the feature
        dimension is grid²·3 for ANY input size — image sets of different
        resolutions embed into the same space, like the CNN extractors."""
        arr = np.asarray(images, np.float32)
        g = self.grid
        # images smaller than the grid: nearest-neighbor upsample first
        if arr.shape[1] < g:
            arr = np.repeat(arr, -(-g // arr.shape[1]), axis=1)
        if arr.shape[2] < g:
            arr = np.repeat(arr, -(-g // arr.shape[2]), axis=2)
        n, h, w, c = arr.shape
        edges_r = np.linspace(0, h, g + 1).astype(np.int64)
        edges_c = np.linspace(0, w, g + 1).astype(np.int64)
        pooled = (np.add.reduceat(arr, edges_r[:-1], axis=1)
                  / np.diff(edges_r)[None, :, None, None])
        pooled = (np.add.reduceat(pooled, edges_c[:-1], axis=2)
                  / np.diff(edges_c)[None, None, :, None])
        return pooled.reshape(n, g * g * c)


def pixel_frechet(images_a: np.ndarray, images_b: np.ndarray,
                  grid: int = 8) -> float:
    """Fréchet distance in pooled-pixel space (see PixelFeatureExtractor)."""
    return compute_fid(images_a, images_b, PixelFeatureExtractor(grid))


def default_extractor(checkpoints_dir: str = "checkpoints",
                      require_standard: bool = False,
                      device: Optional[Union[str, torch.device]] = None):
    """Standard Inception-FID when the weights exist, classifier-feature
    fallback (clearly second) otherwise.

    `require_standard=True` turns the silent fallback into a hard error —
    for callers whose contract IS standard FID ("FID parity", BASELINE.md),
    a proxy number must never masquerade as it. The error names the
    one-command bootstrap."""
    path = os.path.join(checkpoints_dir, "inception_v3.pth")
    if os.path.exists(path):
        return InceptionFeatureExtractor(path, device=device)
    if require_standard:
        raise FileNotFoundError(
            f"standard FID requested but {path} is missing — run "
            f"`python -m synt_isic_tpu_torch.app.download_models` (fetches + "
            f"checksums + manifest-validates the torchvision InceptionV3 "
            f"weights) or scripts/convert_inception.py on a machine with "
            f"torchvision, then copy the file here. Refusing to fall back "
            f"to the classifier-feature proxy.")
    return FeatureExtractor(device=device)


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray,
                     mu2: np.ndarray, sigma2: np.ndarray,
                     eps: float = 1e-6) -> float:
    """||mu1-mu2||² + Tr(S1 + S2 - 2 (S1 S2)^{1/2})."""
    diff = mu1 - mu2
    # scipy >= 1.17 deprecates sqrtm(disp=) and returns the bare array from
    # a plain call; older scipys returned a tuple only when disp=False was
    # passed, so the plain call is portable both ways
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if isinstance(covmean, tuple):
        covmean = covmean[0]
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(images_a: np.ndarray, images_b: np.ndarray,
                extractor: Optional[Callable[[np.ndarray], np.ndarray]] = None,
                require_standard: bool = False) -> float:
    """Fréchet distance between two image sets ((N,H,W,3) in [-1,1]).

    Default extractor: standard Inception pool3 when
    `checkpoints/inception_v3.pth` exists, classifier-feature fallback
    otherwise (see `default_extractor`). `require_standard=True` raises
    instead of silently falling back."""
    extractor = extractor or default_extractor(require_standard=require_standard)
    fa = np.asarray(extractor(images_a), np.float64)
    fb = np.asarray(extractor(images_b), np.float64)
    mu_a, mu_b = fa.mean(axis=0), fb.mean(axis=0)
    sigma_a = np.cov(fa, rowvar=False)
    sigma_b = np.cov(fb, rowvar=False)
    return frechet_distance(mu_a, sigma_a, mu_b, sigma_b)
