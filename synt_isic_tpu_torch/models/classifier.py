"""The lesion classifier: diffusion-space images -> class scores.

The port of `synt_isic_tpu/models/classifier.py`:
  * `preprocess_for_classifier`: [-1,1] NHWC -> clip to [0,1] -> bilinear
    resize to 224 as `jax.image.resize` does it (`ops/resize.py`: half-pixel
    centres, antialiased when an image larger than 224 shrinks) ->
    ImageNet normalisation, as NCHW for the model;
  * `get_probabilities` = softmax(logits), `get_per_class_score` =
    log(p_c + 1e-8), `predict` = argmax, `get_confidence`;
  * `from_checkpoint`: a torchvision-keyed `.pth` (a `model.` or `module.`
    prefix and a `model_state_dict` wrapper are taken off) merged by name
    over a seeded random init where the shapes agree, with the {loaded,
    skipped} counts; the XAI path builds NUM_CLASSES + 1 = 8 outputs.

Images come in as NHWC arrays or tensors, as the sampler gives them; the
classifier moves them to its device. Its weights never need a gradient, so
they have none: `input_gradient` differentiates the input alone.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..io.pth import load_checkpoint
from ..model_manager import resolve_device
from ..ops.resize import resize_bilinear
from .resnet18 import ResNet18, ResNet18Config

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLASSIFIER_IMAGE_SIZE = 224
SCORE_EPS = 1e-8


def preprocess_for_classifier(x: torch.Tensor,
                              size: int = CLASSIFIER_IMAGE_SIZE) -> torch.Tensor:
    """(B,H,W,3) in [-1,1] -> (B,3,size,size) ImageNet-normalised. The
    clip is `jnp.clip`'s max-then-min, so a pixel exactly at 0 or 1 takes
    half the gradient, as in the JAX package (`torch.clamp` would pass all
    of it)."""
    x = (x + 1.0) / 2.0
    x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))
    x = resize_bilinear(x.permute(0, 3, 1, 2), (size, size))
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def random_resnet(num_classes: int = 7, seed: int = 0) -> ResNet18:
    """A ResNet-18 with seeded random weights: kernels ~ N(0, 1/fan_in),
    biases 0, BatchNorm the identity (Flax's defaults, untruncated)."""
    model = ResNet18(ResNet18Config(num_classes=num_classes))
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim > 1:
                fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=g) / fan_in ** 0.5)
            elif name == "fc.bias":
                p.zero_()
    return model


class LesionClassifier:
    """A ResNet-18 on a device, with the reference's scoring API."""

    def __init__(self, model: ResNet18,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.num_classes = model.config.num_classes

    # -- constructors --------------------------------------------------------------
    @classmethod
    def random_init(cls, num_classes: int = 7, seed: int = 0,
                    device: Optional[Union[str, torch.device]] = None) -> "LesionClassifier":
        return cls(random_resnet(num_classes, seed), device=device)

    @classmethod
    def from_checkpoint(cls, path: str, num_classes: int = 7, seed: int = 0,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Tuple["LesionClassifier", Dict[str, int]]:
        """Shape-compatible partial load over a seeded random init. Returns
        the classifier and the {loaded, skipped} counts."""
        model = random_resnet(num_classes, seed)
        state = _strip_prefix(load_checkpoint(path))
        loaded, skipped = _merge_compatible(model, state)
        return cls(model, device=device), {"loaded": loaded, "skipped": skipped}

    # -- inputs ----------------------------------------------------------------------
    def as_input(self, x) -> torch.Tensor:
        """NHWC (or one HWC image) as a batched f32 tensor on the device.
        A tensor made under `torch.inference_mode()` (a trajectory the
        sampler kept on the device) is copied, so autograd can take it."""
        x = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
        x = x.detach().to(self.device, torch.float32)
        if x.is_inference():
            x = x.clone()
        return x[None] if x.ndim == 3 else x

    # -- forwards ----------------------------------------------------------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(preprocess_for_classifier(x))

    def _scores(self, x: torch.Tensor, target_class: int) -> torch.Tensor:
        probs = torch.softmax(self._logits(x), dim=-1)
        return torch.log(probs[:, target_class] + SCORE_EPS)

    def logits(self, x) -> torch.Tensor:
        with torch.no_grad():
            return self._logits(self.as_input(x))

    def get_probabilities(self, x) -> torch.Tensor:
        return torch.softmax(self.logits(x), dim=-1)

    def get_per_class_score(self, x, target_class: int) -> torch.Tensor:
        """log p(c|x) + eps-stabilised."""
        return torch.log(self.get_probabilities(x)[:, target_class] + SCORE_EPS)

    def predict(self, x) -> torch.Tensor:
        return torch.argmax(self.logits(x), dim=-1)

    def get_confidence(self, x, target_class: int) -> torch.Tensor:
        return self.get_probabilities(x)[:, target_class]

    # -- functional views for XAI -----------------------------------------------------
    def score_fn(self, target_class: int) -> Callable[[torch.Tensor], torch.Tensor]:
        """Per-image score function of an NHWC tensor, differentiable."""
        return lambda x: self._scores(x, int(target_class))

    def input_gradient(self, x, target_class: int) -> torch.Tensor:
        """d score / d input per image (the gradient of the summed score:
        frozen BatchNorm keeps every image's score its own)."""
        x = self.as_input(x).requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(self._scores(x, int(target_class)).sum(), x)
        return grad

    def gradcam_tensors(self, x):
        """(logits, target-layer activation, block input) for Grad-CAM."""
        with torch.no_grad():
            return self.model.features_and_logits(preprocess_for_classifier(self.as_input(x)))

    def logits_from_activation(self, act: torch.Tensor,
                               block_input: torch.Tensor) -> torch.Tensor:
        return self.model.logits_from_activation(act, block_input)


def _strip_prefix(state: Dict[str, torch.Tensor],
                  prefixes=("module.", "model.")) -> Dict[str, torch.Tensor]:
    """Take off the first matching wrapper prefix of each key, and drop
    BatchNorm's `num_batches_tracked` (not a weight)."""
    out = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        for prefix in prefixes:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        out[key] = value
    return out


def _merge_compatible(model: ResNet18, src: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """Copy entries of `src` into `model` where name and shape match; count
    the rest as skipped."""
    dst = model.state_dict()
    loaded = skipped = 0
    with torch.no_grad():
        for key, value in src.items():
            if key in dst and tuple(value.shape) == tuple(dst[key].shape):
                dst[key].copy_(value.to(dst[key].dtype))
                loaded += 1
            else:
                skipped += 1
    return loaded, skipped
