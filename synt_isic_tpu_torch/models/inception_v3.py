"""Inception-v3, the standard FID embedding network (pool3, 2048-d).

The port of `synt_isic_tpu/models/inception_v3.py`, as an `nn.Module` with
torchvision's `inception_v3` module names (`Conv2d_1a_3x3` ... `Mixed_7c`,
`branch1x1` / `branch5x5_1` / ..., `conv` and `bn` inside `BasicConv2d`),
so a torchvision state dict (`checkpoints/inception_v3.pth`, aux head
dropped) loads with `load_state_dict(strict=True)`. NCHW inside.

Torchvision's eval-mode semantics, as the JAX package implements them:
BatchNorm frozen at eps 1e-3 (`BasicConv2d`), the pool branches' 3x3
average pool with `count_include_pad=True` (summed in f32), 3x3 stride-2
max pools without padding, ImageNet normalisation and `transform_input`'s
recentering. Its FID numbers are "torchvision-FID" (pytorch-fid's
TF-ported network pools differently).

`dtype` is the convolutions' compute type, as the JAX module's: the
weights stay f32, each BatchNorm computes in f32 and each `BasicConv2d`
output is cast back to `dtype`; the pooled features are f32.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io.manifest import validate_state_dict
from ..io.pth import load_checkpoint
from ..ops.resize import resize_bilinear
from .resnet18 import FrozenBatchNorm

# ImageNet normalisation (torchvision transforms for inception_v3)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INCEPTION_IMAGE_SIZE = 299
POOL3_FEATURES = 2048


class BasicConv2d(nn.Module):
    """Bias-free conv -> frozen BatchNorm (eps 1e-3, f32) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 padding=0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x.to(self.dtype), self.conv.weight.to(self.dtype), None,
                     self.conv.stride, self.conv.padding)
        return F.relu(self.bn(x.float())).to(self.dtype)


def _avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """`F.avg_pool2d(x, 3, 1, 1)` with `count_include_pad=True`, in f32."""
    return F.avg_pool2d(x.float(), 3, stride=1, padding=1,
                        count_include_pad=True).to(x.dtype)


def _max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, dtype: torch.dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1), dtype=dtype)
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1), dtype=dtype)
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=2, dtype=dtype)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1, dtype=dtype)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=1, dtype=dtype)
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionB(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2, dtype=dtype)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=1, dtype=dtype)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, dtype: torch.dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1), dtype=dtype)
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1), dtype=dtype)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), dtype=dtype)
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0), dtype=dtype)
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1), dtype=dtype)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), dtype=dtype)
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3), dtype=dtype)
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0), dtype=dtype)
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3), dtype=dtype)
        self.branch_pool = BasicConv2d(cin, 192, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionD(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1), dtype=dtype)
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2, dtype=dtype)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1), dtype=dtype)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3), dtype=dtype)
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0), dtype=dtype)
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, dtype: torch.dtype):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1), dtype=dtype)
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1), dtype=dtype)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), dtype=dtype)
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), dtype=dtype)
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1), dtype=dtype)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=1, dtype=dtype)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1), dtype=dtype)
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0), dtype=dtype)
        self.branch_pool = BasicConv2d(cin, 192, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(_avg_pool_3x3(x))], dim=1)


class InceptionV3(nn.Module):
    """torchvision `inception_v3` in eval mode, without the aux head.

    `transform_input=True` replays torchvision's recentering for the
    pretrained weights (it expects ImageNet-normalised input)."""

    def __init__(self, num_classes: int = 1000, transform_input: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transform_input = transform_input
        self.dtype = dtype
        d = dtype
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2, dtype=d)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3), dtype=d)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=1, dtype=d)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1), dtype=d)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3), dtype=d)
        self.Mixed_5b = InceptionA(192, 32, d)
        self.Mixed_5c = InceptionA(256, 64, d)
        self.Mixed_5d = InceptionA(288, 64, d)
        self.Mixed_6a = InceptionB(288, d)
        self.Mixed_6b = InceptionC(768, 128, d)
        self.Mixed_6c = InceptionC(768, 160, d)
        self.Mixed_6d = InceptionC(768, 160, d)
        self.Mixed_6e = InceptionC(768, 192, d)
        self.Mixed_7a = InceptionD(768, d)
        self.Mixed_7b = InceptionE(1280, d)
        self.Mixed_7c = InceptionE(2048, d)
        self.fc = nn.Linear(POOL3_FEATURES, num_classes)

    def _transform_input(self, x: torch.Tensor) -> torch.Tensor:
        if not self.transform_input:
            return x
        return torch.stack([x[:, c] * (s / 0.5) + (m - 0.5) / 0.5
                            for c, (m, s) in enumerate(zip(IMAGENET_MEAN, IMAGENET_STD))],
                           dim=1)

    def pool3_features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, 299, 299) ImageNet-normalised -> (B, 2048) f32 pool3
        features (the FID embedding)."""
        x = self._transform_input(x).to(self.dtype)
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool_3x3_s2(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool_3x3_s2(x)
        for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e", "7a", "7b", "7c"):
            x = getattr(self, f"Mixed_{name}")(x)
        return x.float().mean(dim=(2, 3))   # adaptive average pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.pool3_features(x))


def preprocess_for_inception(images: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC (any size) -> (B, 3, 299, 299) ImageNet-normalised,
    resized as `jax.image.resize` does (`ops/resize.py`)."""
    x = ((images.float() + 1.0) / 2.0).permute(0, 3, 1, 2)
    x = resize_bilinear(x, (INCEPTION_IMAGE_SIZE, INCEPTION_IMAGE_SIZE))
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def expected_inception_state_shapes(num_classes: int = 1000) -> Dict[str, tuple]:
    """torchvision inception_v3 state-dict manifest (aux head excluded —
    the loader drops `AuxLogits.*`)."""
    keys: Dict[str, tuple] = {}

    def conv(prefix, cout, cin, kh, kw):
        keys[f"{prefix}.conv.weight"] = (cout, cin, kh, kw)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            keys[f"{prefix}.bn.{leaf}"] = (cout,)

    conv("Conv2d_1a_3x3", 32, 3, 3, 3)
    conv("Conv2d_2a_3x3", 32, 32, 3, 3)
    conv("Conv2d_2b_3x3", 64, 32, 3, 3)
    conv("Conv2d_3b_1x1", 80, 64, 1, 1)
    conv("Conv2d_4a_3x3", 192, 80, 3, 3)

    def inception_a(prefix, cin, pool):
        conv(f"{prefix}.branch1x1", 64, cin, 1, 1)
        conv(f"{prefix}.branch5x5_1", 48, cin, 1, 1)
        conv(f"{prefix}.branch5x5_2", 64, 48, 5, 5)
        conv(f"{prefix}.branch3x3dbl_1", 64, cin, 1, 1)
        conv(f"{prefix}.branch3x3dbl_2", 96, 64, 3, 3)
        conv(f"{prefix}.branch3x3dbl_3", 96, 96, 3, 3)
        conv(f"{prefix}.branch_pool", pool, cin, 1, 1)

    inception_a("Mixed_5b", 192, 32)
    inception_a("Mixed_5c", 256, 64)
    inception_a("Mixed_5d", 288, 64)

    conv("Mixed_6a.branch3x3", 384, 288, 3, 3)
    conv("Mixed_6a.branch3x3dbl_1", 64, 288, 1, 1)
    conv("Mixed_6a.branch3x3dbl_2", 96, 64, 3, 3)
    conv("Mixed_6a.branch3x3dbl_3", 96, 96, 3, 3)

    def inception_c(prefix, c7):
        conv(f"{prefix}.branch1x1", 192, 768, 1, 1)
        conv(f"{prefix}.branch7x7_1", c7, 768, 1, 1)
        conv(f"{prefix}.branch7x7_2", c7, c7, 1, 7)
        conv(f"{prefix}.branch7x7_3", 192, c7, 7, 1)
        conv(f"{prefix}.branch7x7dbl_1", c7, 768, 1, 1)
        conv(f"{prefix}.branch7x7dbl_2", c7, c7, 7, 1)
        conv(f"{prefix}.branch7x7dbl_3", c7, c7, 1, 7)
        conv(f"{prefix}.branch7x7dbl_4", c7, c7, 7, 1)
        conv(f"{prefix}.branch7x7dbl_5", 192, c7, 1, 7)
        conv(f"{prefix}.branch_pool", 192, 768, 1, 1)

    inception_c("Mixed_6b", 128)
    inception_c("Mixed_6c", 160)
    inception_c("Mixed_6d", 160)
    inception_c("Mixed_6e", 192)

    conv("Mixed_7a.branch3x3_1", 192, 768, 1, 1)
    conv("Mixed_7a.branch3x3_2", 320, 192, 3, 3)
    conv("Mixed_7a.branch7x7x3_1", 192, 768, 1, 1)
    conv("Mixed_7a.branch7x7x3_2", 192, 192, 1, 7)
    conv("Mixed_7a.branch7x7x3_3", 192, 192, 7, 1)
    conv("Mixed_7a.branch7x7x3_4", 192, 192, 3, 3)

    def inception_e(prefix, cin):
        conv(f"{prefix}.branch1x1", 320, cin, 1, 1)
        conv(f"{prefix}.branch3x3_1", 384, cin, 1, 1)
        conv(f"{prefix}.branch3x3_2a", 384, 384, 1, 3)
        conv(f"{prefix}.branch3x3_2b", 384, 384, 3, 1)
        conv(f"{prefix}.branch3x3dbl_1", 448, cin, 1, 1)
        conv(f"{prefix}.branch3x3dbl_2", 384, 448, 3, 3)
        conv(f"{prefix}.branch3x3dbl_3a", 384, 384, 1, 3)
        conv(f"{prefix}.branch3x3dbl_3b", 384, 384, 3, 1)
        conv(f"{prefix}.branch_pool", 192, cin, 1, 1)

    inception_e("Mixed_7b", 1280)
    inception_e("Mixed_7c", 2048)

    keys["fc.weight"] = (num_classes, 2048)
    keys["fc.bias"] = (num_classes,)
    return keys


def random_inception_state(seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded random state dict in torchvision's names, from numpy:
    conv kernels ~ N(0, 2/fan_in) (He, so activations keep their scale
    through the ReLUs), BatchNorm weights ~ 1 + N(0, 0.1^2), biases and
    means ~ N(0, 0.1^2), variances ~ U(0.5, 1.5) (positive), fc ~ N(0,
    1/2048) with a zero bias. No trained weights are in the repository:
    tests and chip runs load this into both packages."""
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, shape in expected_inception_state_shapes().items():
        leaf = key.rsplit(".", 1)[-1]
        if key == "fc.bias":
            value = np.zeros(shape)
        elif len(shape) > 1:
            value = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif leaf == "running_var":
            value = rng.uniform(0.5, 1.5, shape)
        elif leaf == "weight":
            value = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            value = 0.1 * rng.standard_normal(shape)
        state[key] = value.astype(np.float32)
    return state


def random_inception(seed: int = 0, dtype: torch.dtype = torch.float32) -> InceptionV3:
    """`InceptionV3` (eval mode, on the CPU) with `random_inception_state(seed)`."""
    model = InceptionV3(dtype=dtype)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           random_inception_state(seed).items()}, strict=True)
    return model.eval()


def load_inception_params(path: str, dtype: torch.dtype = torch.float32) -> InceptionV3:
    """torchvision inception_v3 `.pth` -> validated `InceptionV3` (eval
    mode, on the CPU). `AuxLogits.*` and BatchNorm's `num_batches_tracked`
    are dropped; any other missing, unexpected or misshapen key raises."""
    state = {k: v for k, v in load_checkpoint(path).items()
             if not k.startswith("AuxLogits.") and not k.endswith("num_batches_tracked")}
    problems = validate_state_dict(state, expected_inception_state_shapes())
    if problems:
        preview = "; ".join(problems[:5])
        raise ValueError(f"not a torchvision inception_v3 state dict: {preview}"
                         + (f" (+{len(problems) - 5} more)" if len(problems) > 5 else ""))
    model = InceptionV3(dtype=dtype)
    model.load_state_dict(state, strict=True)
    return model.eval()
