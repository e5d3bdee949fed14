"""ResNet-18, the lesion classifier's backbone, as an `nn.Module`.

The port of `synt_isic_tpu/models/resnet18.py`. Its parameter names are
torchvision's `resnet18` (`conv1`, `bn1`, `layer1.0.conv1`, ...,
`layer2.0.downsample.0`, `fc`), so a torchvision-keyed `classifier.pth`
loads by name. NCHW inside. BatchNorm is frozen (eval-mode statistics
only, as the classifier is only ever run in eval mode): y = (x - mean) *
rsqrt(var + eps) * weight + bias.

`penultimate` gives the 512-d pooled features before `fc` (the
classifier-feature FID embedding). `features_and_logits` also returns
the Grad-CAM target activation, the output of `layer4[-1].conv2` (the
last block's `pre_activation`), and the last block's input, so
`logits_from_activation` can rerun the tail from a perturbed activation.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class FrozenBatchNorm(nn.Module):
    """Eval-mode BatchNorm over NCHW channels, with torchvision's names
    (`weight`, `bias`, `running_mean`, `running_var`)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


class BasicBlock(nn.Module):
    """Two 3x3 convolutions with an identity or projection shortcut."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(features)
        self.downsample = (nn.Sequential(nn.Conv2d(in_features, features, 1, stride=stride,
                                                   bias=False),
                                         FrozenBatchNorm(features))
                           if stride != 1 or in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.post_activation(self.pre_activation(x), x)

    def pre_activation(self, x: torch.Tensor) -> torch.Tensor:
        """Block input -> conv2 output (the Grad-CAM target activation)."""
        return self.conv2(F.relu(self.bn1(self.conv1(x))))

    def post_activation(self, act: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(conv2 output, block input) -> block output."""
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.bn2(act) + identity)


@dataclasses.dataclass(frozen=True)
class ResNet18Config:
    num_classes: int = 7
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    stage_features: Tuple[int, ...] = (64, 128, 256, 512)


class ResNet18(nn.Module):
    """NCHW ResNet-18. `forward` returns logits."""

    def __init__(self, config: ResNet18Config = ResNet18Config()):
        super().__init__()
        self.config = config
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        in_features = 64
        for stage, (size, feats) in enumerate(zip(config.stage_sizes, config.stage_features),
                                              start=1):
            blocks = []
            for i in range(size):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(BasicBlock(in_features, feats, stride))
                in_features = feats
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_features, config.num_classes)

    def _layers(self):
        return [getattr(self, f"layer{s}") for s in range(1, len(self.config.stage_sizes) + 1)]

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, stride=2, padding=1)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(x.mean(dim=(2, 3)))

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = self._stem(x)
        for layer in self._layers():
            x = layer(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._head(self._features(x))

    def penultimate(self, x: torch.Tensor) -> torch.Tensor:
        """The 512-d globally pooled features before `fc`, in f32: the
        classifier-feature FID embedding (`metrics/fid.py`)."""
        return self._features(x).mean(dim=(2, 3)).float()

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Everything before the last block: the last block's input."""
        x = self._stem(x)
        layers = self._layers()
        for layer in layers[:-1]:
            x = layer(x)
        return layers[-1][:-1](x)

    def features_and_logits(self, x: torch.Tensor):
        """(logits, act, block_input): act is `layer4[-1].conv2`'s output,
        the Grad-CAM target, and block_input the last block's input."""
        block_input = self.trunk(x)
        act = self._layers()[-1][-1].pre_activation(block_input)
        return self.logits_from_activation(act, block_input), act, block_input

    def logits_from_activation(self, act: torch.Tensor,
                               block_input: torch.Tensor) -> torch.Tensor:
        """Logits from a (possibly perturbed) target activation, the last
        block's input held fixed."""
        return self._head(self._layers()[-1][-1].post_activation(act, block_input))
