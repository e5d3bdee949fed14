"""Lesion-classifier training: ResNet-18 with trainable BatchNorm.

The port of `synt_isic_tpu/train/train_classifier.py`: a trainable
ResNet-18 (torchvision's parameter names, BatchNorm with running
statistics), cross-entropy with Adam over `MultiClassDataset` batches, and
export of `classifier.pth`, the file the XAI engine's
`LesionClassifier.from_checkpoint` loads.

Compute follows the JAX model: convolutions in `dtype` (bf16 by default)
on f32 weights, BatchNorm statistics and arithmetic in f32, the pooled
features and logits in f32. BatchNorm follows Flax's (`momentum=0.9`):
the batch variance is the biased E[x^2] - E[x]^2 (clipped at 0), and the
running variance is updated with that biased value, where
`nn.BatchNorm2d` would take the unbiased one.

What differs from the JAX trainer: PyTorch runs eagerly (one call per
step, the model updated in place); the initial weights come from a seeded
`torch` generator (kernels ~ N(0, 1/fan_in)), not from Flax's initialisers;
host batches are prepared in the background while the device trains.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..io.pth import save_checkpoint
from ..model_manager import resolve_device
from ..models.unet2d import Conv2d


class TrainableBatchNorm(nn.Module):
    """Flax `BatchNorm(momentum=0.9, epsilon=1e-5, dtype=f32)` over NCHW
    channels, with torchvision's names (`weight`, `bias`, `running_mean`,
    `running_var`). Training mode normalises with the batch statistics and
    moves the running ones by `momentum` (0.1 in torch's convention);
    eval mode normalises with the running ones."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp(x.square().mean(dim=(0, 2, 3)) - mean.square(), min=0.0)
            with torch.no_grad():
                keep = 1.0 - self.momentum
                self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
                self.running_var.copy_(keep * self.running_var + self.momentum * var)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class TrainBasicBlock(nn.Module):
    """Two 3x3 convolutions with an identity or projection shortcut; the
    shortcut joins in the f32 of the BatchNorm output."""

    def __init__(self, in_features: int, features: int, stride: int, dtype: torch.dtype):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, param_dtype=torch.float32)
        self.conv1 = Conv2d(in_features, features, 3, stride=stride, padding=1, **kw)
        self.bn1 = TrainableBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, **kw)
        self.bn2 = TrainableBatchNorm(features)
        self.downsample = (nn.Sequential(Conv2d(in_features, features, 1, stride=stride, **kw),
                                         TrainableBatchNorm(features))
                           if stride != 1 or in_features != features else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity.to(out.dtype))


class ResNet18Trainable(nn.Module):
    """The JAX `ResNet18Trainable`: the topology and names of the inference
    `models/resnet18.ResNet18`, with live BatchNorm. Input NCHW
    (ImageNet-normalised), output f32 logits."""

    def __init__(self, num_classes: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype,
                            param_dtype=torch.float32)
        self.bn1 = TrainableBatchNorm(64)
        in_features = 64
        for stage, feats in enumerate((64, 128, 256, 512), start=1):
            blocks = []
            for i in range(2):
                stride = 2 if (stage > 1 and i == 0) else 1
                blocks.append(TrainBasicBlock(in_features, feats, stride, dtype))
                in_features = feats
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
        self.fc = nn.Linear(in_features, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        # Flax's max_pool pads with -inf, as max_pool2d does
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
        return self.fc(x.mean(dim=(2, 3)).float())


@dataclasses.dataclass(frozen=True)
class ClassifierTrainConfig:
    num_classes: int = 7
    image_size: int = 224
    batch_size: int = 16
    learning_rate: float = 1e-4
    epochs: int = 20
    bf16_compute: bool = True
    seed: int = 0


@dataclasses.dataclass
class ClassifierTrainState:
    """The model (updated in place, batch statistics included), its Adam and
    the count of steps taken."""
    model: ResNet18Trainable
    optimizer: torch.optim.Adam
    step: int = 0


def create_classifier_train_state(config: ClassifierTrainConfig,
                                  device=None) -> ClassifierTrainState:
    """A seeded ResNet18Trainable on `device` (kernels ~ N(0, 1/fan_in),
    biases 0, BatchNorm the identity) in training mode, and Adam (optax's
    defaults) at the config's constant lr."""
    model = ResNet18Trainable(config.num_classes,
                              torch.bfloat16 if config.bf16_compute else torch.float32)
    g = torch.Generator().manual_seed(int(config.seed))
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
    model = model.to(resolve_device(device)).train()
    optimizer = torch.optim.Adam(model.parameters(), lr=config.learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    return ClassifierTrainState(model=model, optimizer=optimizer)


def make_classifier_train_step() -> Callable:
    """(state, images, labels) -> (loss, acc), 0-d f32 tensors on the
    device (no host sync). `images` are NHWC ImageNet-normalised, `labels`
    class ids. One Adam step on the cross-entropy of the train-mode logits;
    the BatchNorm running statistics move by one batch."""

    def step(state: ClassifierTrainState, images, labels):
        dev = next(state.model.parameters()).device
        images = torch.as_tensor(images).to(dev, torch.float32).permute(0, 3, 1, 2)
        labels = torch.as_tensor(labels).to(dev).long()
        logits = state.model(images)
        loss = F.cross_entropy(logits, labels)
        acc = (torch.argmax(logits, dim=-1) == labels).float().mean()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return loss.detach(), acc

    return step


def to_inference_tree(state: ClassifierTrainState) -> Dict[str, torch.Tensor]:
    """The weights and BatchNorm statistics as the frozen inference
    `models/resnet18.ResNet18` loads them (torchvision's names)."""
    return {k: v.detach() for k, v in state.model.state_dict().items()}


def export_classifier_pth(state: ClassifierTrainState, path: str) -> None:
    """Write `classifier.pth` in torchvision's layout (what
    `LesionClassifier.from_checkpoint` and the reference's loader read)."""
    save_checkpoint(to_inference_tree(state), path)


def train_classifier(dataset_iter_fn, config: ClassifierTrainConfig,
                     checkpoint_path: str = "checkpoints/classifier.pth",
                     log=print, device=None) -> Dict[str, Any]:
    """dataset_iter_fn(epoch) must yield (images NHWC ImageNet-normalised,
    labels) batches. Every epoch whose accuracy is at least the best so far
    writes `checkpoint_path` through the async writer (only the newest
    queued write is kept). `device`: CUDA unless the caller names another."""
    from .async_ckpt import AsyncCheckpointer
    from .data import prefetch

    state = create_classifier_train_state(config, device)
    step_fn = make_classifier_train_step()
    best_acc = 0.0
    history = []
    writer = AsyncCheckpointer(log=log)
    loop_ok = False
    try:
        for epoch in range(1, config.epochs + 1):
            losses, accs = [], []
            for images, labels in prefetch(dataset_iter_fn(epoch)):
                loss, acc = step_fn(state, images, labels)
                losses.append(loss)
                accs.append(acc)
            # one host read per epoch
            epoch_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            epoch_acc = float(torch.stack(accs).mean()) if accs else 0.0
            history.append({"loss": epoch_loss, "acc": epoch_acc})
            log(f"[clf] epoch {epoch}/{config.epochs} loss={epoch_loss:.4f} "
                f"acc={epoch_acc:.3f}")
            if epoch_acc >= best_acc:
                best_acc = epoch_acc
                Path(checkpoint_path).parent.mkdir(parents=True, exist_ok=True)
                writer.submit(to_inference_tree(state), save_checkpoint,
                              checkpoint_path, coalesce="best")
        loop_ok = True
    finally:
        # flush queued writes; don't mask a training error with a writer one
        try:
            writer.close()
        except Exception:
            if loop_ok:
                raise
    return {"best_acc": best_acc, "history": history,
            "checkpoint": checkpoint_path, "state": state}


__all__ = ["TrainableBatchNorm", "ResNet18Trainable", "ClassifierTrainConfig",
           "ClassifierTrainState", "create_classifier_train_state",
           "make_classifier_train_step", "to_inference_tree", "export_classifier_pth",
           "train_classifier"]
