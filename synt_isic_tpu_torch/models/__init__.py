from .unet2d import UNet2D, UNet2DConfig
from .resnet18 import ResNet18, ResNet18Config

__all__ = ["UNet2D", "UNet2DConfig", "ResNet18", "ResNet18Config"]
