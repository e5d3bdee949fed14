from .unet2d import UNet2D, UNet2DConfig

__all__ = ["UNet2D", "UNet2DConfig"]
