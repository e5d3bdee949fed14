"""synt_isic_tpu_torch — the PyTorch/CUDA port of synt_isic_tpu.

Per-class DDPM generation of ISIC-2018 skin-lesion images on an NVIDIA
Hopper GPU: the same checkpoints (diffusers-keyed `.pth`), the same UNet2D
and DDPM/DDIM walk, with the JAX package's Pallas attention kernel replaced
by a hand-written CUDA kernel (`csrc/attention_fwd.cu`). The JAX package
`synt_isic_tpu` stays the reference; nothing here imports it.
"""
from .version import __version__
from .utils.config import CLASS_NAMES, NUM_CLASSES


def __getattr__(name):  # lazy: keep bare `import synt_isic_tpu_torch` light
    if name == "ModelManager":
        from .model_manager import ModelManager
        return ModelManager
    if name == "ConsoleGenerator":
        from .cli import ConsoleGenerator
        return ConsoleGenerator
    raise AttributeError(name)


__all__ = [
    "__version__",
    "CLASS_NAMES",
    "NUM_CLASSES",
    "ModelManager",
    "ConsoleGenerator",
]
