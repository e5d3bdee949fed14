"""DDPM training, per class and class-conditional (the port of
`synt_isic_tpu/train/` for `train_class`, `train_conditional` and their
entry point `python -m synt_isic_tpu_torch.train`)."""
from .data import SingleClassDataset, augment_image, enhance_color, prefetch
from .procedural import ProceduralDataset, procedural_image, procedural_images
from .train_conditional import LabeledMixtureDataset, train_conditional
from .train_ddpm import (TrainConfig, TrainState, create_train_state,
                         make_train_step, train_class)

__all__ = ["TrainConfig", "TrainState", "create_train_state",
           "make_train_step", "train_class", "train_conditional",
           "LabeledMixtureDataset", "SingleClassDataset",
           "ProceduralDataset", "procedural_image", "procedural_images",
           "augment_image", "enhance_color", "prefetch"]
