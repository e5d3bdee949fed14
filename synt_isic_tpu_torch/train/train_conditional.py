"""Class-conditional DDPM training: ONE model for every ISIC class.

The port of `synt_isic_tpu/train/train_conditional.py`. The reference
trains seven per-class UNets; this trainer trains a single UNet2D with a
class-embedding table (diffusers `num_class_embeds`; the last row is the
null class) on the mixed-class stream, with classifier-free-guidance label
dropout (`TrainConfig.cond_dropout`). One resident model then serves every
class: `ModelManager(conditional=True)`, mixed-class device blocks in
`ImageGenerator`, and a guidance weight at sampling time.

It runs the whole `train_class` loop (EMA, probe-based best selection,
async checkpoints, resume); labelled batches go through it as `(images,
labels)` tuples. On CUDA the default model is the trainer's flagship (bf16
compute on f32 parameters, the attention kernels, the f32-statistics
GroupNorm). Artifacts:
  * `unet_conditional_best.pth`: the diffusers-keyed state dict, with
    `class_embedding.weight`;
  * `unet_conditional_best.json`: the class list (embedding rows in order),
    the table size and the null row, written before training starts so a
    crashed run never leaves a checkpoint that cannot be loaded;
  * per-class colour statistics for the generator's postprocessing.
`mesh=` trains data-parallel through `train_class(mesh=)` (reference
`train_conditional.py:146, 171`); across processes the metadata and the
statistics are written by process 0.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..model_manager import resolve_device
from ..models.unet2d import UNet2D
from ..parallel import multihost
from .data import augment_image
from .train_ddpm import TrainConfig, dataset_color_statistics, default_model, train_class


class LabeledMixtureDataset:
    """Per-class datasets mixed into one labelled stream.

    Takes the per-class dataset kinds `train_class` takes: materialized
    sets with `.images` ((N, H, W, C) in [-1, 1], `ProceduralDataset`) are
    pooled, and their device copies pooled on the device where every class
    has one, so an epoch gathers there; lazy sets with `load_raw(i)`
    ([0, 1], `SingleClassDataset`) are loaded and augmented per image from
    per-image rng streams. Labels index `class_names` (the input dict's
    order), the embedding rows the checkpoint metadata records.
    `epoch_batches` (one gather per epoch) is bound only when every class
    is materialized.
    """

    def __init__(self, class_datasets: Dict[str, Any], image_size: int = 128):
        if not class_datasets:
            raise ValueError("no class datasets given")
        self.class_names = list(class_datasets)
        self.datasets = class_datasets
        self.image_size = image_size
        pools = [getattr(class_datasets[c], "images", None) for c in self.class_names]
        self._materialized = all(p is not None for p in pools)
        if self._materialized:
            self.images = np.concatenate([np.asarray(p) for p in pools])
            self.labels = np.concatenate(
                [np.full(len(p), ci, np.int32) for ci, p in enumerate(pools)])
            dev_pools = [getattr(class_datasets[c], "_device_images", None)
                         for c in self.class_names]
            self._device_images = (torch.cat(dev_pools)
                                   if all(p is not None for p in dev_pools) else None)
            # train_class takes the one-gather path where this exists
            self.epoch_batches = self._epoch_batches
        else:
            self._index = [(ci, ii) for ci, c in enumerate(self.class_names)
                           for ii in range(len(class_datasets[c]))]

    def __len__(self) -> int:
        return len(self.images) if self._materialized else len(self._index)

    def _gather(self, idx: np.ndarray):
        if self._device_images is None:
            return self.images[idx], self.labels[idx]
        pool = self._device_images
        return pool[torch.from_numpy(idx).to(pool.device)], self.labels[idx]

    def batches(self, batch_size: int, rng: np.random.Generator):
        """Yields (images (B, H, W, C) f32 in [-1, 1], labels (B,) int32)."""
        order = rng.permutation(len(self))
        if self._materialized:
            for start in range(0, len(order) - batch_size + 1, batch_size):
                yield self._gather(order[start:start + batch_size])
            return
        img_seeds = rng.integers(0, np.iinfo(np.int64).max, size=len(order))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            imgs, labels = [], []
            for k in range(start, start + batch_size):
                ci, ii = self._index[int(order[k])]
                ds = self.datasets[self.class_names[ci]]
                img_rng = np.random.default_rng(int(img_seeds[k]))
                imgs.append(augment_image(ds.load_raw(ii), img_rng, self.image_size))
                labels.append(ci)
            yield np.stack(imgs), np.asarray(labels, np.int32)

    def _epoch_batches(self, batch_size: int, rng: np.random.Generator):
        """The whole epoch stacked, ((S, B, H, W, C), (S, B)), from the SAME
        permutation as `batches`; a device pool gathers on the device."""
        order = rng.permutation(len(self))
        s = len(order) // batch_size
        return self._gather(order[: s * batch_size].reshape(s, batch_size))


def conditional_metadata_path(checkpoint_dir: str, variant: str = "best") -> Path:
    return Path(checkpoint_dir) / f"unet_conditional_{variant}.json"


def write_conditional_metadata(checkpoint_dir: str, class_names,
                               cond_dropout: float, variant: str = "best") -> Path:
    """The class-id mapping `ModelManager(conditional=True)` reads, with the
    JAX package's keys."""
    n_embed = len(class_names) + 1
    path = conditional_metadata_path(checkpoint_dir, variant)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "classes": list(class_names),
        "num_class_embeds": n_embed,
        "null_label": n_embed - 1,
        "cond_dropout": cond_dropout,
    }, indent=2), encoding="utf-8")
    return path


def train_conditional(class_datasets: Dict[str, Any], checkpoint_dir: str,
                      config: TrainConfig = TrainConfig(),
                      model: Optional[UNet2D] = None,
                      resume: bool = False, mesh=None, log=print,
                      device=None) -> Dict[str, Any]:
    """Train the one conditional model on the mixed-class stream.

    `class_datasets`: {class_name: dataset}; the order gives the embedding
    rows (recorded in the metadata JSON). `model` defaults to the trainer's
    flagship with `len(class_datasets) + 1` embedding rows. Returns the
    `train_class` result plus the class list and the table size."""
    device = resolve_device(device)
    classes = list(class_datasets)
    n_embed = len(classes) + 1  # + the CFG null row
    model = model or default_model(config, device, num_class_embeds=n_embed)
    if int(model.config.num_class_embeds or 0) != n_embed:
        raise ValueError(
            f"model.num_class_embeds={model.config.num_class_embeds} does not "
            f"fit {len(classes)} classes + 1 null row")
    multihost.host0_only(write_conditional_metadata, checkpoint_dir, classes,
                         config.cond_dropout)

    mixture = LabeledMixtureDataset(class_datasets, image_size=config.image_size)
    result = train_class("conditional", mixture, checkpoint_dir, config,
                         model=model, resume=resume, mesh=mesh, log=log, device=device)

    # the generator looks colour statistics up by class name, so each
    # class's own go beside the mixture's (written under 'conditional')
    from ..io.color_stats import update_color_statistics_file

    for cls, ds in class_datasets.items():
        stats = dataset_color_statistics(ds)
        if stats is not None:
            multihost.host0_only(update_color_statistics_file,
                                 Path(checkpoint_dir) / "color_statistics.json", cls, stats)
    return {**result, "classes": classes, "num_class_embeds": n_embed}
