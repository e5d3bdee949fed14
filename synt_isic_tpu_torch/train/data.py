"""ISIC-2018 training data pipeline.

Parity with reference `diffusion/train_diffusion.py`:
  * `enhance_color` (:19-50) — per-class gain/brightness/target-mean color
    correction with the reference's hand-tuned constants (data constants,
    reproduced verbatim for training parity);
  * `SingleClassDataset` (:85-114) — one-hot CSV -> label, intersection
    with available jpgs, seeded <=500-sample subset (random_state=42),
    resize to 128, per-class color enhancement;
  * augmentation stack (:72-81) — RandomResizedCrop(scale 0.9-1.0),
    horizontal/vertical flips, ColorJitter(brightness .3, contrast .3,
    saturation .2), rotation +-15° with p=0.5, normalize to [-1,1].

A copy of `synt_isic_tpu/train/data.py`. Augmentations are pure numpy,
applied per batch on the host while the device trains on the previous batch
(`prefetch`); batches are NHWC float32 in [-1,1]. pandas is imported only
by `SingleClassDataset`, so the procedural path does not need it;
`MultiClassDataset` (the classifier's data) reads its CSV with the `csv`
module and draws the pandas subsets itself.
"""
from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
from PIL import Image

# Per-class color-correction constants (reference train_diffusion.py:24-39).
# NOTE: the reference indexes these by *dataset label id* where 0=NV, 1=MEL
# (the CSV one-hot argmax order), not by CLASS_NAMES order.
COLOR_PARAMS = {
    0: {"gain": [1.04462, 0.8474, 0.7931], "brightness": 0.23741,
        "target": [0.7525, 0.5645, 0.5303]},   # NV
    1: {"gain": [1.0561, 0.86, 0.883], "brightness": 0.218,
        "target": [0.7453, 0.54, 0.5721]},     # MEL
    2: {"gain": [1.125, 0.99, 0.922], "brightness": 0.262,
        "target": [0.784, 0.635, 0.573]},      # BCC
    3: {"gain": [1.158, 0.952, 0.82], "brightness": 0.275,
        "target": [0.781, 0.618, 0.593]},      # AKIEC
    4: {"gain": [1.1242, 0.846, 0.796], "brightness": 0.25,
        "target": [0.766, 0.574, 0.561]},      # BKL
    5: {"gain": [1.0, 1.1, 1.1], "brightness": 0.23,
        "target": [0.79, 0.66, 0.66]},         # DF
    6: {"gain": [1.08, 1.05, 0.945], "brightness": 0.09,
        "target": [0.79, 0.64, 0.597]},        # VASC
}


def enhance_color(img: np.ndarray, class_id: int) -> np.ndarray:
    """Adaptive per-class color correction. img: (H,W,3) uint8 or [0,1]."""
    arr = img.astype(np.float32)
    if arr.max() > 1.5:
        arr = arr / 255.0
    params = COLOR_PARAMS[class_id]
    current_mean = arr.mean(axis=(0, 1))
    for c in range(3):
        diff = params["target"][c] - current_mean[c]
        arr[..., c] = np.clip(
            arr[..., c] + diff * params["gain"][c] + params["brightness"], 0, 1)
    return arr


def _color_jitter(arr: np.ndarray, rng: np.random.Generator,
                  brightness=0.3, contrast=0.3, saturation=0.2) -> np.ndarray:
    b = rng.uniform(1 - brightness, 1 + brightness)
    c = rng.uniform(1 - contrast, 1 + contrast)
    s = rng.uniform(1 - saturation, 1 + saturation)
    arr = np.clip(arr * b, 0, 1)
    mean = arr.mean()
    arr = np.clip((arr - mean) * c + mean, 0, 1)
    gray = arr.mean(axis=-1, keepdims=True)
    return np.clip((arr - gray) * s + gray, 0, 1)


def _random_resized_crop(arr: np.ndarray, rng: np.random.Generator,
                         out_size: int, scale=(0.9, 1.0)) -> np.ndarray:
    h, w = arr.shape[:2]
    area = h * w * rng.uniform(*scale)
    side = int(round(np.sqrt(area)))
    side = min(side, h, w)
    top = rng.integers(0, h - side + 1)
    left = rng.integers(0, w - side + 1)
    crop = arr[top:top + side, left:left + side]
    img = Image.fromarray((crop * 255).astype(np.uint8)).resize(
        (out_size, out_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def _rotate(arr: np.ndarray, rng: np.random.Generator, max_deg=15.0) -> np.ndarray:
    deg = rng.uniform(-max_deg, max_deg)
    img = Image.fromarray((arr * 255).astype(np.uint8)).rotate(
        deg, resample=Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


def augment_image(arr01: np.ndarray, rng: np.random.Generator,
                  out_size: int = 128) -> np.ndarray:
    """Full augmentation stack -> (H,W,3) float32 in [-1,1]."""
    arr = _random_resized_crop(arr01, rng, out_size)
    if rng.random() < 0.5:
        arr = arr[:, ::-1]
    if rng.random() < 0.5:
        arr = arr[::-1, :]
    arr = _color_jitter(np.ascontiguousarray(arr), rng)
    if rng.random() < 0.5:
        arr = _rotate(arr, rng)
    return arr * 2.0 - 1.0


def prefetch(iterator, depth: int = 2):
    """Host-side pipeline: a background thread keeps `depth` batches ready
    while the device consumes the current one (the reference's DataLoader
    role, without torch). Exceptions propagate to the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that re-checks the stop flag: when the consumer
        # abandons the generator mid-epoch (step raised, caller broke out)
        # the worker must exit instead of blocking on a full queue forever,
        # pinning depth+1 batches for the life of the process
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not _put(item):
                    return
            _put(_END)
        except BaseException as exc:  # surfaced on the consumer side
            _put(exc)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def read_onehot_csv(csv_path) -> list:
    """(image, label) per row of a one-hot ground-truth CSV, in file order:
    the label is the argmax over the columns other than `image` (the first
    maximum, as numpy's argmax takes it)."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.DictReader(f)
        class_cols = [c for c in reader.fieldnames if c != "image"]
        return [(row["image"], int(np.argmax([float(row[c]) for c in class_cols])))
                for row in reader]


class MultiClassDataset:
    """All-classes labeled dataset for classifier training: one-hot CSV ->
    labels, per-class color enhancement, augmentation, then the classifier's
    input space (224², ImageNet-normalized) on the fly.

    The rows are the JAX dataset's without pandas: per label (sorted), the
    `DataFrame.sample(n, random_state=seed)` subset of that label's rows
    (in file order) is `RandomState(seed).choice(len, n, replace=False)`."""

    def __init__(self, image_dir: str, csv_path: str, image_size: int = 128,
                 max_samples_per_class: int = 500, seed: int = 42):
        self.image_dir = Path(image_dir)
        self.image_size = image_size
        available = {f.split(".")[0] for f in os.listdir(image_dir)
                     if f.endswith(".jpg")}
        rows = [r for r in read_onehot_csv(csv_path) if r[0] in available]
        self.data = []
        for cid in sorted({label for _, label in rows}):
            cls = [r for r in rows if r[1] == cid]
            n = min(max_samples_per_class, len(cls))
            pick = np.random.RandomState(seed).choice(len(cls), size=n, replace=False)
            self.data.extend(cls[int(i)] for i in pick)

    def __len__(self) -> int:
        return len(self.data)

    def batches(self, batch_size: int, rng: np.random.Generator,
                classifier_size: int = 224):
        """Yields (images, labels): images (B, classifier_size, ·, 3)
        ImageNet-normalized float32; labels int64."""
        from ..models.classifier import IMAGENET_MEAN, IMAGENET_STD

        mean = np.asarray(IMAGENET_MEAN, np.float32)
        std = np.asarray(IMAGENET_STD, np.float32)
        order = np.arange(len(self))
        rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size]
            imgs, labels = [], []
            for i in idxs:
                name, label = self.data[int(i)]
                img = Image.open(self.image_dir / f"{name}.jpg") \
                    .convert("RGB").resize((self.image_size, self.image_size))
                arr = np.asarray(img, dtype=np.float32) / 255.0
                arr = enhance_color(arr, label)
                arr = (augment_image(arr, rng, self.image_size) + 1.0) / 2.0
                arr = np.asarray(Image.fromarray(
                    (np.clip(arr, 0, 1) * 255).astype(np.uint8)).resize(
                    (classifier_size, classifier_size), Image.BILINEAR),
                    dtype=np.float32) / 255.0
                imgs.append((arr - mean) / std)
                labels.append(label)
            yield np.stack(imgs), np.asarray(labels, np.int64)


class SingleClassDataset:
    """Per-class ISIC subset with the reference's selection semantics."""

    def __init__(self, image_dir: str, csv_path: str, class_id: int,
                 image_size: int = 128, max_samples: int = 500,
                 apply_color_enhancement: bool = True, seed: int = 42):
        import pandas as pd

        self.image_dir = Path(image_dir)
        self.image_size = image_size
        self.class_id = class_id
        self.apply_color_enhancement = apply_color_enhancement

        df = pd.read_csv(csv_path)
        class_cols = [c for c in df.columns if c != "image"]
        df["label"] = df[class_cols].values.argmax(axis=1)
        available = {f.split(".")[0] for f in os.listdir(image_dir)
                     if f.endswith(".jpg")}
        df = df[df["image"].isin(available)].reset_index(drop=True)
        class_data = df[df["label"] == class_id]
        n = min(max_samples, len(class_data))
        self.data = class_data.sample(n=n, random_state=seed).reset_index(drop=True)

    def __len__(self) -> int:
        return len(self.data)

    def load_raw(self, idx: int) -> np.ndarray:
        """(H,W,3) float32 in [0,1], resized + color-enhanced."""
        name = self.data.iloc[idx]["image"]
        img = Image.open(self.image_dir / f"{name}.jpg").convert("RGB").resize(
            (self.image_size, self.image_size))
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.apply_color_enhancement:
            arr = enhance_color(arr, self.class_id)
        return arr

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True,
                local_range: Optional[Tuple[int, int]] = None
                ) -> Iterator[np.ndarray]:
        """Yields augmented NHWC batches in [-1,1].

        Augmentation draws come from PER-IMAGE streams seeded by one bulk
        draw from `rng`, so an epoch's randomness is fixed by `rng` alone —
        independent of which rows a process materializes. That makes
        `local_range=(lo, hi)` possible: yield only rows [lo, hi) of every
        batch, LOADING/AUGMENTING only those. Multi-host dp feeding passes
        `multihost.local_batch_bounds(batch_size)` here, so per-host input
        work shrinks 1/n while the global batch (and the loss sequence)
        stays identical to the single-device run.
        """
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        img_seeds = rng.integers(0, np.iinfo(np.int64).max, size=len(order))
        lo, hi = local_range if local_range is not None else (0, batch_size)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            rows = range(start + lo, start + min(hi, batch_size))
            imgs = []
            for k in rows:
                img_rng = np.random.default_rng(int(img_seeds[k]))
                imgs.append(augment_image(self.load_raw(int(order[k])),
                                          img_rng, self.image_size))
            yield np.stack(imgs)
