"""Dataset CSV writers.

Two formats, matching the reference exactly:
  * `synthetic_dataset.csv` with columns
    filename,class,isic_number,source,generated_at — the GUI engine's
    metadata CSV (`core/generator/image_generator.py:742-782`);
  * ISIC2018_Task3 ground-truth one-hot CSV with columns
    image,MEL,NV,BCC,AKIEC,BKL,DF,VASC — the console generator's
    synthetic-dataset companion (`diffusion/console_generator_server.py:88-127`).
"""
from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

from ..utils.config import CLASS_NAMES

SYNTHETIC_HEADERS = ["filename", "class", "isic_number", "source", "generated_at"]


def initialize_synthetic_csv(csv_path) -> None:
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        csv.DictWriter(f, fieldnames=SYNTHETIC_HEADERS).writeheader()


def append_synthetic_row(csv_path, data: Dict[str, object]) -> None:
    with open(csv_path, "a", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=SYNTHETIC_HEADERS)
        writer.writerow({k: data.get(k, "") for k in SYNTHETIC_HEADERS})


def isic_groundtruth_header() -> List[str]:
    return ["image"] + list(CLASS_NAMES)


def initialize_groundtruth_csv(csv_path) -> None:
    """Creates the one-hot CSV only if absent (the console path appends to
    an existing dataset, `console_generator_server.py:109-117`)."""
    p = Path(csv_path)
    if not p.exists():
        with open(p, "w", newline="", encoding="utf-8") as f:
            csv.writer(f).writerow(isic_groundtruth_header())


def append_groundtruth_row(csv_path, image_name: str, class_name: str) -> None:
    row: List[object] = [image_name] + [0.0] * len(CLASS_NAMES)
    if class_name in CLASS_NAMES:
        row[CLASS_NAMES.index(class_name) + 1] = 1.0
    with open(csv_path, "a", newline="", encoding="utf-8") as f:
        csv.writer(f).writerow(row)
