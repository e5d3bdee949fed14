"""Project constants (the class list of `synt_isic_tpu/utils/config.py`).

The ISIC-2018 Task 3 diagnosis classes, in the column order of the
ground-truth CSV. The configuration manager itself is not ported yet.
"""
from __future__ import annotations

CLASS_NAMES = ["MEL", "NV", "BCC", "AKIEC", "BKL", "DF", "VASC"]
NUM_CLASSES = len(CLASS_NAMES)
