"""Path/file utility layer making the framework CWD-independent.

Parity with reference `core/utils/path_manager.py:14-209`: project-root
anchoring, checkpoint path helpers, `ISIC_%07d.png` naming, resumable
numbering scan (`get_next_isic_number`), class discovery from
`unet_<CLASS>_best.pth` checkpoints.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List, Optional

_CKPT_RE = re.compile(r"^unet_(?P<cls>[A-Za-z0-9]+)_best\.(pth|msgpack|npz)$")


class PathManager:
    def __init__(self, project_root: Optional[str] = None):
        self.project_root = Path(project_root).resolve() if project_root else Path.cwd()

    # -- checkpoints -------------------------------------------------------------
    def get_checkpoints_dir(self) -> Path:
        return self.project_root / "checkpoints"

    def get_checkpoint_path(self, class_name: str, suffix: str = "pth") -> Path:
        return self.get_checkpoints_dir() / f"unet_{class_name}_best.{suffix}"

    def get_classifier_path(self) -> Path:
        return self.get_checkpoints_dir() / "classifier.pth"

    def get_available_classes(self, checkpoints_dir: Optional[str] = None) -> List[str]:
        """Classes with a `unet_<CLASS>_best.*` checkpoint present
        (reference `path_manager.py:45`, `model_manager.py:39`)."""
        ckpt_dir = Path(checkpoints_dir) if checkpoints_dir else self.get_checkpoints_dir()
        if not ckpt_dir.exists():
            return []
        classes = []
        for p in sorted(ckpt_dir.iterdir()):
            m = _CKPT_RE.match(p.name)
            # 'conditional' is the reserved family name of the single
            # class-conditional checkpoint (unet_conditional_<variant>.pth,
            # ModelManager(conditional=True)) — never a per-class entry
            if m and m.group("cls") != "conditional":
                classes.append(m.group("cls"))
        # de-dup while keeping order (a class may have both .pth and .msgpack)
        seen: set = set()
        return [c for c in classes if not (c in seen or seen.add(c))]

    # -- output naming -------------------------------------------------------------
    @staticmethod
    def get_isic_filename(isic_number: int, ext: str = "png") -> str:
        """`ISIC_%07d.<ext>` (reference `path_manager.py:94`)."""
        return f"ISIC_{isic_number:07d}.{ext}"

    def get_output_dir(self, output_dir: str = "generated_images") -> Path:
        p = Path(output_dir)
        return p if p.is_absolute() else self.project_root / output_dir

    def get_next_isic_number(self, output_dir: str = "generated_images") -> int:
        """Scan existing `ISIC_*.{png,jpg}` for the max number and return +1
        (dataset-level resume, reference `path_manager.py:98-117`)."""
        output_path = Path(output_dir) if os.path.isabs(str(output_dir)) else self.get_output_dir(str(output_dir))
        max_number = 0
        if output_path.exists():
            for file in list(output_path.glob("ISIC_*.png")) + list(output_path.glob("ISIC_*.jpg")):
                try:
                    max_number = max(max_number, int(file.stem.split("_")[1]))
                except (ValueError, IndexError):
                    continue
        return max_number + 1

    # -- misc helpers -------------------------------------------------------------
    def ensure_dir(self, path: str) -> Path:
        p = Path(path) if os.path.isabs(str(path)) else self.project_root / path
        p.mkdir(parents=True, exist_ok=True)
        return p
