"""Headless batch-generation CLI producing ISIC2018_Task3-format synthetic
datasets, on a CUDA device.

The port of `synt_isic_tpu/cli.py` for batch generation: the same flags
(`--classes/--count/--class-counts/--output/--no-postprocess/--list-classes/
--base-dir/--checkpoints/--steps/--batch/--scheduler/--timestep-spacing/
--seed/--model-variant`), the same artifacts — JPEG quality 95 named
`ISIC_%07d.jpg` continuing from the original dataset's last id 34320, one
sidecar JSON per image, the one-hot ground-truth CSV appended across runs,
mean-shift colour postprocessing — plus `--device {cuda,cpu}` (default
cuda).

Usage:
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --class-counts MEL:8 \
        --scheduler ddim --steps 50
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from .diffusion.sampler import to_uint8_images
from .io.color_stats import apply_mean_shift_postprocessing, load_color_statistics
from .io.csv_io import append_groundtruth_row, initialize_groundtruth_csv
from .io.images import save_image, write_sidecar_metadata
from .model_manager import ModelManager

LAST_ORIGINAL_ISIC_NUMBER = 34320  # last id of the real ISIC2018 Task3 set


class ConsoleGenerator:
    def __init__(self, base_dir: Optional[str] = None,
                 checkpoints_dir: Optional[str] = None,
                 inference_steps: int = 1000,
                 batch_size: int = 8,
                 scheduler: str = "ddpm",
                 timestep_spacing: str = "leading",
                 seed: Optional[int] = None,
                 model_config=None,
                 model_variant: str = "best",
                 device: Optional[str] = None):
        self.base_dir = Path(base_dir) if base_dir else Path.cwd()
        ckpt = Path(checkpoints_dir) if checkpoints_dir else self.base_dir / "checkpoints"
        self.model_manager = ModelManager(checkpoints_dir=str(ckpt),
                                          model_config=model_config,
                                          variant=model_variant,
                                          device=device)
        self.inference_steps = max(1, min(1000, inference_steps))
        self.batch_size = max(1, batch_size)
        self.scheduler = scheduler
        self.timestep_spacing = timestep_spacing
        self.seed = seed
        self.synthetic_dir = self.base_dir / "ISIC2018_Task3_synt"
        self.synthetic_csv = self.base_dir / "ISIC2018_Task3_GroundTruth_synt.csv"
        self.color_stats = load_color_statistics(ckpt / "color_statistics.json")
        self.last_isic_number = self._scan_last_number()

    def _scan_last_number(self) -> int:
        """Continue numbering from existing synthetic files (dataset-level
        resume) or from the original dataset's last id."""
        last = LAST_ORIGINAL_ISIC_NUMBER
        if self.synthetic_dir.exists():
            for p in self.synthetic_dir.glob("ISIC_*.jpg"):
                try:
                    last = max(last, int(p.stem.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return last

    def list_classes(self) -> List[str]:
        return self.model_manager.get_available_classes()

    def generate(self, class_counts: Dict[str, int],
                 output_dir: Optional[str] = None,
                 postprocess: bool = True) -> Dict[str, int]:
        out_dir = Path(output_dir) if output_dir else self.synthetic_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        initialize_groundtruth_csv(self.synthetic_csv)
        produced: Dict[str, int] = {}
        rng = np.random.default_rng(self.seed)
        mm = self.model_manager
        t_start = time.time()
        total = sum(class_counts.values())
        done = 0
        for class_name, count in class_counts.items():
            if not mm.load_model(class_name):
                print(f"!! no checkpoint for class {class_name}, skipping")
                produced[class_name] = 0
                continue
            sampler = mm.create_sampler(self.inference_steps, scheduler=self.scheduler,
                                        timestep_spacing=self.timestep_spacing)
            model = mm.loaded_models[class_name]
            n = 0
            while n < count:
                block = min(self.batch_size, count - n)
                seeds = rng.integers(0, 0x7FFFFFFF, size=block, dtype=np.int64) \
                    .astype(np.uint32)
                out = sampler.sample(model, seeds)
                images = to_uint8_images(out["images"])
                for j in range(block):
                    arr = images[j]
                    if postprocess:
                        arr = apply_mean_shift_postprocessing(
                            arr, self.color_stats.get(class_name)
                            if self.color_stats else None)
                    self.last_isic_number += 1
                    name = f"ISIC_{self.last_isic_number:07d}.jpg"
                    path = out_dir / name
                    save_image(Image.fromarray(arr), str(path), quality=95)
                    # the sampler actually used, the JPEG settings and, for a
                    # multi-image block, the block layout (a batch-8 image is
                    # not byte-stable when regenerated at batch 1)
                    write_sidecar_metadata(
                        str(path), class_name=class_name, seed=int(seeds[j]),
                        inference_steps=self.inference_steps,
                        device=str(mm.device),
                        noise_hash=out["noise_hashes"][j],
                        scheduler={
                            "num_train_timesteps": 1000,
                            "beta_schedule": "squaredcos_cap_v2",
                            "prediction_type": "epsilon",
                            "kind": self.scheduler,
                            "ddim_eta": 0.0,
                            "timestep_spacing": self.timestep_spacing,
                            "dtype": str(mm.dtype).removeprefix("torch."),
                            "model_variant": mm.variant,
                        },
                        extra={
                            "artifact": {
                                "format": "jpeg", "quality": 95,
                                "postprocess": ("mean_shift" if postprocess
                                                else None),
                            },
                            **({"block": {"seeds": [int(s) for s in seeds],
                                          "index": j}} if block > 1 else {}),
                        })
                    append_groundtruth_row(self.synthetic_csv, name, class_name)
                    n += 1
                    done += 1
                print(f"  {class_name}: {n}/{count} "
                      f"(total {done}/{total}, {time.time() - t_start:.1f}s)")
            produced[class_name] = n
        return produced


def _parse_class_counts(spec: str) -> Dict[str, int]:
    """'MEL:50,NV:20' -> {'MEL': 50, 'NV': 20}"""
    counts: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        cls, _, num = part.partition(":")
        counts[cls.strip()] = int(num)
    return counts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="synt-isic-generate-torch",
        description="CUDA batch generator for synthetic ISIC2018 images")
    p.add_argument("--classes", nargs="*", help="class names to generate")
    p.add_argument("--count", type=int, default=10,
                   help="images per class (with --classes)")
    p.add_argument("--class-counts", type=str,
                   help="per-class counts, e.g. 'MEL:50,NV:20'")
    p.add_argument("--output", type=str, help="output directory")
    p.add_argument("--no-postprocess", action="store_true",
                   help="disable color postprocessing")
    p.add_argument("--list-classes", action="store_true")
    p.add_argument("--base-dir", type=str, default=None)
    p.add_argument("--checkpoints", type=str, default=None)
    p.add_argument("--steps", type=int, default=1000,
                   help="inference steps (1-1000)")
    p.add_argument("--batch", type=int, default=8, help="device batch size")
    p.add_argument("--scheduler", choices=["ddpm", "ddim"], default="ddpm")
    p.add_argument("--timestep-spacing", choices=["leading", "trailing"],
                   default="leading",
                   help="'leading' = reference parity; 'trailing' always "
                        "visits t=T-1 — the standard few-step quality fix "
                        "(recorded in sidecars)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--model-variant", default="best", metavar="V",
                   help="checkpoint variant to sample: 'best' = reference "
                        "naming unet_<CLASS>_best.pth. Recorded in sidecars")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to sample on (cuda runs the hand-written "
                        "attention kernel; cpu runs its plain version)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    gen = ConsoleGenerator(base_dir=args.base_dir, checkpoints_dir=args.checkpoints,
                           inference_steps=args.steps, batch_size=args.batch,
                           scheduler=args.scheduler, seed=args.seed,
                           timestep_spacing=args.timestep_spacing,
                           model_variant=args.model_variant, device=args.device)
    if args.list_classes:
        classes = gen.list_classes()
        if not classes:
            print(f"no model checkpoints (unet_<CLASS>_best.pth) found in "
                  f"{gen.model_manager.checkpoints_dir}", file=sys.stderr)
        for cls in classes:
            print(cls)
        return 0
    if args.class_counts:
        counts = _parse_class_counts(args.class_counts)
    elif args.classes:
        counts = {cls: args.count for cls in args.classes}
    else:
        counts = {cls: args.count for cls in gen.list_classes()}
    if not counts:
        print("nothing to generate (no classes found)")
        return 1
    produced = gen.generate(counts, output_dir=args.output,
                            postprocess=not args.no_postprocess)
    print(f"done: {produced}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
