"""Training entry point: `python -m synt_isic_tpu_torch.train`.

The port of `python -m synt_isic_tpu.train`: per-class DDPM training, with
`--conditional` the one class-conditional model, with `--distill-from`
progressive distillation of a trained checkpoint into few-step students
(`unet_<CLASS>_distill<N>.pth`), and with `--train-classifier` the ResNet-18
lesion classifier (`classifier.pth`). The same flags (interactive class menu
when `--classes` is omitted; class names may also be given
comma-separated), plus `--device` (default cuda; raises without CUDA unless
`--device cpu`). On CUDA the UNet runs bf16 compute on f32 parameters
(unless `--no-bf16`) with the hand-written attention kernels and the
f32-statistics GroupNorm. `--batch` and `--lr` apply only when given: each
mode's defaults hold otherwise (DDPM batch 2 / lr 1e-4, classifier batch
16 / lr 1e-4, distillation batch 32 / lr 5e-5).

    python -m synt_isic_tpu_torch.train --classes MEL --procedural 64 \
        --epochs 2 --batch 16 --checkpoints DIR
    python -m synt_isic_tpu_torch.train --conditional \
        --classes MEL,NV,BCC,AKIEC,BKL,DF,VASC --procedural 16 --epochs 1 \
        --batch 16 --checkpoints DIR
    python -m synt_isic_tpu_torch.train --classes MEL --procedural 32 \
        --distill-from DIR/unet_{CLASS}_best.pth --distill-start 16 \
        --distill-end 4 --distill-steps-per-phase 8 --batch 16 --checkpoints DIR
    python -m synt_isic_tpu_torch.train --train-classifier --data-dir IMAGES \
        --csv GROUNDTRUTH.csv --epochs 2 --batch 16 --checkpoints DIR

`--dp-mesh` (reference `train/__main__.py:98-102, 142-146`) trains
data-parallel over every local card, and over every process when the
process was started by torchrun (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`,
`MASTER_ADDR`, `MASTER_PORT`: `parallel.multihost.initialize`, nccl on
CUDA, gloo with `--device cpu`). `--batch` is then the global batch and
must be a multiple of the mesh's data size. With `--device cpu` the
process's mesh is the one CPU device.

    torchrun --nproc-per-node 4 -m synt_isic_tpu_torch.train --dp-mesh \
        --classes MEL --procedural 64 --epochs 2 --batch 32 --checkpoints DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import List

from ..model_manager import resolve_device
from ..parallel import multihost
from ..utils.config import CLASS_NAMES
from .train_ddpm import TrainConfig, train_class


def select_classes_interactive() -> List[str]:
    print("available classes:")
    for i, cls in enumerate(CLASS_NAMES, 1):
        print(f"  {i}. {cls}")
    print("select: numbers/names (comma-separated) or 'all'")
    line = input("> ").strip()
    if not line:
        return []
    if line.lower() == "all":
        return list(CLASS_NAMES)
    chosen = []
    for tok in line.split(","):
        tok = tok.strip()
        if tok.isdigit() and 1 <= int(tok) <= len(CLASS_NAMES):
            chosen.append(CLASS_NAMES[int(tok) - 1])
        elif tok.upper() in CLASS_NAMES:
            chosen.append(tok.upper())
    return chosen


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="synt-isic-train-torch")
    p.add_argument("--classes", nargs="*", help="class names (default: ask)")
    p.add_argument("--data-dir", default="data/ISIC2018_Task3_Training_Input")
    p.add_argument("--csv", default="data/ISIC2018_Task3_Training_GroundTruth.csv")
    p.add_argument("--checkpoints", default="checkpoints")
    p.add_argument("--epochs", type=int, default=50)
    # only an explicit --batch/--lr reaches the config: the TrainConfig
    # defaults (batch 2, lr 1e-4, reference parity) apply otherwise
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--max-samples", type=int, default=500)
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="EMA decay for exported weights (e.g. 0.9999; "
                        "0 = off = reference behavior)")
    p.add_argument("--offset-noise", type=float, default=0.0, metavar="S",
                   help="offset-noise strength (e.g. 0.1; 0 = off)")
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--min-snr", type=float, default=0.0, metavar="GAMMA",
                   help="min-SNR loss weighting gamma (e.g. 5.0; 0 = off)")
    p.add_argument("--eval-every", type=int, default=0, metavar="N",
                   help="select the best checkpoint by a deterministic probe "
                        "loss every N epochs (0 = off: running train loss)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--procedural", type=int, default=0, metavar="N",
                   help="train on N procedural images instead of the ISIC "
                        "archive (asset-free; see train/procedural.py)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to train on (cuda runs the hand-written "
                        "attention kernels; cpu runs their plain versions)")
    p.add_argument("--conditional", action="store_true",
                   help="train ONE class-conditional model on the selected "
                        "classes' mixed stream (CFG label dropout; writes "
                        "unet_conditional_best.pth and its .json metadata) "
                        "instead of per-class models")
    p.add_argument("--cond-dropout", type=float, default=0.1, metavar="P",
                   help="CFG label-dropout probability for --conditional")
    p.add_argument("--train-classifier", action="store_true",
                   help="train the ResNet18 lesion classifier instead of DDPMs")
    p.add_argument("--distill-from", metavar="CKPT",
                   help="progressive distillation: halve sampling steps "
                        "starting from this teacher checkpoint "
                        "(unet_<CLASS>_best.pth, flagship architecture at "
                        "--image-size; {CLASS} in the path stands for each "
                        "class). Writes unet_<CLASS>_distill<N>.pth per "
                        "phase; sample them with num_inference_steps=N and "
                        "--distill-spacing")
    p.add_argument("--distill-start", type=int, default=64, metavar="N",
                   help="teacher step count the first phase halves "
                        "(default 64 -> students at 32, 16, ...)")
    p.add_argument("--distill-end", type=int, default=4, metavar="N",
                   help="smallest student step count (default 4)")
    p.add_argument("--distill-steps-per-phase", type=int, default=2000)
    p.add_argument("--distill-spacing", choices=("leading", "trailing"),
                   default="trailing",
                   help="timestep spacing of the student grids (trailing "
                        "is the measured few-step winner)")
    p.add_argument("--dp-mesh", action="store_true",
                   help="data-parallel training over every local card (and every "
                        "process when started by torchrun); --batch is then the "
                        "global batch and must be a multiple of the device count")
    return p


def _explicit_batch_lr(args) -> dict:
    """Only an explicit --batch/--lr reaches a config: each mode's
    dataclass defaults apply otherwise."""
    return {k: v for k, v in (("batch_size", args.batch),
                              ("learning_rate", args.lr)) if v is not None}


def train_classifier_from_cli(args, device) -> int:
    """`--train-classifier`: the ResNet-18 on `MultiClassDataset` batches,
    written to `<checkpoints>/classifier.pth`."""
    import numpy as np

    from .data import MultiClassDataset
    from .train_classifier import ClassifierTrainConfig, train_classifier

    dataset = MultiClassDataset(args.data_dir, args.csv, image_size=args.image_size,
                                max_samples_per_class=args.max_samples, seed=args.seed)
    if len(dataset) == 0:
        print("no classifier training data found")
        return 1
    print(f"classifier training set: {len(dataset)} images")
    rng = np.random.default_rng(args.seed)
    cfg = ClassifierTrainConfig(epochs=args.epochs, bf16_compute=not args.no_bf16,
                                seed=args.seed, **_explicit_batch_lr(args))
    result = train_classifier(lambda epoch: dataset.batches(cfg.batch_size, rng), cfg,
                              checkpoint_path=str(Path(args.checkpoints) / "classifier.pth"),
                              device=device)
    print(f"classifier done: best_acc={result['best_acc']:.3f}")
    return 0


def distill_from_cli(args, classes: List[str], device, dataset_for, mesh=None) -> int:
    """`--distill-from`: progressive distillation of each class's teacher
    (the path with {CLASS} replaced), loaded into the port's UNet2D with
    `load_state_dict(strict=True)`."""
    from ..io.pth import load_checkpoint
    from .distill import DistillConfig, progressive_distill

    if len(classes) > 1 and "{CLASS}" not in args.distill_from:
        print("--distill-from with multiple classes needs a {CLASS} "
              "placeholder in the path (each class has its own teacher)")
        return 1
    # only explicit --batch/--lr override the distiller's tuned defaults
    dcfg = DistillConfig(steps_per_phase=args.distill_steps_per_phase, seed=args.seed,
                         timestep_spacing=args.distill_spacing,
                         bf16_compute=not args.no_bf16, **_explicit_batch_lr(args))
    for cls in classes:
        dataset = dataset_for(cls)
        if len(dataset) == 0:
            print(f"!! no data for {cls}, skipping")
            continue
        cfg_cls = dcfg
        if args.batch is None and len(dataset) < dcfg.batch_size:
            # small corpora: clamp the DEFAULT batch to the dataset instead of
            # tripping distill_phase's undersized-dataset guard (an explicit
            # --batch still errors loudly)
            print(f"   {len(dataset)} images < default batch {dcfg.batch_size}; "
                  f"clamping batch_size to {len(dataset)}")
            cfg_cls = dataclasses.replace(dcfg, batch_size=len(dataset))
        teacher = load_checkpoint(args.distill_from.replace("{CLASS}", cls))
        print(f"== distilling {cls}: {args.distill_start} -> {args.distill_end} "
              f"steps on {device} ==")
        out = progressive_distill(teacher, dataset, cls, args.checkpoints,
                                  start_steps=args.distill_start,
                                  end_steps=args.distill_end, config=cfg_cls,
                                  image_size=args.image_size, mesh=mesh, device=device)
        for ph in out["phases"]:
            print(f"  T={ph['n_student']}: {ph['checkpoint']} "
                  f"(loss {ph['final_loss']:.5f})")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # joins the process group when torchrun's variables are set; a single
    # process otherwise
    multihost.initialize(device=device.type)
    mesh = None
    if args.dp_mesh:
        mesh = multihost.hybrid_mesh(
            devices=None if device.type == "cuda" else [device])
        # the primary replica is this process's first device
        device = mesh.shard_devices()[0]
        print(f"data-parallel mesh {mesh.shape} "
              f"(process {multihost.process_index()} of {multihost.process_count()})")
    if args.train_classifier:
        return train_classifier_from_cli(args, device)

    classes = ([c for tok in args.classes for c in tok.split(",") if c]
               if args.classes else select_classes_interactive())
    if not classes:
        print("no classes selected")
        return 1

    cfg = TrainConfig(image_size=args.image_size, epochs=args.epochs,
                      bf16_compute=not args.no_bf16, seed=args.seed,
                      ema_decay=args.ema, offset_noise=args.offset_noise,
                      lr_schedule=args.lr_schedule,
                      warmup_steps=args.warmup_steps,
                      min_snr_gamma=args.min_snr, eval_every=args.eval_every,
                      cond_dropout=args.cond_dropout, **_explicit_batch_lr(args))

    def dataset_for(cls: str):
        if args.procedural:
            from .procedural import ProceduralDataset

            return ProceduralDataset(cls, args.procedural, image_size=args.image_size,
                                     seed=args.seed, device=device)
        from .data import SingleClassDataset

        return SingleClassDataset(args.data_dir, args.csv, CLASS_NAMES.index(cls),
                                  image_size=args.image_size,
                                  max_samples=args.max_samples)

    if args.distill_from:
        return distill_from_cli(args, classes, device, dataset_for, mesh)

    if args.conditional:
        from .train_conditional import train_conditional

        datasets = {cls: dataset_for(cls) for cls in classes}
        datasets = {c: d for c, d in datasets.items() if len(d) > 0}
        if not datasets:
            print("no training data found for any selected class")
            return 1
        total = sum(len(d) for d in datasets.values())
        print(f"== training conditional model on {list(datasets)}: {total} "
              f"images on {device} ==")
        result = train_conditional(datasets, args.checkpoints, cfg,
                                   resume=args.resume, mesh=mesh, device=device)
        print(f"== conditional done: best_loss={result['best_loss']:.5f} "
              f"-> {result['checkpoint']} ==")
        return 0

    for cls in classes:
        dataset = dataset_for(cls)
        if len(dataset) == 0:
            print(f"!! no data for {cls}, skipping")
            continue
        print(f"== training {cls}: {len(dataset)} images on {device} ==")
        result = train_class(cls, dataset, args.checkpoints, cfg,
                             resume=args.resume, mesh=mesh, device=device)
        print(f"== {cls} done: best_loss={result['best_loss']:.5f} ==")
    return 0


if __name__ == "__main__":
    sys.exit(main())
