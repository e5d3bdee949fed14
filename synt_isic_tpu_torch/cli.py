"""Headless batch-generation CLI producing ISIC2018_Task3-format synthetic
datasets, on a CUDA device.

The port of `synt_isic_tpu/cli.py`: the same flags
(`--classes/--count/--class-counts/--output/--no-postprocess/--interactive/
--list-classes/--base-dir/--checkpoints/--steps/--batch/--scheduler/
--timestep-spacing/--seed/--model-variant/--conditional/--guidance-scale/
--guidance-map/--dp-mesh/--augment-source/--augment-strength/--augment-mask`,
all five schedulers), the same artifacts — JPEG quality 95 named `ISIC_%07d.jpg`
continuing from the original dataset's last id 34320, one sidecar JSON per
image, the one-hot ground-truth CSV appended across runs, mean-shift colour
postprocessing; `--augment-source` writes img2img / inpainting PNG variants
of one image through the library generator — plus `--device {cuda,cpu}`
(default cuda), and `--reproduce SIDECAR_JSON`, which regenerates the image
a sidecar records (console JPEGs, the generator's PNGs of one image or of a
device block, and img2img PNGs from their source and mask files) and checks
it byte for byte against the original.

`--dp-mesh N` shards each device block over an N-device data-parallel mesh
(`parallel.ShardedSampler`; -1 = every local card); its sidecars record
`block.dp_mesh` and `block.mesh` (the mesh's axes and devices), and
`--reproduce` of one rebuilds exactly that mesh, as it does for a block
the library generator or the server sampled over a 'DxT' mesh (rc 2 on a
host that lacks a recorded device). A sidecar with `dp_mesh` alone (the
JAX package's, or the port's before it recorded the mesh) is rebuilt over
a 1-D mesh of that size (rc 2 on a host with fewer cards). With `--device
cpu` the mesh is N repeats of the CPU device: the only place the CLI
accepts a repeated device.

Usage:
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --class-counts MEL:8 \
        --scheduler ddim --steps 50
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --conditional \
        --class-counts MEL:8,NV:8 --guidance-scale 3 --scheduler ddim --steps 50
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --class-counts MEL:8 \
        --scheduler unipc --steps 20 --timestep-spacing trailing
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --classes MEL \
        --augment-source SRC.png --augment-mask MASK.png --augment-strength 0.6 \
        --scheduler ddim --steps 50 --count 4 --output OUT
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --class-counts MEL:16 \
        --scheduler ddim --steps 50 --dp-mesh -1
    python -m synt_isic_tpu_torch.cli --checkpoints DIR --reproduce OUT/MEL/ISIC_0000001.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from .diffusion.sampler import SCHEDULERS, noise_hash, to_uint8_images
from .generator import (ImageGenerator, dtype_name, parse_guidance_map, tf32_as_recorded,
                        tf32_state)
from .io.color_stats import apply_mean_shift_postprocessing, load_color_statistics
from .io.csv_io import append_groundtruth_row, initialize_groundtruth_csv
from .io.images import save_image, write_sidecar_metadata
from .model_manager import ModelManager
from .parallel.mesh import data_mesh, mesh_record, recorded_mesh
from .parallel.sharded_sampler import ShardedSampler

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
                 device: Optional[str] = None,
                 conditional: bool = False,
                 guidance_scale: float = 0.0,
                 guidance_map=None,
                 mesh=None):
        self.base_dir = Path(base_dir) if base_dir else Path.cwd()
        ckpt = Path(checkpoints_dir) if checkpoints_dir else self.base_dir / "checkpoints"
        self.model_manager = ModelManager(checkpoints_dir=str(ckpt),
                                          model_config=model_config,
                                          variant=model_variant,
                                          device=device,
                                          conditional=conditional)
        self.guidance_scale = float(guidance_scale)
        # per-class guidance {class: g}; the console samples one class per
        # sampler call, so the map resolves to one scalar per class
        self.guidance_map = dict(guidance_map) if guidance_map else None
        self.inference_steps = max(1, min(1000, inference_steps))
        self.batch_size = max(1, batch_size)
        self.scheduler = scheduler
        self.timestep_spacing = timestep_spacing
        self.seed = seed
        # --dp-mesh: shard the sampling blocks over the mesh's 'data' axis
        self.mesh = mesh
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
            g_class = (self.guidance_map.get(class_name, self.guidance_scale)
                       if self.guidance_map else self.guidance_scale)
            sampler = mm.create_sampler(self.inference_steps, scheduler=self.scheduler,
                                        timestep_spacing=self.timestep_spacing,
                                        guidance_scale=g_class)
            if self.mesh is not None:
                sampler = ShardedSampler(sampler, self.mesh)
            model = mm.loaded_models[class_name]
            labels = mm.class_id(class_name) if mm.conditional else None
            n = 0
            while n < count:
                block = min(self.batch_size, count - n)
                seeds = rng.integers(0, 0x7FFFFFFF, size=block, dtype=np.int64) \
                    .astype(np.uint32)
                out = sampler.sample(model, seeds, class_labels=labels)
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
                            "dtype": dtype_name(mm.dtype),
                            "model_variant": mm.variant,
                            **({"attention_fast_math": True}
                               if mm.attention_fast_math else {}),
                            **tf32_state(mm.device, mm.dtype),
                            # the class's effective weight: one class per
                            # sampler call, so the scalar pins the walk
                            **({"conditional": True, "guidance_scale": g_class}
                               if mm.conditional else {}),
                        },
                        extra={
                            "artifact": {
                                "format": "jpeg", "quality": 95,
                                "postprocess": ("mean_shift" if postprocess
                                                else None),
                            },
                            # a mesh block also records the mesh, even for
                            # one image
                            **({"block": {"seeds": [int(s) for s in seeds], "index": j,
                                          **(mesh_record(self.mesh)
                                             if self.mesh is not None else {})}}
                               if block > 1 or self.mesh is not None else {}),
                        })
                    append_groundtruth_row(self.synthetic_csv, name, class_name)
                    n += 1
                    done += 1
                print(f"  {class_name}: {n}/{count} "
                      f"(total {done}/{total}, {time.time() - t_start:.1f}s)")
            produced[class_name] = n
        return produced


def _reproduce_console_jpeg(gen: ImageGenerator, meta: dict, out_path: str) -> bool:
    """Regenerate a ConsoleGenerator JPEG: the recorded device block through
    the recorded sampler, mean-shift colour postprocessing when it was
    applied, then the JPEG encode at the recorded quality. Writes a sidecar
    next to the output."""
    art = meta["artifact"]
    cls = meta["class"]
    blk = meta.get("block") or {"seeds": [int(meta["seed"])], "index": 0}
    idx = int(blk["index"])
    seeds = np.asarray(blk["seeds"], np.uint32)
    out = gen._sample_block([cls] * len(seeds), seeds, False)
    if out is None:
        return False
    img = to_uint8_images(out["images"][idx:idx + 1])[0]
    if art.get("postprocess") == "mean_shift":
        stats = load_color_statistics(
            Path(gen.model_manager.checkpoints_dir) / "color_statistics.json")
        img = apply_mean_shift_postprocessing(img, stats.get(cls) if stats else None)
    save_image(Image.fromarray(img), out_path, quality=int(art.get("quality", 95)))
    write_sidecar_metadata(out_path, class_name=cls, seed=int(seeds[idx]),
                           inference_steps=int(meta["inference_steps"]),
                           device=str(gen.model_manager.device),
                           noise_hash=out["noise_hashes"][idx],
                           scheduler=meta.get("scheduler"),
                           extra={"artifact": art,
                                  **({"block": blk}
                                     if len(seeds) > 1 or "dp_mesh" in blk else {})})
    return True


def _output_path(sidecar_path: str, meta: dict, output: Optional[str]) -> str:
    """Where the regenerated image goes: next to the sidecar, a file (its
    extension corrected to the recorded format, since the encoder follows
    the extension), or a directory."""
    ext = ".jpg" if (meta.get("artifact") or {}).get("format") == "jpeg" else ".png"
    name = Path(meta["filename"]).stem + "_reproduced" + ext
    if output is None:
        return str(Path(sidecar_path).with_name(name))
    if output.lower().endswith((".png", ".jpg", ".jpeg")):
        same = (output.lower().endswith((".jpg", ".jpeg")) if ext == ".jpg"
                else output.lower().endswith(".png"))
        if not same:
            corrected = str(Path(output).with_suffix(ext))
            print(f"warning: --output extension {Path(output).suffix!r} does not "
                  f"match the recorded artifact format; writing {corrected}",
                  file=sys.stderr)
            return corrected
        return output
    Path(output).mkdir(parents=True, exist_ok=True)
    return str(Path(output) / name)


def _resolve_img2img_file(sidecar_path: str, i2i: dict, kind: str):
    """(path, 0) of an img2img run's `kind` file ("source" or "mask"): the
    file next to the sidecar, then the recorded path, the first whose
    SHA-256 is the recorded one; (None, 2) for an in-memory array, (None,
    1) for a missing or changed file."""
    name = i2i.get(kind)
    if not name:
        print(f"sidecar records an img2img run from an in-memory {kind} array — "
              f"cannot reproduce without the original file", file=sys.stderr)
        return None, 2
    candidates = [Path(sidecar_path).with_name(name)]
    if i2i.get(f"{kind}_path"):
        candidates.append(Path(i2i[f"{kind}_path"]))
    existing = [c for c in candidates if c.exists()]
    if not existing:
        print(f"img2img {kind} file {name} not found next to the sidecar or at its "
              f"recorded path — cannot reproduce", file=sys.stderr)
        return None, 1
    for path in existing:
        if hashlib.sha256(path.read_bytes()).hexdigest() == i2i.get(f"{kind}_sha256"):
            return path, 0
    print(f"img2img {kind} file(s) {', '.join(str(p) for p in existing)} CHANGED "
          f"since the run (sha256 mismatch)", file=sys.stderr)
    return None, 1


def reproduce_from_sidecar(sidecar_path: str, checkpoints_dir: Optional[str],
                           output: Optional[str] = None,
                           postprocess: bool = True,
                           model_config=None,
                           device: Optional[str] = None) -> int:
    """Regenerate the image a sidecar JSON records with everything it pins
    (seed and block, steps, scheduler kind, eta, spacing, compute dtype,
    checkpoint variant, `attention_fast_math`, `png_compress_level`, the
    TF32 switches of an f32 run on CUDA (set for the regeneration only), and
    for the conditional checkpoint its guidance and the block's classes) and
    compare it byte for byte with the original when that is next to the
    sidecar. An img2img sidecar is rebuilt from its source (and mask) file,
    next to the sidecar or at its recorded path, checked by SHA-256. 0 =
    reproduced (and identical where the original was there), 1 = failure,
    different bytes, or a missing or changed source, 2 = a sidecar this
    slice cannot reproduce (a block sampled over a mesh of more devices than
    this host has, an in-memory img2img source), or one whose sampler or
    dtype had to be assumed and could not be checked. A mesh block is
    rebuilt over the recorded mesh, its axes and devices (rc 2 where this
    host lacks one of them); a block that records only `dp_mesh` over a
    1-D mesh of that size (on the CPU, repeats of the CPU device).

    The initial noise of the recorded seed is hashed before anything is
    written: a sidecar from another noise stream (the JAX package's, or
    the other device's generator) is refused, never regenerated into a
    different image."""
    meta = json.loads(Path(sidecar_path).read_text(encoding="utf-8"))
    cls, seed = meta["class"], meta["seed"]
    if seed is None:
        print("sidecar records no seed — cannot reproduce", file=sys.stderr)
        return 1
    sched = meta.get("scheduler") or {}
    # a block sampled over a mesh is rebuilt over the recorded mesh (or,
    # from `dp_mesh` alone, a 1-D mesh of that size): the shard shapes pick
    # the convolution algorithms, and a 'model' axis the sharded layers
    try:
        mesh = recorded_mesh(meta.get("block") or {}, device)
    except LookupError as refused:
        print(str(refused), file=sys.stderr)
        return 2
    i2i = meta.get("img2img")
    source = mask = None
    if i2i:
        source, rc = _resolve_img2img_file(sidecar_path, i2i, "source")
        if source is None:
            return rc
        if i2i.get("mask_sha256"):
            mask, rc = _resolve_img2img_file(sidecar_path, i2i, "mask")
            if mask is None:
                return rc
    # sidecars that predate dtype recording came from f32 or bf16 runs:
    # try f32, then bf16, against the original's bytes
    dtype_recorded = "dtype" in sched
    names = [sched["dtype"]] if dtype_recorded else ["float32", "bfloat16"]
    candidates = [getattr(torch, n) for n in names]
    kind_recorded = "kind" in sched
    if not kind_recorded:
        print("warning: sidecar predates sampler-kind recording — assuming "
              "the DDPM ancestral sampler", file=sys.stderr)
    art = meta.get("artifact") or {}
    out_path = _output_path(sidecar_path, meta, output)
    original = Path(sidecar_path).with_name(meta["filename"])
    block = meta.get("block")
    seeds = np.asarray(block["seeds"] if block else [seed], np.uint32)

    with tf32_as_recorded(sched):
        for i, compute_dtype in enumerate(candidates):
            gen = ImageGenerator(checkpoints_dir=checkpoints_dir,
                                 model_config=model_config, device=device,
                                 compute_dtype=compute_dtype,
                                 model_variant=sched.get("model_variant", "best"),
                                 # the class id comes again from the class name
                                 # and the checkpoint's metadata; a recorded
                                 # guidance map is rebuilt whole with the scalar
                                 # of its absent classes, since a mixed block's
                                 # table depends on every row
                                 conditional=bool(sched.get("conditional", False)),
                                 guidance_scale=float(sched.get(
                                     "guidance_default", sched.get("guidance_scale", 0.0))),
                                 guidance_map=sched.get("guidance_map"))
            gen.set_inference_steps(int(meta["inference_steps"]))
            if mesh is not None:
                gen.set_mesh(mesh)
            gen.scheduler_kind = sched.get("kind", "ddpm")
            gen.ddim_eta = float(sched.get("ddim_eta", 0.0))
            gen.timestep_spacing = sched.get("timestep_spacing", "leading")
            if sched.get("attention_fast_math"):
                gen.model_manager.set_attention_tuning(fast_math=True)
            if sched.get("png_compress_level") is not None:
                gen.png_compress_level = int(sched["png_compress_level"])
            if i == 0 and meta.get("noise_hash"):
                index = int(block["index"]) if block else 0
                mine = noise_hash(gen._sampler().initial_noise(seeds[index:index + 1])[0]
                                  .cpu().numpy())
                if mine != meta["noise_hash"]:
                    print(f"initial-noise hash MISMATCH: seed {int(seeds[index])} gives "
                          f"{mine} on {gen.model_manager.device}, the sidecar records "
                          f"{meta['noise_hash']} (device {meta.get('device')!r}): it was "
                          f"written by another noise stream (the JAX package, or the "
                          f"other device's generator); nothing regenerated",
                          file=sys.stderr)
                    return 1
            if i2i:
                # the img2img block records its own postprocess setting
                ok, _ = gen.augment_single_image(
                    cls, str(source), out_path, strength=float(i2i["strength"]),
                    mask=str(mask) if mask else None,
                    postprocess=bool(i2i.get("postprocess", False)), seed=int(seed))
            elif art.get("format") == "jpeg":
                ok = _reproduce_console_jpeg(gen, meta, out_path)
            elif block:
                ok = gen.regenerate_block_image(cls, out_path, postprocess=postprocess,
                                                block=block)
            else:
                ok, _ = gen.generate_single_image(cls, out_path, postprocess=postprocess,
                                                  seed=int(seed))
            if not ok:
                print(f"generation failed for class {cls}", file=sys.stderr)
                return 1
            if original.exists():
                if original.read_bytes() == Path(out_path).read_bytes():
                    suffix = ("" if dtype_recorded else
                              f" (legacy sidecar; compute dtype {names[i]})")
                    print(f"reproduced {meta['filename']} -> {out_path} "
                          f"(byte-identical to the original){suffix}")
                    return 0
                if i + 1 < len(candidates):
                    print(f"bytes differ with {names[i]}; sidecar predates dtype "
                          f"recording — retrying with {names[i + 1]}", file=sys.stderr)
                    continue
                print(f"reproduced {meta['filename']} -> {out_path}, but bytes DIFFER "
                      f"from the original (tried dtype {'/'.join(names)}; different "
                      f"checkpoint, or postprocess mismatch — try --no-postprocess)",
                      file=sys.stderr)
                return 1
            print(f"reproduced {meta['filename']} -> {out_path} (initial-noise hash "
                  f"verified; original not present for byte comparison)")
            if not (kind_recorded and dtype_recorded):
                assumed = [what for what, ok in (("sampler kind", kind_recorded),
                                                 ("compute dtype", dtype_recorded)) if not ok]
                print(f"UNVERIFIED: {' and '.join(assumed)} assumed and the original "
                      f"image is not available to compare against", file=sys.stderr)
                return 2
            return 0
    return 1


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


def interactive_menu(gen: ConsoleGenerator) -> Optional[Dict[str, int]]:
    """Lists the classes and reads 'MEL:50,NV:20' from stdin; None on an
    empty line."""
    classes = gen.list_classes()
    print("available classes:")
    for i, cls in enumerate(classes, 1):
        print(f"  {i}. {cls}")
    print("enter selections as 'MEL:50,NV:20' (empty to quit):")
    line = input("> ").strip()
    if not line:
        return None
    return _parse_class_counts(line)


def augment_from_cli(args, model_config=None) -> int:
    """--augment-source: `--count` img2img / inpainting variants of one
    source image through the library generator (PNGs and sidecars that
    `--reproduce` rebuilds with the source file). Exactly one class, ddpm or
    ddim, postprocessing off; rc 0 only if every variant was written."""
    if not args.classes or len(args.classes) != 1:
        print("--augment-source requires exactly one class via --classes",
              file=sys.stderr)
        return 1
    if args.scheduler not in ("ddpm", "ddim"):
        print(f"--augment-source supports ddpm/ddim only (multistep solver "
              f"histories cannot start mid-walk); got {args.scheduler}",
              file=sys.stderr)
        return 1
    cls = args.classes[0]
    out_dir = Path(args.output) if args.output else Path.cwd() / "augmented"
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = ImageGenerator(checkpoints_dir=args.checkpoints, model_config=model_config,
                         device=args.device, model_variant=args.model_variant,
                         conditional=args.conditional,
                         guidance_scale=args.guidance_scale)
    gen.set_inference_steps(args.steps)
    gen.scheduler_kind = args.scheduler
    gen.timestep_spacing = args.timestep_spacing
    stem = Path(args.augment_source).stem
    count = max(1, args.count)
    n_ok = 0
    for i in range(count):
        seed = (int(args.seed) + i) if args.seed is not None else None
        ok, _ = gen.augment_single_image(
            cls, args.augment_source, str(out_dir / f"{stem}_aug_{i:04d}.png"),
            strength=args.augment_strength, mask=args.augment_mask,
            # off: the per-class mean shift would recolour the kept region
            postprocess=False, seed=seed)
        n_ok += int(ok)
    print(f"augmented {n_ok}/{count} -> {out_dir}")
    return 0 if n_ok == count else 1


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
    p.add_argument("--interactive", action="store_true",
                   help="list the classes and read the counts from stdin")
    p.add_argument("--list-classes", action="store_true")
    p.add_argument("--base-dir", type=str, default=None)
    p.add_argument("--checkpoints", type=str, default=None)
    p.add_argument("--steps", type=int, default=1000,
                   help="inference steps (1-1000)")
    p.add_argument("--batch", type=int, default=8, help="device batch size")
    p.add_argument("--scheduler", choices=list(SCHEDULERS), default="ddpm")
    p.add_argument("--timestep-spacing", choices=["leading", "trailing"],
                   default="leading",
                   help="'leading' = reference parity; 'trailing' always "
                        "visits t=T-1 — the standard few-step quality fix "
                        "(recorded in sidecars)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--model-variant", default="best", metavar="V",
                   help="checkpoint variant to sample: 'best' = reference "
                        "naming unet_<CLASS>_best.pth. Recorded in sidecars")
    p.add_argument("--conditional", action="store_true",
                   help="sample the one class-conditional checkpoint "
                        "(unet_conditional_<variant>.pth and its .json "
                        "metadata, written by the conditional trainer) "
                        "instead of per-class checkpoints")
    p.add_argument("--guidance-scale", type=float, default=0.0, metavar="S",
                   help="classifier-free guidance weight for --conditional "
                        "(0/1 = plain conditional; > 1 = guided, one "
                        "2B-batched UNet forward per step). Recorded in sidecars")
    p.add_argument("--guidance-map", default=None, metavar="SPEC",
                   help="per-class guidance for --conditional, e.g. "
                        "'MEL=2.5,NV=2' (absent classes use --guidance-scale; "
                        "weights <= 1 mean no guidance)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to sample on (cuda runs the hand-written "
                        "attention kernel; cpu runs its plain version)")
    p.add_argument("--dp-mesh", type=int, default=0, metavar="N",
                   help="shard sampling over an N-device data-parallel mesh "
                        "(-1 = every local card; 0 = one device). Per-seed "
                        "noise streams keep each image the one-device image; "
                        "sidecars record the mesh (size, axes and devices) and "
                        "--reproduce rebuilds it. With --device cpu the "
                        "mesh is N repeats of the CPU device (the only place "
                        "a repeated device is accepted)")
    p.add_argument("--augment-source", type=str, metavar="IMAGE",
                   help="img2img mode: forward-noise this image to "
                        "--augment-strength of the walk and denoise it with the "
                        "configured sampler (ddpm/ddim only). Needs exactly one "
                        "class via --classes; writes --count PNG variants to "
                        "--output with sidecars (--reproduce rebuilds them with "
                        "the source file)")
    p.add_argument("--augment-strength", type=float, default=0.6, metavar="S",
                   help="fraction of the reverse walk run on the source "
                        "(0<S<=1; lower = closer to the source)")
    p.add_argument("--augment-mask", type=str, metavar="MASK",
                   help="optional greyscale mask for inpainting: white (1) = "
                        "regenerate, black (0) = keep the source pixel")
    p.add_argument("--reproduce", type=str, metavar="SIDECAR_JSON",
                   help="regenerate the exact image a per-image sidecar JSON "
                        "records (verified by the initial-noise hash, and "
                        "byte for byte against the original next to it). "
                        "Use --no-postprocess if the original was generated "
                        "without colour postprocessing")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.reproduce:
        return reproduce_from_sidecar(args.reproduce, args.checkpoints,
                                      output=args.output,
                                      postprocess=not args.no_postprocess,
                                      device=args.device)
    if args.augment_source:
        return augment_from_cli(args)
    gen = ConsoleGenerator(base_dir=args.base_dir, checkpoints_dir=args.checkpoints,
                           inference_steps=args.steps, batch_size=args.batch,
                           scheduler=args.scheduler, seed=args.seed,
                           timestep_spacing=args.timestep_spacing,
                           model_variant=args.model_variant, device=args.device,
                           conditional=args.conditional,
                           guidance_scale=args.guidance_scale,
                           guidance_map=parse_guidance_map(args.guidance_map),
                           mesh=data_mesh(args.dp_mesh, args.device) if args.dp_mesh else None)
    if args.list_classes:
        classes = gen.list_classes()
        if not classes:
            print(f"no model checkpoints (unet_<CLASS>_best.pth) found in "
                  f"{gen.model_manager.checkpoints_dir}", file=sys.stderr)
        for cls in classes:
            print(cls)
        return 0
    if args.interactive:
        counts = interactive_menu(gen)
        if not counts:
            return 0
    elif args.class_counts:
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
