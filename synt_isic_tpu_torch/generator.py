"""ImageGenerator: the library generation engine and public facade, on a
CUDA device.

The port of `synt_isic_tpu/generator.py`, for per-class models and for the
one class-conditional checkpoint with classifier-free guidance
(`conditional`, `guidance_scale`, `guidance_map`): `set_progress_callback`,
`set_log_callback`, `set_generation_seed`, `set_inference_steps`,
`set_save_trajectory`, `get_available_classes`, `validate_models`,
`generate_single_image`, `regenerate_block_image`, `generate_images`,
`generate_batch_images`, `augment_single_image` (img2img and inpainting),
`stop_generation`, `get_generation_status`, `cleanup`.

The same contract as the JAX package:
  * seed bookkeeping: per-class offset = MD5(class)[:8] & 0x7fffffff,
    per-image seed = (base + offset + i) & 0x7fffffff; random mode draws a
    recorded seed with `secrets.randbelow(0x7fffffff)`;
  * artifacts: `<output>/<class>/ISIC_%07d.png` per-class numbering, a
    sidecar JSON per image with the same fields (the SHA-256 noise hash,
    the sampler actually used, the compute dtype by its JAX name, the
    checkpoint variant, and `attention_fast_math` / `png_compress_level`
    only when set), `synthetic_dataset.csv` rows, per-class colour
    postprocessing, cooperative `stop_generation`, a `between_blocks_hook`;
  * images go through the sampler in device blocks of `batch_size` seeds:
    of one class with per-class models; spanning classes with the
    conditional checkpoint, which takes a label per image. A multi-image
    block records its seeds and the image's index (and, conditional, every
    image's class) in the sidecar, so `--reproduce` can rebuild the same
    block. A class whose model does not load is dropped without its
    block-mates;
  * conditional sidecars record `conditional`, the image's effective
    `guidance_scale` and, when set, the whole `guidance_map` with the
    generator's own scalar beside it (`guidance_default`, which the JAX
    package does not record: without it `--reproduce` cannot rebuild the
    rows of classes absent from the map, see ROADMAP C5).

The noise streams are the port's own (`diffusion/sampler.py`), so a seed
gives other images here than in the JAX package. `generate_images` runs the
JAX package's two-stage pipeline: `sample()` returns once a block's walk is
queued (its noise hashes come from a pinned copy made before the walk), the
block's images start for a pinned host buffer at once with an event behind
them, block k+1 is queued, and only then are block k's PNGs, sidecars and
CSV rows written, waiting on block k's event alone, while block k+1 runs on
the device. A stop between blocks leaves the block in flight unwritten, as
in the JAX package. Trajectory mode (integrated XAI) keeps one block in
flight: two captured walks would double the capped device footprint.

Integrated XAI (`set_xai_analyzer`, `set_xai_frequency`,
`set_save_trajectory`): with an analyzer set and trajectories on, a block
keeps every denoise step on the device (the block capped so the capture
stays within 4 GiB) and every `xai_frequency`-th image of a class has its
trajectory analysed (`analyze_trajectory`), the result written to
`<output>/xai_results/<class>/xai_<stem>_<timestamp>.json`; a failed
analysis is logged and generation goes on. `set_xai_hook` keeps the
reference's inactive legacy hook.

Data-parallel sampling (`set_mesh`, reference `generator.py:200-206,
305-307`): every device block goes through `parallel.ShardedSampler`, its
seeds split over the mesh's 'data' axis (padded cyclically), each shard
walked on its device. Per-seed noise streams keep each image the
single-device image up to batch-composition rounding, and a block sampled
over a mesh records the mesh in its sidecar, even for one image:
`block.dp_mesh`, its device count, as the JAX generator records it, and
`block.mesh`, its axes and devices (`parallel.mesh.mesh_record`). On a
('data', 'model') mesh each shard walks on its row with the UNet
channel-sharded over the 'model' axis (tensor parallelism); `--reproduce`
rebuilds exactly the recorded mesh, 'model' axis included, so such a block
regenerates byte for byte. A sidecar with `dp_mesh` alone (the JAX
package's, or the port's before it recorded the mesh) is rebuilt over a
1-D mesh of that many devices, as the JAX CLI does.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import secrets
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from PIL import Image

from .cache import CacheManager
from .diffusion.sampler import HostCopy, to_uint8_images
from .parallel.mesh import mesh_record
from .parallel.sharded_sampler import ShardedSampler
from .io.color_stats import apply_color_postprocessing, load_color_statistics
from .io.csv_io import append_synthetic_row, initialize_synthetic_csv
from .io.images import save_image, write_sidecar_metadata
from .model_manager import ModelManager
from .utils.config import ConfigManager
from .utils.logging import Logger
from .utils.paths import PathManager


def parse_guidance_map(spec: Optional[str]) -> Optional[Dict[str, float]]:
    """Parse a CLI per-class guidance spec: 'MEL=2.5,NV=2' -> {...}.

    Empty/None -> None (scalar guidance path). Raises ValueError on
    malformed entries so surfaces fail loudly at argument time."""
    if not spec:
        return None
    out: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"guidance-map entry {part!r} is not CLASS=G")
        name, val = part.split("=", 1)
        g = float(val)
        if g < 0.0:
            raise ValueError(f"guidance must be >= 0, got {part!r}")
        out[name.strip()] = g
    return out or None


def class_seed_offset(class_name: str) -> int:
    """MD5-derived 31-bit per-class offset (`image_generator.py:586-592`)."""
    h = hashlib.md5(class_name.encode("utf-8")).hexdigest()
    return int(h[:8], 16) & 0x7FFFFFFF


def dtype_name(dtype: torch.dtype) -> str:
    """The sidecar name of a compute dtype: "float32" / "bfloat16", the
    names the JAX package writes."""
    return str(dtype).removeprefix("torch.")


def tf32_state(device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """The sidecar's `tf32` field for an f32 run on CUDA: whether cuDNN's
    convolutions and the matrix products ran in TF32. Both are process-wide
    switches that change an f32 image's bytes there. Nothing for other
    runs, which they do not touch."""
    if torch.device(device).type != "cuda" or dtype != torch.float32:
        return {}
    return {"tf32": {"cudnn": bool(torch.backends.cudnn.allow_tf32),
                     "matmul": bool(torch.backends.cuda.matmul.allow_tf32)}}


@contextlib.contextmanager
def tf32_as_recorded(scheduler: Dict[str, Any]):
    """Inside the block, the TF32 switches as a sidecar's `scheduler`
    records them; restored afterwards. A sidecar without the field leaves
    them as they are (PyTorch's defaults unless the caller changed them)."""
    recorded = scheduler.get("tf32")
    if recorded is None:
        yield
        return
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = bool(recorded["cudnn"])
    torch.backends.cuda.matmul.allow_tf32 = bool(recorded["matmul"])
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class ImageGenerator:
    def __init__(self, config: Optional[ConfigManager] = None,
                 checkpoints_dir: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 model_config=None,
                 model_variant: str = "best",
                 conditional: Optional[bool] = None,
                 guidance_scale: Optional[float] = None,
                 guidance_map: Optional[Dict[str, float]] = None):
        self.config = config
        # an explicit argument wins, False and 0.0 included; None defers to
        # the config's compute section (off by default)
        if conditional is None:
            conditional = bool(config.get("compute.conditional", False)) \
                if config is not None else False
        if guidance_scale is None:
            guidance_scale = float(config.get("compute.guidance_scale", 0.0)) \
                if config is not None else 0.0
        self.guidance_scale = float(guidance_scale)
        # per-class guidance {class: g} (conditional mode); classes not in
        # the map take guidance_scale
        if guidance_map is None and config is not None:
            guidance_map = config.get("compute.guidance_map", None)
        self.guidance_map = ({str(k): float(v) for k, v in guidance_map.items()}
                             if guidance_map else None)
        project_root = config.project_root if config else None
        self.path_manager = PathManager(project_root)
        log_dir = config.get_path("logs") if config else None
        self.logger = Logger("image_generator", log_dir=log_dir)
        cache_dir = config.get_path("cache") if config else None
        self.cache_manager = CacheManager(cache_dir) if cache_dir else None
        ckpt_dir = checkpoints_dir or (config.get_path("checkpoints") if config
                                       else str(self.path_manager.get_checkpoints_dir()))
        self.model_manager = ModelManager(
            checkpoints_dir=ckpt_dir, cache_manager=self.cache_manager,
            logger=self.logger, device=device, dtype=compute_dtype,
            model_config=model_config, variant=model_variant,
            conditional=conditional)
        # PNG zlib level (None = PIL default): changes the file's bytes, not
        # its pixels, so it is recorded in sidecars and honoured by --reproduce
        self.png_compress_level: Optional[int] = (
            config.get("compute.png_compress_level", None) if config else None)

        self.inference_steps = int(config.get_generation_param("inference_timesteps")) \
            if config else 50
        self.inference_steps = max(1, min(1000, self.inference_steps))
        self.batch_size = int(config.get("generation.batch_size", 1)) if config else 1
        self.scheduler_kind = (config.get("compute.scheduler", "ddpm")
                               if config else "ddpm")
        self.ddim_eta = float(config.get("compute.ddim_eta", 0.0)) if config else 0.0
        # 'leading' = reference parity; 'trailing' = few-step quality fix
        self.timestep_spacing = (config.get("compute.timestep_spacing", "leading")
                                 if config else "leading")

        self.color_statistics = load_color_statistics(
            Path(ckpt_dir) / "color_statistics.json")

        self.base_seed: Optional[int] = None
        self.save_trajectory = True
        self.xai_frequency = int(config.get_generation_param("xai_frequency")) \
            if config else 1
        self.xai_analyzer = None
        self.xai_hook: Optional[Callable] = None
        self.xai_hook_every_n = 10

        self.progress_callback: Optional[Callable[[int, int, str], None]] = None
        self.log_callback: Optional[Callable[[str, str], None]] = None

        self.mesh = None  # set_mesh() enables data-parallel sampling
        self._sharded: Dict[int, ShardedSampler] = {}

        self.is_generating = False
        self.stop_requested = False
        # called between device blocks of a generate_images run (same
        # thread): a caller can slip other work in ahead of the rest
        self.between_blocks_hook: Optional[Callable[[], None]] = None

    # -- wiring ----------------------------------------------------------------------
    def set_progress_callback(self, cb: Callable[[int, int, str], None]) -> None:
        self.progress_callback = cb

    def set_log_callback(self, cb: Callable[[str, str], None]) -> None:
        self.log_callback = cb

    def set_xai_hook(self, hook: Callable, every_n: int = 10) -> None:
        """Legacy hook kept for API parity (the reference keeps it wired but
        inactive, `image_generator.py:714-715`)."""
        self.xai_hook = hook
        self.xai_hook_every_n = every_n

    def set_xai_analyzer(self, analyzer) -> None:
        """`analyzer` exposes `analyze_trajectory(trajectory, class_name,
        seed, inference_steps, filename, file_path)` (the integrated-XAI
        adapter protocol, `xai/xai_integration.py:84`)."""
        self.xai_analyzer = analyzer

    def set_xai_frequency(self, n: int) -> None:
        self.xai_frequency = max(1, int(n))

    def set_save_trajectory(self, flag: bool) -> None:
        self.save_trajectory = bool(flag)

    def set_generation_seed(self, seed: Optional[int]) -> None:
        self.base_seed = None if seed is None else int(seed)

    def set_inference_steps(self, steps: int) -> None:
        self.inference_steps = max(1, min(1000, int(steps)))

    def set_mesh(self, mesh) -> None:
        """Shard sampling blocks over a `parallel.Mesh` ('data' axis), or
        sample on the one device again with None. On a ('data', 'model')
        mesh each block shard walks on its row with the UNet channel-sharded
        over the 'model' axis (tensor parallelism, `ShardedSampler`)."""
        if mesh is not None:
            mesh.shard_devices("data")
        self.mesh = mesh
        self._sharded.clear()

    # -- logging / progress ----------------------------------------------------------
    def _log(self, msg: str, level: str = "info") -> None:
        getattr(self.logger, f"log_{level}", self.logger.log_info)(msg)
        if self.log_callback:
            try:
                self.log_callback(msg, level)
            except Exception:  # a broken UI callback must not stop generation
                pass

    def _progress(self, done: int, total: int, msg: str) -> None:
        if self.progress_callback:
            try:
                self.progress_callback(done, total, msg)
            except Exception:  # a broken UI callback must not stop generation
                pass

    # -- discovery / validation ---------------------------------------------------------
    def get_available_classes(self) -> List[str]:
        return self.model_manager.get_available_classes()

    def validate_models(self, class_names: Optional[List[str]] = None) -> Dict[str, bool]:
        class_names = class_names or self.get_available_classes()
        results = {}
        for cls in class_names:
            ok = self.model_manager.load_model(cls)
            results[cls] = bool(ok and self.model_manager.validate_model(cls))
        return results

    # -- seed plumbing ---------------------------------------------------------------------
    def _seed_for(self, class_name: str, index: int,
                  offsets: Dict[str, int]) -> int:
        if self.base_seed is not None:
            return (int(self.base_seed) + offsets.get(class_name, 0) + index) & 0x7FFFFFFF
        return secrets.randbelow(0x7FFFFFFF)

    def _guidance_table(self) -> Optional[Tuple[float, ...]]:
        """The per-class-id guidance tuple of a conditional generator with a
        `guidance_map`; None otherwise, which keeps the scalar path.

        As everywhere in the package, g <= 1 means no guidance, so such
        entries (the default guidance_scale 0.0 of classes absent from the
        map included) become a combine weight of 1.0, never a raw 0.0 that
        would sample the class unconditionally. A table whose every row is
        1.0 collapses to None: the single-forward path, same prediction,
        half the work. A pure function of (map, guidance_scale), so
        `--reproduce` rebuilds the same table."""
        mm = self.model_manager
        if not (mm.conditional and self.guidance_map):
            return None

        def effective(g: float) -> float:
            return float(g) if float(g) > 1.0 else 1.0

        table = [effective(self.guidance_scale)] * int(mm.config.num_class_embeds)
        for cname in mm.get_available_classes():
            table[mm.class_id(cname)] = effective(
                self.guidance_map.get(cname, self.guidance_scale))
        if all(g == 1.0 for g in table):
            return None
        return tuple(table)

    # -- core generation --------------------------------------------------------------------
    def _sampler(self, steps: Optional[int] = None):
        """The sampler of this generator's settings (at `steps`, else its
        own inference steps): the one its blocks run."""
        return self.model_manager.create_sampler(
            steps or self.inference_steps, scheduler=self.scheduler_kind,
            ddim_eta=self.ddim_eta, timestep_spacing=self.timestep_spacing,
            guidance_scale=self.guidance_scale,
            guidance_table=self._guidance_table())

    def block_sampler(self, steps: Optional[int] = None):
        """The sampler a device block goes through: `_sampler(steps)`, over
        the mesh when one is set."""
        sampler = self._sampler(steps)
        if self.mesh is None:
            return sampler
        sharded = self._sharded.get(id(sampler))
        if sharded is None or sharded.sampler is not sampler:
            sharded = self._sharded[id(sampler)] = ShardedSampler(sampler, self.mesh)
        return sharded

    def _block_record(self, seeds: np.ndarray, index: int,
                      classes: Optional[List[str]] = None,
                      always: bool = False) -> Optional[Dict[str, Any]]:
        """The sidecar's `block` field of image `index` of a device block: a
        multi-image block (or any, with `always`) records its seeds (and,
        conditional, its classes) so --reproduce can rebuild it; a block
        sampled over a mesh also records the mesh (`mesh_record`: its device
        count, axes and devices), even for one image."""
        if len(seeds) == 1 and self.mesh is None and not always:
            return None
        return {"block": {"seeds": [int(s) for s in seeds], "index": int(index),
                          **({"classes": list(classes)}
                             if self.model_manager.conditional and classes else {}),
                          **(mesh_record(self.mesh) if self.mesh is not None else {})}}

    def _sample_batch(self, class_name: str, seeds: np.ndarray,
                      capture_trajectory: bool) -> Optional[Dict[str, Any]]:
        return self._sample_block([class_name] * len(seeds), seeds,
                                  capture_trajectory)

    def _sample_block(self, classes: List[str], seeds: np.ndarray,
                      capture_trajectory: bool) -> Optional[Dict[str, Any]]:
        """One device batch; `classes[j]` is image j's class. Per-class
        models take a block of one class; the conditional model takes a
        label per image, so its blocks may mix classes. None when a class's
        model does not load."""
        mm = self.model_manager
        if not mm.conditional and len(set(classes)) > 1:
            raise ValueError("mixed-class block requires conditional mode")
        for cls in dict.fromkeys(classes):
            if not mm.load_model(cls):
                return None
        labels = (np.asarray([mm.class_id(c) for c in classes], np.int64)
                  if mm.conditional else None)
        return self.block_sampler().sample(mm.loaded_models[classes[0]], seeds,
                                           capture_trajectory=capture_trajectory,
                                           class_labels=labels)

    def generate_single_image(self, class_name: str, output_path: str,
                              postprocess: bool = True,
                              seed: Optional[int] = None
                              ) -> Tuple[bool, Optional[np.ndarray]]:
        """One image end to end. Returns (success, trajectory or None); the
        trajectory is (S, H, W, C) float32, every denoise step."""
        if self.stop_requested:
            return False, None
        try:
            seed = int(seed) if seed is not None else secrets.randbelow(0x7FFFFFFF)
            out = self._sample_batch(class_name, np.asarray([seed], np.uint32),
                                     self.save_trajectory)
            if out is None:
                return False, None
            self._write_image_artifacts(out, 0, class_name, output_path,
                                        postprocess, seed)
            traj = (out["trajectory"][:, 0].cpu().numpy()
                    if self.save_trajectory else None)
            self._log(f"image generated for class {class_name}: {output_path}")
            return True, traj
        except Exception as exc:  # reported through the log and the result
            self._log(f"generation failed for {class_name}: {exc}", "error")
            return False, None

    def regenerate_block_image(self, class_name: str, output_path: str,
                               postprocess: bool,
                               block: Dict[str, Any]) -> bool:
        """Rebuild the device block a sidecar's `block` field records (the
        same seeds in the same order) and write one image from it: the
        batch size changes the convolution algorithms and so the last bits
        of the images, so byte identity needs the original block."""
        seeds = np.asarray(block["seeds"], np.uint32)
        idx = int(block["index"])
        classes = list(block.get("classes") or [class_name] * len(seeds))
        if not (0 <= idx < len(seeds)) or classes[idx] != class_name:
            self._log(f"sidecar block is inconsistent (index {idx}, "
                      f"{len(seeds)} seeds, classes {classes})", "error")
            return False
        out = self._sample_block(classes, seeds, False)
        if out is None:
            return False
        self._write_image_artifacts(
            out, idx, class_name, output_path, postprocess, int(seeds[idx]),
            extra=self._block_record(seeds, idx, classes, always=True))
        self._log(f"image regenerated from its recorded device block "
                  f"(size {len(seeds)}, index {idx}): {output_path}")
        return True

    # -- img2img / inpainting augmentation -------------------------------------------
    @staticmethod
    def _load_source_image(source, image_size: int):
        """Path or array -> ((H, W, C) f32 in [-1, 1], name, sha256).

        A path is hashed over its file bytes (the reproduce contract pins
        the input file) and resized BILINEAR; an array is hashed over its
        f32 pixel bytes, and rescaled from 0-255 when its original dtype is
        an integer one (a dark uint8 image with every pixel <= 1 included)
        or, for floats of unknown range, when its maximum exceeds 1.5."""
        if isinstance(source, (str, Path)):
            data = Path(source).read_bytes()
            digest = hashlib.sha256(data).hexdigest()
            pil = Image.open(Path(source)).convert("RGB")
            if pil.size != (image_size, image_size):
                pil = pil.resize((image_size, image_size), Image.BILINEAR)
            arr = np.asarray(pil, np.float32) / 127.5 - 1.0
            return arr, Path(source).name, digest
        raw = np.asarray(source)
        is_int = np.issubdtype(raw.dtype, np.integer)
        arr = raw.astype(np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        if is_int or arr.max() > 1.5:
            arr = arr / 127.5 - 1.0
        digest = hashlib.sha256(
            np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()
        return arr, None, digest

    @staticmethod
    def _load_mask(mask, image_size: int):
        """Path or array -> ((H, W) f32 in [0, 1], name, sha256), or (None,
        None, None). 1 = regenerate, 0 = keep the source pixel. A path is
        read as "L" and resized NEAREST."""
        if mask is None:
            return None, None, None
        if isinstance(mask, (str, Path)):
            data = Path(mask).read_bytes()
            digest = hashlib.sha256(data).hexdigest()
            pil = Image.open(Path(mask)).convert("L")
            if pil.size != (image_size, image_size):
                pil = pil.resize((image_size, image_size), Image.NEAREST)
            return np.asarray(pil, np.float32) / 255.0, Path(mask).name, digest
        arr = np.asarray(mask, np.float32)
        digest = hashlib.sha256(
            np.ascontiguousarray(arr, np.float32).tobytes()).hexdigest()
        return arr, None, digest

    def augment_single_image(self, class_name: str, source_image,
                             output_path: str, strength: float = 0.6,
                             mask=None, postprocess: bool = False,
                             seed: Optional[int] = None
                             ) -> Tuple[bool, Optional[np.ndarray]]:
        """img2img / inpainting through the generator's artifact path.

        `source_image` (path or array, any range) is forward-noised to
        `strength` of the walk and denoised with the configured sampler
        (ddpm or ddim only); `mask` (path or array; 1 = regenerate, 0 =
        keep) makes it inpainting. The artifacts are those of
        `generate_single_image` plus an `img2img` sidecar block (strength,
        `t_start`, postprocess, the source's and mask's SHA-256, and their
        names and paths when given as paths), from which `cli --reproduce`
        rebuilds the bytes with the original files. Postprocessing is off
        by default: the mean shift would recolour the kept region. Returns
        (success, trajectory (steps run, H, W, C) or None)."""
        if self.stop_requested:
            return False, None
        try:
            seed = int(seed) if seed is not None else secrets.randbelow(0x7FFFFFFF)
            mm = self.model_manager
            if not mm.load_model(class_name):
                return False, None
            size = mm.config.sample_size
            init, src_name, src_sha = self._load_source_image(source_image, size)
            m, mask_name, mask_sha = self._load_mask(mask, size)
            labels = mm.class_id(class_name) if mm.conditional else None
            out = self._sampler().img2img(
                mm.loaded_models[class_name], np.asarray([seed], np.uint32), init,
                strength=float(strength), mask=m,
                capture_trajectory=self.save_trajectory, class_labels=labels)
            extra = {"img2img": {
                "strength": float(strength),
                "t_start": int(out["t_start"]),
                "postprocess": bool(postprocess),
                "source_sha256": src_sha,
                **({"source": src_name,
                    "source_path": str(Path(source_image).resolve())}
                   if src_name else {}),
                **({"mask_sha256": mask_sha} if mask_sha else {}),
                **({"mask": mask_name, "mask_path": str(Path(mask).resolve())}
                   if mask_name else {}),
            }}
            self._write_image_artifacts(out, 0, class_name, output_path,
                                        postprocess, seed, extra=extra)
            traj = (out["trajectory"][:, 0].cpu().numpy()
                    if self.save_trajectory else None)
            self._log(f"augmented image for class {class_name} "
                      f"(strength={strength}): {output_path}")
            return True, traj
        except Exception as exc:  # reported through the log and the result
            self._log(f"augmentation failed for {class_name}: {exc}", "error")
            return False, None

    def sidecar_scheduler(self, class_name: Optional[str] = None) -> Dict[str, Any]:
        """The sidecar's `scheduler` block: the reference's static fields,
        then the sampler actually used and every setting that changes the
        output bytes (`attention_fast_math` and `png_compress_level` only
        when set, so other sidecars keep their old field set; the
        conditional fields only in conditional mode: `guidance_scale` is
        `class_name`'s effective weight, and a `guidance_map` is recorded
        whole with the scalar its absent classes take, since a mixed-class
        block's table depends on every row; `tf32` for f32 runs on CUDA)."""
        mm = self.model_manager
        g = (self.guidance_map.get(class_name, self.guidance_scale)
             if self.guidance_map else self.guidance_scale)
        return {
            "num_train_timesteps": 1000,
            "beta_schedule": "squaredcos_cap_v2",
            "prediction_type": "epsilon",
            "kind": self.scheduler_kind,
            "ddim_eta": self.ddim_eta,
            "timestep_spacing": self.timestep_spacing,
            "dtype": dtype_name(mm.dtype),
            "model_variant": mm.variant,
            **({"attention_fast_math": True} if mm.attention_fast_math else {}),
            **tf32_state(mm.device, mm.dtype),
            **({"conditional": True, "guidance_scale": g,
                **({"guidance_map": dict(self.guidance_map),
                    "guidance_default": self.guidance_scale}
                   if self.guidance_map else {})}
               if mm.conditional else {}),
            **({"png_compress_level": int(self.png_compress_level)}
               if self.png_compress_level is not None else {}),
        }

    def _write_image_artifacts(self, sample_out: Dict[str, Any], idx: int,
                               class_name: str, output_path: str,
                               postprocess: bool, seed: int,
                               extra: Optional[Dict[str, Any]] = None) -> None:
        arr = to_uint8_images(sample_out["images"][idx:idx + 1])[0]
        if postprocess:
            arr = apply_color_postprocessing(
                arr, self.color_statistics.get(class_name))
        save_image(Image.fromarray(arr), output_path,
                   png_compress_level=self.png_compress_level)
        write_sidecar_metadata(
            output_path, class_name=class_name, seed=seed,
            inference_steps=self.inference_steps,
            model_metadata=self.model_manager.model_metadata.get(class_name, {}),
            device=str(self.model_manager.device),
            noise_hash=sample_out["noise_hashes"][idx],
            scheduler=self.sidecar_scheduler(class_name),
            extra=extra)

    def generate_images(self, class_configs: List[Tuple[str, int]],
                        output_dir: str, postprocess: bool = True) -> Dict[str, Any]:
        """Batch generation: every (class, count) in order, in device blocks of
        up to `batch_size` images: of one class with per-class models,
        spanning classes with the conditional checkpoint (a [(MEL, 3),
        (NV, 3), (VASC, 2)] request is one block of 8)."""
        if self.is_generating:
            self._log("generation already running", "warning")
            return {"error": "generation already running"}
        self.is_generating = True
        self.stop_requested = False
        t_start = time.time()
        try:
            output_path = Path(output_dir)
            output_path.mkdir(parents=True, exist_ok=True)
            csv_path = output_path / "synthetic_dataset.csv"
            initialize_synthetic_csv(csv_path)

            offsets = {cls: class_seed_offset(cls) for cls, _ in class_configs} \
                if self.base_seed is not None else {}
            total_images = sum(count for _, count in class_configs)
            generated = 0
            self._log(f"starting generation of {total_images} images")

            # flat work list: (class, per-class image index); the index
            # continues across repeated entries of one class, so a fixed
            # base seed never hands out the same seed twice
            items: List[Tuple[str, int]] = []
            next_idx: Dict[str, int] = {}
            for cls, count in class_configs:
                start = next_idx.get(cls, 0)
                items.extend((cls, start + i) for i in range(count))
                next_idx[cls] = start + count
            class_totals: Dict[str, int] = {}
            for cls, count in class_configs:
                class_totals[cls] = class_totals.get(cls, 0) + count
            class_counts: Dict[str, int] = {}  # ISIC numbering + XAI cadence
            dead: set = set()                  # classes whose model failed to load
            announced: set = set()
            mm = self.model_manager
            mixed = mm.conditional
            need_traj = self.save_trajectory and self.xai_analyzer is not None
            block_cap = self.batch_size
            if need_traj:
                # the capture holds (steps, block, H, W, C) f32 on the device
                frame_bytes = mm.config.sample_size ** 2 * mm.config.in_channels * 4
                block_cap = min(block_cap, max(1, (4 << 30) //
                                               (self.inference_steps * frame_bytes)))

            def block_at(start: int) -> List[Tuple[str, int]]:
                """Up to batch_size items from `start`: one class's run with
                per-class models, any classes with the conditional one; cut
                before the first item of a class known to be dead."""
                end = min(start + block_cap, len(items))
                if not mixed:
                    run = start + 1
                    while run < end and items[run][0] == items[start][0]:
                        run += 1
                    end = run
                blk = items[start:end]
                for k, (cls, _) in enumerate(blk):
                    if cls in dead:
                        return blk[:k]
                return blk

            def queue_block(blk: List[Tuple[str, int]]) -> Optional[tuple]:
                """Queue `blk`'s walk and its images' copy to the host, or
                drop the classes whose model does not load (None). In a
                mixed block one unknown class must not take its block-mates
                with it: the rest are blocked again in the next round."""
                block_classes = list(dict.fromkeys(cls for cls, _ in blk))
                for cls in block_classes:
                    if cls not in announced:
                        announced.add(cls)
                        self._log(f"generating {class_totals[cls]} images for class {cls}")
                        (output_path / cls).mkdir(exist_ok=True)
                failed = [cls for cls in block_classes if not mm.load_model(cls)]
                if failed:
                    for cls in failed:
                        self._log(f"model unavailable for {cls}", "error")
                    dead.update(failed)
                    return None
                seeds = np.asarray([self._seed_for(cls, i, offsets) for cls, i in blk],
                                   dtype=np.uint32)
                out = self._sample_block([cls for cls, _ in blk], seeds, need_traj)
                # one device->host copy for the whole block, started before
                # the next block is queued: read after it, a plain copy
                # would wait for that block too
                return dict(out, images=HostCopy(out["images"])), seeds, blk

            # two stages: block k's files are written while block k+1 runs
            # on the device; one block at a time in trajectory mode
            pipeline = not need_traj
            index = 0
            pending = None   # the block queued in an earlier round, unwritten
            while (index < len(items) or pending is not None) and not self.stop_requested:
                if self.between_blocks_hook is not None:
                    try:
                        self.between_blocks_hook()
                    except Exception as exc:  # the caller's hook must not stop the run
                        self._log(f"between-blocks hook failed: {exc}", "warning")
                    if self.stop_requested:
                        break
                while index < len(items) and items[index][0] in dead:
                    index += 1
                queued = None
                if index < len(items):
                    blk = block_at(index)
                    queued = queue_block(blk)
                    if queued is not None:
                        index += len(blk)
                if not pipeline and queued is not None:
                    pending, queued = queued, None
                if pending is None:
                    pending = queued
                    continue
                (out, seeds, blk), pending = pending, queued
                out = dict(out, images=out["images"].numpy())
                for j, (class_name, _) in enumerate(blk):
                    if self.stop_requested:
                        break
                    class_counts[class_name] = class_counts.get(class_name, 0) + 1
                    isic_number = class_counts[class_name]
                    filename = self.path_manager.get_isic_filename(isic_number)
                    file_path = output_path / class_name / filename
                    # a multi-image (or mesh) block records its layout,
                    # so --reproduce can rebuild the same block
                    block_extra = self._block_record(seeds, j, [c for c, _ in blk])
                    self._write_image_artifacts(out, j, class_name, str(file_path),
                                                postprocess, int(seeds[j]),
                                                extra=block_extra)
                    append_synthetic_row(csv_path, {
                        "filename": filename,
                        "class": class_name,
                        "isic_number": isic_number,
                        "source": "synthetic",
                        "generated_at": str(file_path.stat().st_mtime),
                    })
                    generated += 1
                    # progress in denoise-step units (the reference's scale)
                    self._progress(generated * self.inference_steps,
                                   total_images * self.inference_steps,
                                   f"generated {generated}/{total_images}")
                    if need_traj and isic_number % self.xai_frequency == 0:
                        self._integrated_xai(out["trajectory"][:, j], class_name,
                                             int(seeds[j]), filename, str(file_path))

            elapsed = time.time() - t_start
            result = {
                "generated": generated,
                "requested": total_images,
                "elapsed_seconds": round(elapsed, 2),
                "images_per_second": round(generated / elapsed, 3) if elapsed > 0 else 0,
                "stopped": self.stop_requested,
                "output_dir": str(output_path),
            }
            self._log(f"generation finished: {result}")
            return result
        except Exception as exc:  # reported to the caller in the result
            self._log(f"generation error: {exc}", "error")
            return {"error": str(exc)}
        finally:
            self.is_generating = False

    def _integrated_xai(self, trajectory: torch.Tensor, class_name: str, seed: int,
                        filename: str, file_path: str) -> None:
        """Analyse one image's trajectory and save the result; a failure is
        logged and generation goes on (reference `generator.py:735-750`)."""
        try:
            self._log(f"integrated XAI for {class_name} ({filename})")
            xai_results = self.xai_analyzer.analyze_trajectory(
                trajectory=trajectory.cpu().numpy(), class_name=class_name, seed=seed,
                inference_steps=self.inference_steps, filename=filename,
                file_path=file_path)
            if xai_results:
                self._save_xai_results(xai_results, class_name, filename, file_path)
        except Exception as exc:  # reported through the log; generation goes on
            self._log(f"integrated XAI failed: {exc}", "warning")

    def _save_xai_results(self, xai_results: Dict[str, Any], class_name: str,
                          filename: str, file_path: str) -> None:
        """`xai_results/<class>/xai_<stem>_<ts>.json` beside the class
        folders (reference `image_generator.py:866-886`)."""
        from .xai.pipeline import json_safe

        xai_dir = Path(file_path).parent.parent / "xai_results" / class_name
        xai_dir.mkdir(parents=True, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        out = xai_dir / f"xai_{Path(filename).stem}_{stamp}.json"
        with open(out, "w", encoding="utf-8") as f:
            json.dump(json_safe(xai_results), f, indent=2, ensure_ascii=False, default=str)
        self._log(f"XAI results saved: {out}")

    def generate_batch_images(self, class_name: str, output_dir: str,
                              count: int, batch_size: Optional[int] = None,
                              postprocess: bool = True) -> Dict[str, Any]:
        """One class with an explicit device batch size."""
        if batch_size is not None:
            old, self.batch_size = self.batch_size, max(1, int(batch_size))
            try:
                return self.generate_images([(class_name, count)], output_dir,
                                            postprocess)
            finally:
                self.batch_size = old
        return self.generate_images([(class_name, count)], output_dir, postprocess)

    # -- control ---------------------------------------------------------------------------
    def stop_generation(self) -> None:
        self.stop_requested = True
        self._log("stop requested")

    def get_generation_status(self) -> Dict[str, Any]:
        return {
            "is_generating": self.is_generating,
            "stop_requested": self.stop_requested,
            "loaded_models": list(self.model_manager.loaded_models.keys()),
            "device": str(self.model_manager.device),
        }

    def cleanup(self) -> None:
        self.stop_generation()
        self.model_manager.cleanup()
        if self.cache_manager:
            self.cache_manager.cleanup_temp_files()
        self._log("ImageGenerator cleaned up")
