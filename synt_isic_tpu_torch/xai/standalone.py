"""Standalone XAI run: regenerate a trajectory from its seed and analyze it.

The port of `synt_isic_tpu/xai/standalone.py`, the rebuild of the
reference's XAI-as-a-script mode (`xai/XAI.py` run as a subprocess by the
GUI's XAIWorker, `main.py:62-127`), driven by environment variables:
`XAI_TARGET_CLASS`, `XAI_GENERATION_SEED`, `XAI_INFERENCE_STEPS`,
`XAI_SAVE_EVERY_N`, `XAI_DDPM_MODEL_PATH` (`XAI.py:243-262,588,639`),
`XAI_CONDITIONAL=1` + `XAI_GUIDANCE_SCALE` (the class-conditional
checkpoint's, optionally guided, trajectory), `XAI_COALITIONAL_SHAP`,
`XAI_COALITIONAL_PERMUTATIONS`, `XAI_VIZ_EVERY_N`, `XAI_CHECKPOINTS_DIR`,
`XAI_RESULTS_DIR`, and the port's `XAI_DEVICE` (default `cuda`; `cpu` to
run on the CPU). It loads the classifier and the target class's DDPM,
denoises from the same seed with the port's sampler on the device,
keeping every N-th frame (plus always the last, and the absolute-t mode
when save_every >= steps, `XAI.py:750-779`) streamed to host memory, then
runs the comprehensive pipeline. `XAI_MESH_DEVICES=N` (reference
`standalone.py:140-147`; -1 = every local card) fans the attribution
kernels over an N-device data mesh (on the CPU, N repeats of the CPU
device); the results equal the one-device run's.

    XAI_TARGET_CLASS=MEL XAI_CHECKPOINTS_DIR=checkpoints \
        python -m synt_isic_tpu_torch.xai.standalone
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional

import numpy as np

from ..model_manager import ModelManager
from ..models.classifier import LesionClassifier
from ..utils.config import CLASS_NAMES, NUM_CLASSES
from ..parallel.mesh import data_mesh
from .attribution import XAIAnalyzer, check_mesh
from .pipeline import run_comprehensive_xai_pipeline


def run_standalone_xai(target_class: str = "MEL",
                       seed: int = 42,
                       inference_steps: int = 50,
                       save_every: int = 5,
                       checkpoints_dir: Optional[str] = None,
                       ddpm_model_path: Optional[str] = None,
                       results_dir: Optional[str] = None,
                       model_config=None,
                       num_classes: int = NUM_CLASSES + 1,
                       ig_n_steps: int = 50,
                       shap_n_samples: int = 512,
                       n_bootstrap: int = 1000,
                       n_permutations: int = 10000,
                       with_gradcam: bool = True,
                       with_sanity: bool = True,
                       coalitional_shap: bool = False,
                       coalitional_permutations: int = 256,
                       viz_every_n: int = 1,
                       mesh=None,
                       conditional: bool = False,
                       guidance_scale: float = 0.0,
                       device=None,
                       save_figures: bool = True,
                       log=print) -> Optional[dict]:
    """Full standalone analysis on `device` (CUDA unless named); returns
    the pipeline results dict, or None when the DDPM does not load.
    `save_figures=False` writes the results without the figures. `mesh`
    shards the attribution kernels (`XAIAnalyzer(mesh=)`)."""
    check_mesh(mesh)
    ckpt_dir = Path(checkpoints_dir) if checkpoints_dir else Path("checkpoints")
    log(f"[xai-standalone] class={target_class} seed={seed} "
        f"steps={inference_steps} save_every={save_every}")

    # classifier with fallback chain (XAI.py builds NUM_CLASSES+1 outputs)
    clf_path = ckpt_dir / "classifier.pth"
    if clf_path.exists():
        classifier, counts = LesionClassifier.from_checkpoint(
            str(clf_path), num_classes=num_classes, device=device)
        log(f"[xai-standalone] classifier loaded: {counts}")
    else:
        classifier = LesionClassifier.random_init(num_classes=num_classes, device=device)
        log("[xai-standalone] classifier checkpoint missing — random init")

    # conditional mode: the single class-conditional checkpoint with an
    # optional classifier-free-guidance weight (the trajectory then shows
    # the GUIDED denoising process the production path actually runs)
    mm = ModelManager(checkpoints_dir=str(ckpt_dir), model_config=model_config,
                      conditional=conditional, device=device)
    log(f"[xai-standalone] device {mm.device}")
    ok = mm.load_model(target_class, checkpoint_path=ddpm_model_path)
    if not ok:
        log(f"[xai-standalone] no DDPM checkpoint for {target_class}")
        return None

    sampler = mm.create_sampler(inference_steps,
                                guidance_scale=guidance_scale)
    labels = mm.class_id(target_class) if conditional else None
    # the kept frames are streamed to host memory as the walk goes, so the
    # device holds one frame at a time and the attribution takes ordinary
    # (not inference-mode) tensors. save_every > 0 covers both modes of
    # reference `XAI.py:750-779`: every N-th step when save_every < steps,
    # absolute t when save_every >= steps; 0 keeps every step
    out = sampler.sample(mm.loaded_models[target_class],
                         np.asarray([seed], np.uint32),
                         capture_trajectory=save_every if save_every > 0 else True,
                         stream_to_host=True,
                         class_labels=labels)
    frames = out["trajectory"][:, 0]
    idx = out["save_indices"]
    frame_ts = [float(out["timesteps"][i]) for i in idx]
    log(f"[xai-standalone] trajectory: {len(frames)} frames saved "
        f"(t={['%.0f' % t for t in frame_ts]})")

    try:
        target_id = CLASS_NAMES.index(target_class)
    except ValueError:
        target_id = 0

    analyzer = XAIAnalyzer(classifier, ig_n_steps=ig_n_steps,
                           shap_n_samples=shap_n_samples, seed=seed, mesh=mesh)
    return run_comprehensive_xai_pipeline(
        trajectory=frames, timesteps=frame_ts, xai_analyzer=analyzer,
        classifier=classifier, target_class_id=target_id,
        target_class_name=target_class, save_results=True,
        save_figures=save_figures, results_dir=results_dir, n_bootstrap=n_bootstrap,
        n_permutations=n_permutations, with_gradcam=with_gradcam,
        with_sanity=with_sanity, coalitional_shap=coalitional_shap,
        coalitional_permutations=coalitional_permutations,
        viz_every_n=viz_every_n, log=log)


def main() -> int:
    """Env-var driven entry point (the subprocess protocol)."""
    import os

    target = os.environ.get("XAI_TARGET_CLASS", "MEL")
    seed = int(os.environ.get("XAI_GENERATION_SEED", "42"))
    steps = int(os.environ.get("XAI_INFERENCE_STEPS", "50"))
    save_every = int(os.environ.get("XAI_SAVE_EVERY_N", "5"))
    ddpm_path = os.environ.get("XAI_DDPM_MODEL_PATH") or None
    device = os.environ.get("XAI_DEVICE") or None
    # XAI_MESH_DEVICES=N: an N-device data mesh (-1 = every local card)
    n_mesh = int(os.environ.get("XAI_MESH_DEVICES", "0") or 0)
    mesh = data_mesh(n_mesh, device) if n_mesh else None
    # XAI_CONDITIONAL=1 analyzes the single class-conditional checkpoint;
    # XAI_GUIDANCE_SCALE>1 captures the CFG-guided trajectory
    conditional = os.environ.get("XAI_CONDITIONAL", "") in ("1", "true", "yes")
    guidance = float(os.environ.get("XAI_GUIDANCE_SCALE", "0") or 0.0)
    # XAI_COALITIONAL_SHAP=1 adds the axiom-faithful permutation-Shapley
    # Time-SHAP stage (φ-values + efficiency gap in analysis_results.json,
    # time_shap_coalitional.png artifact)
    coalitional = os.environ.get("XAI_COALITIONAL_SHAP", "") in ("1", "true",
                                                                 "yes")
    coal_perms = int(os.environ.get("XAI_COALITIONAL_PERMUTATIONS", "256"))
    # XAI_VIZ_EVERY_N>1: production figure throttle (numerics for every
    # frame; per-frame PNGs only every N-th frame + first/last)
    viz_every_n = int(os.environ.get("XAI_VIZ_EVERY_N", "1"))
    # XAI_CHECKPOINTS_DIR / XAI_RESULTS_DIR let callers that don't run from
    # the project root (the web UI subprocess path) place the run; the
    # results dir follows the browser layout xai_results/<class>/<run>
    ckpt_dir = os.environ.get("XAI_CHECKPOINTS_DIR") or None
    results_dir = None
    results_base = os.environ.get("XAI_RESULTS_DIR") or None
    if results_base:
        from datetime import datetime

        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        results_dir = str(Path(results_base) / target
                          / f"standalone_seed{seed}_{stamp}")
    results = run_standalone_xai(target_class=target, seed=seed,
                                 inference_steps=steps, save_every=save_every,
                                 checkpoints_dir=ckpt_dir,
                                 ddpm_model_path=ddpm_path, device=device, mesh=mesh,
                                 results_dir=results_dir,
                                 conditional=conditional,
                                 guidance_scale=guidance,
                                 coalitional_shap=coalitional,
                                 coalitional_permutations=coal_perms,
                                 viz_every_n=viz_every_n)
    return 0 if results is not None else 1


if __name__ == "__main__":
    sys.exit(main())
