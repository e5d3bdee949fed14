"""In-process XAI adapter: the generator's integrated analysis path.

The port of `synt_isic_tpu/xai/integration.py`. Parity with reference
`xai/xai_integration.py`:
  * `IntegratedXAIAnalyzer` (:75-132) — builds the same classifier +
    analyzer the standalone XAI path uses, maps class name -> id, derives
    the output dir `xai_results/<class>/<stem>_<seed>`, and runs the full
    pipeline on the READY trajectory (no second denoising);
  * the all-steps trajectory mosaic `trajectory_all_steps.png` (:117-122);
  * JSON-safe result conversion (:55-73, here `pipeline.json_safe`);
  * `create_integrated_xai_analyzer` (:137) and the GUI preview helper
    `run_xai_analysis` (:137-156).

Unlike the reference, importing this module has NO side effects — the
reference's `from .XAI import ...` executes model loading and a trajectory
generation at import time (`SURVEY.md §1`); here everything is lazy and
explicit.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from ..models.classifier import LesionClassifier
from ..utils.config import CLASS_NAMES, NUM_CLASSES
from .attribution import XAIAnalyzer, _stack_trajectory, check_mesh
from .pipeline import _strip_tensors, json_safe, run_comprehensive_xai_pipeline
from .viz import save_trajectory_grid


class IntegratedXAIAnalyzer:
    """Runs the comprehensive pipeline on trajectories captured by the
    generator (`ImageGenerator.set_xai_analyzer` protocol)."""

    def __init__(self, classifier: Optional[LesionClassifier] = None,
                 classifier_path: Optional[str] = None,
                 num_classes: int = NUM_CLASSES,
                 verbose: bool = True,
                 ig_n_steps: int = 50,
                 shap_n_samples: int = 512,
                 intervention_types=("blur",),
                 with_gradcam: bool = True,
                 with_sanity: bool = True,
                 save_figures: bool = True,
                 n_bootstrap: int = 1000,
                 n_permutations: int = 10000,
                 coalitional_shap: bool = False,
                 coalitional_permutations: int = 256,
                 viz_every_n: int = 1,
                 seed: int = 0,
                 device=None,
                 mesh=None,
                 mesh_axis: str = "data"):
        # mesh (reference `integration.py:52-73`): shard the frame-batched
        # attribution kernels over the device mesh
        self.mesh = check_mesh(mesh, mesh_axis)
        self.mesh_axis = mesh_axis
        if classifier is not None:
            self.classifier = classifier
        elif classifier_path and Path(classifier_path).exists():
            self.classifier, counts = LesionClassifier.from_checkpoint(
                classifier_path, num_classes=num_classes, device=device)
            if verbose:
                print(f"[xai] classifier loaded: {counts}")
        else:
            self.classifier = LesionClassifier.random_init(num_classes=num_classes,
                                                           device=device)
            if verbose:
                print("[xai] classifier: random init (no checkpoint found)")
        self.xai_analyzer = XAIAnalyzer(self.classifier, ig_n_steps=ig_n_steps,
                                        shap_n_samples=shap_n_samples,
                                        seed=seed, verbose=verbose,
                                        mesh=mesh, mesh_axis=mesh_axis)
        self.intervention_types = list(intervention_types)
        self.with_gradcam = with_gradcam
        self.with_sanity = with_sanity
        self.save_figures = save_figures
        self.n_bootstrap = n_bootstrap
        self.n_permutations = n_permutations
        self.coalitional_shap = coalitional_shap
        self.coalitional_permutations = coalitional_permutations
        # production throttle for the per-frame figure bound: render the
        # 3-PNGs-per-frame step figures (and per-frame Grad-CAM overlays)
        # only every N-th frame (first/last always); every frame's
        # numerical results stay in analysis_results.json regardless
        self.viz_every_n = max(1, int(viz_every_n))
        self.verbose = verbose

    def analyze_trajectory(self, trajectory, class_name: str,
                           seed: Optional[int], inference_steps: int,
                           filename: str, file_path: str,
                           timesteps: Optional[List[float]] = None
                           ) -> Optional[Dict[str, Any]]:
        frames = _stack_trajectory(trajectory).cpu().numpy()
        if frames.size == 0:
            return None
        if timesteps is None or len(timesteps) != len(frames):
            timesteps = list(range(len(frames)))
        try:
            target_class_id = CLASS_NAMES.index(class_name)
        except ValueError:
            target_class_id = 0

        out_dir = (Path(file_path).parent.parent / "xai_results" / class_name /
                   f"{Path(filename).stem}_{seed if seed is not None else 'n'}")
        out_dir.mkdir(parents=True, exist_ok=True)

        results = run_comprehensive_xai_pipeline(
            trajectory=frames, timesteps=timesteps,
            xai_analyzer=self.xai_analyzer, classifier=self.classifier,
            target_class_id=target_class_id, target_class_name=class_name,
            save_results=True, save_figures=self.save_figures,
            results_dir=out_dir,
            intervention_types=self.intervention_types,
            with_gradcam=self.with_gradcam, with_sanity=self.with_sanity,
            n_bootstrap=self.n_bootstrap, n_permutations=self.n_permutations,
            coalitional_shap=self.coalitional_shap,
            coalitional_permutations=self.coalitional_permutations,
            viz_every_n=self.viz_every_n,
            mesh=self.mesh, mesh_axis=self.mesh_axis,
            log=print if self.verbose else (lambda *_: None))

        traj_grid = out_dir / "trajectory_all_steps.png"
        save_trajectory_grid(list(frames), traj_grid, cols=10, pad=2)

        safe = json_safe(_strip_tensors(results))
        if isinstance(safe, dict):
            safe.setdefault("artifacts", {})["trajectory_all_steps"] = str(traj_grid)
        return safe


def create_integrated_xai_analyzer(classifier_path: Optional[str] = None,
                                   **kwargs) -> IntegratedXAIAnalyzer:
    return IntegratedXAIAnalyzer(classifier_path=classifier_path, **kwargs)


def run_xai_analysis(image_path: str) -> Tuple[Any, str]:
    """GUI preview: return an existing XAI artifact for this image if one
    exists, else the original image (reference `xai_integration.py:137-156`)."""
    from PIL import Image

    img_path = Path(image_path)
    class_name = img_path.parent.name
    bases = []
    if len(img_path.parents) >= 2:
        bases.append(img_path.parents[1] / "xai_results")  # where the adapter writes
    if len(img_path.parents) >= 3:
        bases.append(img_path.parents[2] / "xai_results")
    for base in bases:
        cand_dir = base / class_name
        if not cand_dir.exists():
            continue
        for pattern in (f"{img_path.stem}_*/xai_step_*.png",
                        f"{img_path.stem}_*/gradcam_most_important_*.png",
                        f"{img_path.stem}_*/time_shap_analysis.png"):
            matches = sorted(cand_dir.glob(pattern))
            if matches:
                return Image.open(matches[0]).convert("RGB"), str(matches[0])
    return Image.open(img_path).convert("RGB"), str(img_path)
