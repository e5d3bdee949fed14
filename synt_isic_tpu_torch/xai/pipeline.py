"""The comprehensive XAI pipeline over a denoising trajectory.

Orchestration parity with reference `run_comprehensive_xai_pipeline`
(`xai/XAI.py:2663-3297`) — same stages, same artifact names:
  1. per-frame IG + SHAP + combined attribution, top/bottom-k regions,
     3 PNGs per frame (`xai_step_t_<t>.png`, `..._IG.png`, `..._SHAP.png`);
  2. counterfactual interventions at the key frames
     [0, n/2, n-4, n-3, n-2, n-1] × {top_k, bottom_k} × intervention types,
     with per-intervention CFI (`interventions_t_<t>.png`);
  3. Time-SHAP (`time_shap_analysis.png`);
  Grad-CAM block: per-step CAMs (`gradcam_t_<t>.png`), most-important-step
     CAM, mean CAM (`gradcam_summary_all_timesteps.png`), overview collage
     (`gradcam_overview.png`);
  4/5. CFI collection + statistics battery (`statistical_analysis.png`);
  6. sanity checks;
  7. `analysis_results.json` (tensor-stripped) + `full_results.pkl`.

The port of `synt_isic_tpu/xai/pipeline.py`: the same stages, stage
timings (`metadata.stage_seconds`), files and result keys. The per-frame
Grad-CAM loop of the reference is one batched backward over all frames;
Time-SHAP is one batched forward; IG and SHAP run as chunked device
batches per frame (`attribution.py`). Arrays in the results are host numpy
(intervention images included), so `full_results.pkl` loads without a
card. `mesh=` (reference `pipeline.py:82-97, 332`) shards the frame-batched
kernels (IG, SHAP, Time-SHAP scoring, Grad-CAM) over the mesh through the
analyzer and `compute_gradcam`; without it the analyzer's own mesh is used.
"""
from __future__ import annotations

import json
import pickle
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.classifier import LesionClassifier
from ..ops.resize import resize_bilinear
from .attribution import XAIAnalyzer, _stack_trajectory
from .cfi import compute_causal_shift_comprehensive
from .gradcam import compute_gradcam, overlay_cam_on_image
from .interventions import counterfactual_intervention_advanced
from .regions import select_regions_advanced
from .sanity import sanity_check_comprehensive
from .stats import statistical_validation_comprehensive
from . import viz


def json_safe(obj: Any) -> Any:
    """Recursive conversion to JSON-serializable types (reference
    `xai_integration.py:55-73`)."""
    if isinstance(obj, dict):
        return {str(k): json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    if isinstance(obj, Path):
        return str(obj)
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().tolist()
    return obj


def _host(obj: Any) -> Any:
    """Tensors in `obj` (dicts and lists walked) as host numpy arrays."""
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def run_comprehensive_xai_pipeline(trajectory, timesteps: Sequence[float],
                                   xai_analyzer: XAIAnalyzer,
                                   classifier: LesionClassifier,
                                   target_class_id: int,
                                   target_class_name: str,
                                   save_results: bool = True,
                                   save_figures: bool = True,
                                   results_dir: Optional[str] = None,
                                   intervention_types: Sequence[str] = ("blur",),
                                   top_k_percent: float = 10,
                                   bottom_k_percent: float = 10,
                                   alpha_level: float = 0.1,
                                   n_bootstrap: int = 1000,
                                   n_permutations: int = 10000,
                                   with_gradcam: bool = True,
                                   with_sanity: bool = True,
                                   coalitional_shap: bool = False,
                                   coalitional_permutations: int = 256,
                                   viz_every_n: int = 1,
                                   mesh=None,
                                   mesh_axis: str = "data",
                                   progress_cb=None,
                                   log=print) -> Dict[str, Any]:
    if mesh is not None:
        xai_analyzer.set_mesh(mesh, mesh_axis)
    else:
        mesh, mesh_axis = xai_analyzer.mesh, xai_analyzer.mesh_axis
    frames = classifier.as_input(_stack_trajectory(trajectory))   # (S, H, W, C)
    frames_host = frames.cpu().numpy()
    timesteps = [float(t) for t in timesteps]
    n_frames = frames.shape[0]

    if save_results and results_dir is None:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        results_dir = Path("xai_results") / f"xai_analysis_{target_class_name}_{stamp}"
    if save_results:
        results_dir = Path(results_dir)
        results_dir.mkdir(parents=True, exist_ok=True)

    results: Dict[str, Any] = {
        "metadata": {
            "target_class_id": int(target_class_id),
            "target_class_name": target_class_name,
            "n_timesteps": n_frames,
            "timesteps": timesteps,
            "analysis_timestamp": datetime.now().isoformat(),
            "parameters": {
                "top_k_percent": top_k_percent,
                "bottom_k_percent": bottom_k_percent,
                "ig_n_steps": xai_analyzer.ig_n_steps,
                "shap_n_samples": xai_analyzer.shap_n_samples,
                "intervention_types": list(intervention_types),
                "alpha_level": alpha_level,
                "coalitional_shap": bool(coalitional_shap),
                "coalitional_permutations": (int(coalitional_permutations)
                                             if coalitional_shap else None),
                "viz_every_n": int(viz_every_n),
            },
        },
        "xai_maps": {},
        "region_analysis": {},
        "interventions": {},
        "cfi_analysis": {},
        "time_shap": {},
        "statistical_validation": {},
        "sanity_checks": {},
        "visualizations": [],
    }

    # per-stage wall times — recorded into analysis_results.json so the
    # pipeline's cost structure is observable in every run
    stage_seconds: Dict[str, float] = {}
    _t0 = time.time()

    def _mark(name: str) -> None:
        nonlocal _t0
        stage_seconds[name] = round(time.time() - _t0, 3)
        _t0 = time.time()

    # === stage 1: per-frame attribution maps + regions ===========================
    # IG and SHAP for all frames as chunked device batches (the reference
    # loops 50 Captum passes + 512 masked forwards per frame on host), each
    # stack copied to the host once (which waits for the device, so the
    # stage time is the kernels'): the loop below is numpy
    log(f"[xai] stage 1: attribution maps for {n_frames} frames (batched)")
    region_data: Dict[str, Dict[str, Any]] = {}
    ig_all = xai_analyzer.compute_ig_frames(frames, target_class_id).cpu().numpy()
    shap_all = xai_analyzer.compute_shap_frames(frames, target_class_id).cpu().numpy()
    _mark("stage1_attribution_kernels")
    fig_s = 0.0
    for i in range(n_frames):
        frame = frames_host[i][None]
        t = timesteps[i]
        step_key = f"t_{t:.0f}"
        try:
            ig_attr = ig_all[i][None]
            shap_attr = shap_all[i][None]
            combined = 0.5 * ig_attr + 0.5 * shap_attr
            method_details = {
                "ig": {"weight": 0.5,
                       "mean_attribution": float(np.mean(np.abs(ig_attr))),
                       "max_attribution": float(np.max(np.abs(ig_attr)))},
                "shap": {"weight": 0.5,
                         "mean_attribution": float(np.mean(np.abs(shap_attr))),
                         "max_attribution": float(np.max(np.abs(shap_attr)))},
            }
            top_k = select_regions_advanced(np.asarray(combined),
                                            k_percent=top_k_percent, region_type="top")
            bottom_k = select_regions_advanced(np.asarray(combined),
                                               k_percent=bottom_k_percent,
                                               region_type="bottom")
            results["xai_maps"][step_key] = {
                "timestep": t,
                "attribution_map": np.asarray(combined),
                "method_details": method_details,
                "image_shape": tuple(frame.shape),
            }
            region_data[step_key] = {"top_k": top_k, "bottom_k": bottom_k}
            # viz_every_n > 1: production throttle for the 3-PNGs-per-frame
            # bound (the first and last frames always render; analysis
            # results stay complete for EVERY frame — only figures thin out,
            # mirroring the reference's SAVE_EVERY_N_STEPS capture cadence,
            # `xai/XAI.py:750-754`)
            want_figs = (i % max(1, int(viz_every_n)) == 0
                         or i == n_frames - 1)
            if save_results and save_figures and want_figs:
                _tf = time.time()
                for suffix, attr in (("", combined), ("_IG", ig_attr), ("_SHAP", shap_attr)):
                    p = results_dir / f"xai_step_{step_key}{suffix}.png"
                    title = target_class_name + {"": "", "_IG": " (IG)",
                                                 "_SHAP": " (SHAP)"}[suffix]
                    viz.visualize_xai_step_comprehensive(
                        frame, attr, top_k["mask"], bottom_k["mask"], t, title,
                        save_path=str(p))
                    results["visualizations"].append(str(p))
                fig_s += time.time() - _tf
        except Exception as exc:
            log(f"[xai] frame {i} (t={t}) failed: {exc}")
            continue
        if progress_cb:
            progress_cb("xai_maps", i + 1, n_frames)
    results["region_analysis"] = region_data
    _mark("stage1_regions_and_figures")
    stage_seconds["stage1_figures_only"] = round(fig_s, 3)

    # === stage 2: interventions + CFI at key frames ==================================
    log("[xai] stage 2: counterfactual interventions")
    key_steps = [0, n_frames // 2, n_frames - 4, n_frames - 3, n_frames - 2,
                 n_frames - 1]
    interventions_data: Dict[str, Any] = {}
    cfi_data: Dict[str, Any] = {}
    for step_idx in key_steps:
        if not 0 <= step_idx < n_frames:
            continue
        t = timesteps[step_idx]
        step_key = f"t_{t:.0f}"
        if step_key not in region_data or step_key in interventions_data:
            continue
        frame = frames[step_idx][None]
        step_interventions: Dict[str, Any] = {}
        step_cfi: Dict[str, Any] = {}
        for region_type in ("top_k", "bottom_k"):
            mask = region_data[step_key][region_type]["mask"]
            step_interventions[region_type] = {}
            for itype in intervention_types:
                try:
                    ires = counterfactual_intervention_advanced(
                        frame, mask, itype, generator=xai_analyzer._next_generator())
                    cres = compute_causal_shift_comprehensive(
                        classifier, frame, ires["modified_image"], target_class_id,
                        include_all_classes=True)
                    step_interventions[region_type][itype] = _host(ires)
                    step_cfi[f"{region_type}_{itype}"] = cres
                except Exception as exc:
                    log(f"[xai] intervention {region_type}/{itype} failed: {exc}")
        interventions_data[step_key] = step_interventions
        cfi_data[step_key] = step_cfi
        if save_results and save_figures:
            p = results_dir / f"interventions_{step_key}.png"
            viz.visualize_intervention_comprehensive(
                frames_host[step_idx][None], {r: region_data[step_key][r]["mask"] for r in
                        ("top_k", "bottom_k")},
                step_interventions, step_cfi, t, save_path=str(p))
            results["visualizations"].append(str(p))
    results["interventions"] = interventions_data
    results["cfi_analysis"] = cfi_data
    _mark("stage2_interventions")

    # === stage 3: Time-SHAP ============================================================
    log("[xai] stage 3: Time-SHAP")
    try:
        importance, raw = xai_analyzer.compute_time_shap(frames, timesteps,
                                                         target_class_id)
        results["time_shap"] = {
            "importance": importance,
            "raw_data": raw,
            "most_important_timestep": timesteps[int(np.argmax(importance))],
            "most_important_index": int(np.argmax(importance)),
        }
        if save_results and save_figures:
            p = results_dir / "time_shap_analysis.png"
            viz.plot_time_shap_comprehensive(timesteps, importance, raw,
                                             target_class_name, save_path=str(p))
            results["visualizations"].append(str(p))
    except Exception as exc:
        log(f"[xai] Time-SHAP failed: {exc}")
        results["time_shap"] = {"error": str(exc)}
    if coalitional_shap:
        # opt-in axiom-faithful stage: permutation-sampled Shapley values
        # over timesteps, the README-described formulation (reference
        # `README.md:198-207`) the min-max proxy above approximates. Costs
        # no extra classifier pass when the main Time-SHAP stage succeeded:
        # its per-frame confidence scores are the coalition values; only on
        # a stage-3 failure are frames re-scored.
        try:
            prior = results.get("time_shap", {}).get("raw_data") or {}
            coal = xai_analyzer.compute_time_shap_coalitional(
                frames, timesteps, target_class_id,
                n_permutations=int(coalitional_permutations),
                frame_scores=prior.get("confidence_scores"))
            results["time_shap"]["coalitional"] = {
                "shapley_values": coal["shapley_values"],
                "efficiency_gap": coal["efficiency_gap"],
                "frame_scores": coal["frame_scores"],
                "n_permutations": coal["n_permutations"],
                "most_important_index": int(np.argmax(
                    np.abs(np.asarray(coal["shapley_values"])))),
            }
            if save_results and save_figures:
                p = results_dir / "time_shap_coalitional.png"
                viz.plot_time_shap_coalitional(
                    timesteps, coal["shapley_values"], coal["frame_scores"],
                    coal["efficiency_gap"], target_class_name,
                    save_path=str(p))
                results["visualizations"].append(str(p))
        except Exception as exc:
            log(f"[xai] coalitional Time-SHAP failed: {exc}")
            results["time_shap"]["coalitional"] = {"error": str(exc)}
    _mark("stage3_time_shap")

    # === Grad-CAM block =================================================================
    if with_gradcam:
        log("[xai] Grad-CAM block (batched over all frames)")
        try:
            cams = compute_gradcam(classifier, frames, target_class_id,
                                   mesh=mesh, mesh_axis=mesh_axis)  # (S,224,224)
            gradcam_results: Dict[str, np.ndarray] = {}
            rgb224_all = None
            if save_results and save_figures:
                # all frames resized in one batched call, as the
                # classifier's preprocessing resizes them
                rgb_all = np.stack([viz.tensor_to_displayable_image(frames_host[i])
                                    for i in range(n_frames)])
                rgb224_all = resize_bilinear(
                    torch.from_numpy(rgb_all).permute(0, 3, 1, 2),
                    (224, 224)).permute(0, 2, 3, 1).numpy()
            for i in range(n_frames):
                step_key = f"t_{timesteps[i]:.0f}"
                gradcam_results[step_key] = cams[i]
                if rgb224_all is not None and (
                        i % max(1, int(viz_every_n)) == 0
                        or i == n_frames - 1):
                    from PIL import Image
                    p = results_dir / f"gradcam_{step_key}.png"
                    Image.fromarray(overlay_cam_on_image(rgb224_all[i],
                                                         cams[i])).save(p)
                    results["visualizations"].append(str(p))
            results["gradcam"] = gradcam_results

            if "most_important_index" in results.get("time_shap", {}):
                imp_idx = results["time_shap"]["most_important_index"]
                imp_t = timesteps[imp_idx]
                results["gradcam_most_important"] = {
                    "timestep": float(imp_t),
                    "index": int(imp_idx),
                    "gradcam": cams[imp_idx],
                }
                if rgb224_all is not None:
                    from PIL import Image
                    p = results_dir / f"gradcam_most_important_t{imp_t:.0f}.png"
                    Image.fromarray(overlay_cam_on_image(
                        rgb224_all[imp_idx], cams[imp_idx])).save(p)
                    results["visualizations"].append(str(p))

            mean_cam = cams.mean(axis=0)
            mean_cam = (mean_cam - mean_cam.min()) / (mean_cam.max() - mean_cam.min() + 1e-8)
            results["gradcam_summary"] = mean_cam
            if rgb224_all is not None:
                from PIL import Image
                plt = viz._pyplot()
                final224 = rgb224_all[-1]
                p = results_dir / "gradcam_summary_all_timesteps.png"
                Image.fromarray(overlay_cam_on_image(final224, mean_cam)).save(p)
                results["visualizations"].append(str(p))
                # overview collage: original | most-important CAM | mean CAM
                fig, axes = plt.subplots(1, 3, figsize=(16, 5))
                axes[0].imshow(final224)
                axes[0].set_title("Original")
                if "gradcam_most_important" in results:
                    gmi = results["gradcam_most_important"]
                    axes[1].imshow(overlay_cam_on_image(final224, gmi["gradcam"]))
                    axes[1].set_title(f"Most important Grad-CAM (t={gmi['timestep']:.0f})")
                axes[2].imshow(overlay_cam_on_image(final224, mean_cam))
                axes[2].set_title("Summed Grad-CAM")
                for ax in axes:
                    ax.axis("off")
                fig.tight_layout()
                fig.savefig(results_dir / "gradcam_overview.png")
                plt.close(fig)
                results["visualizations"].append(str(results_dir / "gradcam_overview.png"))
        except Exception as exc:
            log(f"[xai] Grad-CAM failed: {exc}")
            results["gradcam"] = {"error": str(exc)}
        _mark("gradcam_block")

    # === stage 4/5: CFI collection + statistics ==========================================
    log("[xai] stage 4/5: statistics")
    top_shifts: List[float] = []
    bottom_shifts: List[float] = []
    for step_cfi in cfi_data.values():
        for ikey, cres in step_cfi.items():
            shift = cres["target_class_analysis"]["cfi"]
            (top_shifts if "top_k" in ikey else bottom_shifts).append(shift)
    if top_shifts and bottom_shifts:
        try:
            stats_results = statistical_validation_comprehensive(
                top_shifts, bottom_shifts, alpha=alpha_level,
                n_bootstrap=n_bootstrap, n_permutations=n_permutations)
            results["statistical_validation"] = stats_results
            if save_results and save_figures:
                p = results_dir / "statistical_analysis.png"
                viz.plot_statistical_analysis_modern(stats_results, target_class_name,
                                                     top_shifts, bottom_shifts,
                                                     save_path=str(p))
                results["visualizations"].append(str(p))
        except Exception as exc:
            log(f"[xai] statistics failed: {exc}")
            results["statistical_validation"] = {"error": str(exc)}
    else:
        results["statistical_validation"] = {"error": "Insufficient data"}
    _mark("stage45_statistics")

    # === stage 6: sanity checks ===========================================================
    if with_sanity:
        log("[xai] stage 6: sanity checks")
        try:
            results["sanity_checks"] = sanity_check_comprehensive(
                classifier, frames[-1][None], target_class_id, xai_analyzer)
        except Exception as exc:
            results["sanity_checks"] = {"error": str(exc)}
        _mark("stage6_sanity")

    # === stage 7: persistence ==============================================================
    if save_results:
        log("[xai] stage 7: saving artifacts")
        results["metadata"]["stage_seconds"] = stage_seconds
        json_results = _strip_tensors(results)
        with open(results_dir / "analysis_results.json", "w", encoding="utf-8") as f:
            json.dump(json_safe(json_results), f, indent=2, ensure_ascii=False,
                      default=str)
        with open(results_dir / "full_results.pkl", "wb") as f:
            pickle.dump(results, f)
        viz.save_trajectory_grid(list(frames_host),
                                 results_dir / "trajectory_all_steps.png")
        results["visualizations"].append(str(results_dir / "trajectory_all_steps.png"))
        # stage_seconds is shared by reference with the metadata already
        # serialized above; stage 7's own cost is visible in the returned
        # results (and the next run's JSON)
        _mark("stage7_persistence")
    else:
        results["metadata"]["stage_seconds"] = stage_seconds

    return results


def _strip_tensors(results: Dict[str, Any]) -> Dict[str, Any]:
    """Remove large arrays before JSON export (reference `XAI.py:3248-3266`)."""
    out = {k: v for k, v in results.items()}
    out["xai_maps"] = {
        k: {kk: vv for kk, vv in v.items() if kk != "attribution_map"}
        for k, v in results.get("xai_maps", {}).items()
    }
    out["region_analysis"] = {
        k: {r: {kk: vv for kk, vv in data.items() if kk != "mask"}
            for r, data in v.items()}
        for k, v in results.get("region_analysis", {}).items()
    }
    out["interventions"] = {
        step: {region: {itype: {kk: vv for kk, vv in ires.items()
                                if kk not in ("modified_image", "intervention",
                                              "mask_tensor", "difference")}
                        for itype, ires in per_region.items()}
               for region, per_region in per_step.items()}
        for step, per_step in results.get("interventions", {}).items()
    }
    for key in ("gradcam", "gradcam_summary", "gradcam_most_important"):
        out.pop(key, None)
    return out
