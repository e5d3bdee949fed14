"""The XAI engine: attribution over denoising trajectories, on a device.

The port of `synt_isic_tpu/xai/`: IG, patch-SHAP, Time-SHAP (proxy and
coalitional), Grad-CAM, counterfactual interventions, CFI, the statistics
battery, sanity checks, the fairness audit, figures, the comprehensive
pipeline, the generator's integrated analysis and the standalone run.
"""
from .attribution import XAIAnalyzer
from .regions import select_regions_advanced
from .interventions import counterfactual_intervention_advanced, INTERVENTION_TYPES
from .cfi import compute_causal_shift_comprehensive
from .stats import statistical_validation_comprehensive
from .sanity import sanity_check_comprehensive
from .gradcam import compute_gradcam, overlay_cam_on_image
from .pipeline import run_comprehensive_xai_pipeline, json_safe

# Familiar names for users migrating from the reference
# (`xai/XAI.py:ModernXAIAnalyzer`, re-exported at `xai/__init__.py:1-2`).
ModernXAIAnalyzer = XAIAnalyzer

from .integration import (IntegratedXAIAnalyzer, create_integrated_xai_analyzer,  # noqa: E402
                          run_xai_analysis)
from .fairness import FairnessAuditor  # noqa: E402

__all__ = [
    "XAIAnalyzer",
    "ModernXAIAnalyzer",
    "select_regions_advanced",
    "counterfactual_intervention_advanced",
    "INTERVENTION_TYPES",
    "compute_causal_shift_comprehensive",
    "statistical_validation_comprehensive",
    "sanity_check_comprehensive",
    "compute_gradcam",
    "overlay_cam_on_image",
    "run_comprehensive_xai_pipeline",
    "json_safe",
    "IntegratedXAIAnalyzer",
    "create_integrated_xai_analyzer",
    "run_xai_analysis",
    "FairnessAuditor",
]
