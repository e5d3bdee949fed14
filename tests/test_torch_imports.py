"""The port and its chip script stand alone: no module of
`synt_isic_tpu_torch/`, nor `chip_smoke.py` or the GPU tests, imports JAX,
Flax, Optax or the JAX package."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "synt_isic_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "synt_isic_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_ported_module_is_checked():
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("ops/attention.py", "models/unet2d.py", "io/pth.py",
                   "train/__init__.py", "train/__main__.py", "train/async_ckpt.py",
                   "train/benchmark.py", "train/data.py", "train/procedural.py",
                   "train/train_ddpm.py", "train/train_conditional.py", "train/distill.py",
                   "train/train_classifier.py", "generator.py",
                   "cache.py", "utils/config.py", "model_manager.py", "cli.py",
                   "models/resnet18.py", "models/classifier.py", "native/__init__.py",
                   "serve.py", "app/__init__.py", "app/webui.py", "utils/profiling.py",
                   "app/download_models.py", "ops/resize.py", "models/inception_v3.py",
                   "app/gui.py", "app/qt_compat.py", "utils/compute.py", "io/convert.py",
                   "metrics/__init__.py", "metrics/fid.py",
                   *(f"scripts/{name}.py" for name in (
                       "__init__", "eval_fid", "fairness_audit", "parity_gauntlet", "e2e_loop",
                       "ladder_common", "score_checkpoint", "sampler_ladder", "augment_eval",
                       "distill_ladder", "train_family", "score_family",
                       "rescore_family_consistency", "e2e_conditional", "smoke_generate",
                       "convert_checkpoint", "convert_inception", "warm_cache")),
                   *(f"parallel/{name}.py" for name in (
                       "__init__", "mesh", "multihost", "replicas", "sharded_sampler",
                       "tensor_parallel")),
                   *(f"xai/{name}.py" for name in (
                       "__init__", "attribution", "cfi", "fairness", "gradcam", "integration",
                       "interventions", "pipeline", "regions", "sanity", "standalone", "stats",
                       "viz"))):
        assert f"synt_isic_tpu_torch/{module}" in names, module


def test_every_jax_module_has_a_port_file():
    """Each module of the JAX package has a file of the same path in the
    port, except the Pallas kernels, which the port has as CUDA sources
    (`csrc/attention_fwd.cu`, `csrc/attention_bwd.cu`)."""
    jax_files = {str(p.relative_to(ROOT / "synt_isic_tpu"))
                 for p in (ROOT / "synt_isic_tpu").rglob("*.py")}
    port_files = {str(p.relative_to(ROOT / "synt_isic_tpu_torch"))
                  for p in (ROOT / "synt_isic_tpu_torch").rglob("*.py")}
    assert jax_files - port_files == {"ops/pallas/__init__.py", "ops/pallas/attention.py"}
    assert {"csrc/attention_fwd.cu", "csrc/attention_bwd.cu"} <= {
        str(p.relative_to(ROOT / "synt_isic_tpu_torch"))
        for p in (ROOT / "synt_isic_tpu_torch" / "csrc").glob("*.cu")}
