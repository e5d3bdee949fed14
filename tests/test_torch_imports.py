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


# Public names of a JAX module that the port file of the same path does not
# define, and what the port has instead: another name ("file:name" in the
# port, which must exist) ...
RENAMED = {
    ("__init__.py", "ConfigManager"): "utils/config.py:ConfigManager",
    ("__init__.py", "default_config"): "utils/config.py:default_config",
    ("utils/__init__.py", "ConfigManager"): "utils/config.py:ConfigManager",
    ("utils/__init__.py", "default_config"): "utils/config.py:default_config",
    ("io/__init__.py", "torch_to_flax"): "io/convert.py:torch_to_flax",
    ("io/__init__.py", "flax_to_torch"): "io/convert.py:flax_to_torch",
    ("io/__init__.py", "load_pth"): "io/pth.py:load_checkpoint",
    ("io/__init__.py", "save_pth"): "io/pth.py:save_checkpoint",
    ("io/pth.py", "load_pth"): "io/pth.py:load_checkpoint",
    ("io/pth.py", "save_pth"): "io/pth.py:save_checkpoint",
    # Flax builds a module's layers and draws its weights in `setup` /
    # `init_*`; an nn.Module does both in its constructor
    ("models/__init__.py", "init_unet_params"): "models/unet2d.py:UNet2D.__init__",
    ("models/__init__.py", "create_reference_unet"): "models/unet2d.py:UNet2DConfig",
    ("models/unet2d.py", "init_unet_params"): "models/unet2d.py:UNet2D.__init__",
    ("models/unet2d.py", "create_reference_unet"): "models/unet2d.py:UNet2DConfig",
    ("models/unet2d.py", "UNet2D.setup"): "models/unet2d.py:UNet2D.__init__",
    ("models/unet2d.py", "DownBlock2D.setup"): "models/unet2d.py:DownBlock2D.__init__",
    ("models/unet2d.py", "UNetMidBlock2D.setup"): "models/unet2d.py:UNetMidBlock2D.__init__",
    ("models/unet2d.py", "UpBlock2D.setup"): "models/unet2d.py:UpBlock2D.__init__",
    ("models/resnet18.py", "init_resnet_params"): "models/resnet18.py:ResNet18.__init__",
    ("models/resnet18.py", "ResNet18.setup"): "models/resnet18.py:ResNet18.__init__",
    ("models/resnet18.py", "BasicBlock.setup"): "models/resnet18.py:BasicBlock.__init__",
    ("models/inception_v3.py", "init_inception_params"):
        "models/inception_v3.py:random_inception",
    ("models/inception_v3.py", "InceptionV3.setup"): "models/inception_v3.py:InceptionV3.__init__",
    ("train/__init__.py", "train_step"): "train/train_ddpm.py:make_train_step",
    ("train/train_ddpm.py", "train_step"): "train/train_ddpm.py:make_train_step",
    ("train/__init__.py", "MultiClassDataset"): "train/data.py:MultiClassDataset",
    ("train/__init__.py", "DistillConfig"): "train/distill.py:DistillConfig",
    ("train/__init__.py", "distill_phase"): "train/distill.py:distill_phase",
    ("train/__init__.py", "progressive_distill"): "train/distill.py:progressive_distill",
    ("train/__init__.py", "write_conditional_metadata"):
        "train/train_conditional.py:write_conditional_metadata",
    ("train/data.py", "CLASS_NAMES"): "utils/config.py:CLASS_NAMES",
    ("utils/compute.py", "TPU_PEAKS"): "utils/compute.py:GPU_PEAKS",
}
# ... or nothing, for the reason given
NO_COUNTERPART = {
    ("cache.py", "CacheManager.cache_converted"):
        "the Flax conversion cache: the port loads the .pth state dict as it is",
    ("cache.py", "CacheManager.get_converted"):
        "the Flax conversion cache: the port loads the .pth state dict as it is",
    ("cache.py", "CacheManager.converted_path"):
        "the Flax conversion cache: the port loads the .pth state dict as it is",
    ("diffusion/sampler.py", "DiffusionSampler.keys_for_seeds"):
        "threefry keys: each seed's noise comes from its own torch.Generator",
    ("train/distill.py", "make_distill_scan"):
        "a lax.scan of distillation steps: distill_phase steps in a Python loop",
    ("train/distill.py", "DistillState"):
        "the carry of that lax.scan: the loop keeps a TrainState",
    ("train/train_ddpm.py", "make_epoch_step"):
        "a lax.scan of train steps: train_class steps in a Python loop",
    ("train/train_ddpm.py", "default_fused_flags"):
        "the Pallas switch on a TPU: the port's kernel switches follow the device",
}


def _names(tree, reexports: bool) -> set:
    """The public names a module defines at its top level (functions,
    classes, assignments; with `reexports` its package-relative imports,
    as a package's `__init__` re-exports them) and its public classes'
    methods, as 'Class.method'."""
    def defined(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return [node.name]
        if isinstance(node, ast.Assign):
            return [n.id for t in node.targets for n in ast.walk(t) if isinstance(n, ast.Name)]
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            return [node.target.id]
        if reexports and isinstance(node, ast.ImportFrom) and node.level > 0:
            return [alias.asname or alias.name for alias in node.names]
        return []

    names = set()
    for node in tree.body:
        names.update(defined(node))
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{sub.name}" for sub in node.body
                         if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return {n for n in names if not n.startswith("_") and "._" not in n
            or n.endswith(".__init__")}


def _module_names(path: Path, reexports: bool) -> set:
    return _names(ast.parse(path.read_text(), str(path)), reexports)


def test_every_jax_public_name_has_a_port_counterpart():
    """Each public name of a JAX module (a top-level function, class or
    constant, a public class's method, a package's re-export) is defined by
    the port file of the same path, or has an entry here: its counterpart
    under another name, which must exist, or the reason there is none. A
    new JAX name without an entry, or an entry the port no longer needs,
    fails."""
    jax_root, port_root = ROOT / "synt_isic_tpu", ROOT / "synt_isic_tpu_torch"
    missing = set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        port = port_root / rel
        if not port.exists():
            continue
        mine = _module_names(port, reexports=True)
        theirs = _module_names(path, reexports=path.name == "__init__.py")
        # a method counts where the port has its class; a class the port
        # lacks is one name
        missing |= {(rel, n) for n in theirs - mine
                    if "." not in n or n.split(".")[0] in mine}
    assert not RENAMED.keys() & NO_COUNTERPART.keys()
    assert missing == RENAMED.keys() | NO_COUNTERPART.keys()
    for (rel, name), target in RENAMED.items():
        file, _, counterpart = target.partition(":")
        assert counterpart in _module_names(port_root / file, reexports=True), (rel, name,
                                                                                target)
    assert all(reason for reason in NO_COUNTERPART.values())
