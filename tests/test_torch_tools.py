"""The port's tool scripts and compute helpers at tiny sizes on the CPU,
against the JAX package's where both run here:

  * `io/convert.torch_to_flax` / `flax_to_torch` equal to the JAX module's
    on a tiny conditional UNet state dict that carries legacy attention
    names, a `module.` prefix and BatchNorm statistics;
  * `scripts/convert_checkpoint`: `to-npz` key for key and array for array
    the JAX script's, `to-pth` back exactly, `inspect` the same lines;
  * `scripts/convert_inception` with a stub torchvision that returns the
    port's seeded `random_inception` (neither machine has torchvision):
    writes and validates, exits 1 without torchvision (the JAX script's
    message) and on a state dict with a wrong key;
  * `scripts/smoke_generate`: its files, `--epoch`, seeds `arange(n) +
    seed * 1000`, and exit 1 on an empty folder;
  * `scripts/warm_cache --device cpu --dtype f32` at the tiny config;
  * `utils/compute.enable_compilation_cache` moves `ops/native.library_path`,
    in this process and in one it starts, and raises once a kernel is loaded; `GPU_PEAKS` holds the figures of
    every kernel bound in PERF.md;
  * the scripts default to CUDA and raise without it.
"""
import ctypes
import io
import os
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from synt_isic_tpu.io import convert as jax_convert
from synt_isic_tpu_torch.io import convert
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.io.pth import load_checkpoint, save_checkpoint
from synt_isic_tpu_torch.models.inception_v3 import InceptionV3, random_inception
from synt_isic_tpu_torch.ops import native
from synt_isic_tpu_torch.scripts import (convert_checkpoint, convert_inception, smoke_generate,
                                         warm_cache)
from synt_isic_tpu_torch.utils import compute

from tests.torch_port_fixtures import (TINY, TINY_COND_JAX, TINY_JAX, jax_params,  # noqa: F401
                                       one_thread)

ROOT = Path(__file__).resolve().parents[1]
_LEGACY = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.", ".to_out.0.": ".proj_attn."}


def _jax_script(name: str):
    """The JAX package's `scripts/<name>.py` as a module (the folder is not
    a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_script(name: str, argv) -> tuple:
    """rc and stdout of the JAX script's `main()` with `argv`."""
    module = _jax_script(name)
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [f"{name}.py", *argv]
    try:
        with redirect_stdout(out):
            rc = module.main()
    finally:
        sys.argv = saved
    return rc, out.getvalue()


def _run_port_script(main, argv) -> tuple:
    """rc and stdout of a port script's `main(argv)`."""
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _legacy_state():
    """The tiny conditional UNet's state dict with the legacy diffusers
    attention names, one `module.`-prefixed key and a BatchNorm's entries."""
    state = {}
    for key, value in state_dict_from_jax(jax_params(TINY_COND_JAX, 4)).items():
        for new, old in _LEGACY.items():
            key = key.replace(new, old)
        state[key] = value
    assert any(".query." in k for k in state) and any(".proj_attn." in k for k in state)
    first = next(iter(state))
    state[f"module.{first}"] = state.pop(first)
    rng = np.random.default_rng(0)
    state["norm.running_mean"] = torch.from_numpy(rng.normal(size=4).astype(np.float32))
    state["norm.running_var"] = torch.from_numpy(rng.uniform(0.5, 1.5, 4).astype(np.float32))
    state["norm.num_batches_tracked"] = torch.tensor(3)
    return state


def _equal_trees(a, b) -> None:
    assert set(a) == set(b)
    for key, value in a.items():
        if isinstance(value, dict):
            _equal_trees(value, b[key])
        else:
            assert value.dtype == b[key].dtype and np.array_equal(value, b[key]), key


def test_torch_to_flax_and_back_equal_the_jax_module():
    state = _legacy_state()
    numpy_state = {k: v.numpy() for k, v in state.items()}
    tree = convert.torch_to_flax(state)
    want = jax_convert.torch_to_flax(numpy_state)
    _equal_trees(tree, want)
    assert "embedding" in tree["class_embedding"] and "mean" in tree["norm"]
    back, jax_back = convert.flax_to_torch(tree), jax_convert.flax_to_torch(want)
    assert list(back) == list(jax_back)
    assert all(np.array_equal(back[k], jax_back[k]) for k in back)
    # the round trip gives the modern names, the prefix dropped
    assert not any(".query." in k or k.startswith("module.") for k in back)
    assert "norm.num_batches_tracked" not in back
    assert convert.unflatten_tree(convert.flatten_tree(tree)).keys() == tree.keys()


@pytest.fixture(scope="module")
def tiny_pth(tmp_path_factory):
    base = tmp_path_factory.mktemp("convert")
    plain = base / "unet_MEL_best.pth"
    save_checkpoint(state_dict_from_jax(jax_params(TINY_JAX, 0)), str(plain))
    legacy = base / "legacy.pth"
    torch.save(_legacy_state(), legacy)
    return base, plain, legacy


def test_convert_checkpoint_to_npz_equals_the_jax_script(tiny_pth):
    base, _, legacy = tiny_pth
    rc, _ = _run_jax_script("convert_checkpoint", ["to-npz", str(legacy), str(base / "jax.npz")])
    assert rc == 0
    rc, out = _run_port_script(convert_checkpoint.main,
                               ["to-npz", str(legacy), str(base / "port.npz")])
    assert rc == 0 and f"wrote {base / 'port.npz'}" in out
    with np.load(base / "jax.npz") as want, np.load(base / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        assert "class_embedding/embedding" in got.files
        for key in want.files:
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key


def test_convert_checkpoint_round_trip_is_exact(tiny_pth):
    base, plain, _ = tiny_pth
    assert _run_port_script(convert_checkpoint.main, ["to-npz", str(plain)])[0] == 0
    npz = plain.with_suffix(".npz")
    assert npz.exists()
    back = base / "back.pth"
    assert _run_port_script(convert_checkpoint.main, ["to-pth", str(npz), str(back)])[0] == 0
    want, got = load_checkpoint(str(plain)), load_checkpoint(str(back))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the JAX package reads the port's .npz as its own
    rc, _ = _run_jax_script("convert_checkpoint", ["to-pth", str(npz), str(base / "jax_back.pth")])
    assert rc == 0
    jax_back = load_checkpoint(str(base / "jax_back.pth"))
    assert all(torch.equal(jax_back[k], want[k]) for k in want)


def test_convert_checkpoint_inspect_prints_the_jax_lines(tiny_pth):
    _, plain, legacy = tiny_pth
    for path in (legacy, plain):
        rc, want = _run_jax_script("convert_checkpoint", ["inspect", str(path)])
        got_rc, got = _run_port_script(convert_checkpoint.main, ["inspect", str(path)])
        assert (got_rc, got) == (rc, want)
    state = load_checkpoint(str(plain))
    n = sum(v.numel() for v in state.values())
    assert got.splitlines()[-1] == f"{len(state)} tensors, {n / 1e6:.2f} M parameters"


def _stub_torchvision(model_factory):
    stub = types.ModuleType("torchvision")
    stub.models = types.SimpleNamespace(
        inception_v3=lambda weights=None: model_factory(),
        Inception_V3_Weights=types.SimpleNamespace(IMAGENET1K_V1="IMAGENET1K_V1"))
    return stub


def test_convert_inception_writes_and_validates(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", _stub_torchvision(lambda: random_inception(3)))
    out = tmp_path / "ckpt" / "inception_v3.pth"
    rc, text = _run_port_script(convert_inception.main, ["--out", str(out)])
    assert rc == 0 and "manifest validation: ok" in text
    state = load_checkpoint(str(out))
    want = random_inception(3).state_dict()
    assert all(torch.equal(state[k], want[k]) for k in want)


def test_convert_inception_exits_1_on_a_wrong_state_dict(tmp_path, monkeypatch):
    class Renamed(InceptionV3):
        def state_dict(self, *args, **kwargs):
            state = dict(random_inception(0).state_dict())
            state["Mixed_5b.branch_pool.conv.weights"] = state.pop(
                "Mixed_5b.branch_pool.conv.weight")
            return state

    monkeypatch.setitem(sys.modules, "torchvision", _stub_torchvision(Renamed))
    rc, text = _run_port_script(convert_inception.main,
                                ["--out", str(tmp_path / "inception_v3.pth")])
    assert rc == 1 and "manifest validation FAILED" in text
    assert "Mixed_5b.branch_pool.conv.weight" in text


def test_convert_inception_without_torchvision(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torchvision", None)     # import raises ImportError
    out = str(tmp_path / "inception_v3.pth")
    rc, text = _run_port_script(convert_inception.main, ["--out", out])
    want_rc, want = _run_jax_script("convert_inception", ["--out", out])
    assert (rc, text) == (want_rc, want) and rc == 1
    assert text.startswith("needs torch + torchvision")
    assert not Path(out).exists()


@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("smoke") / "checkpoints"
    ckpt.mkdir()
    save_checkpoint(state_dict_from_jax(jax_params(TINY_JAX, 0)), str(ckpt / "unet_MEL_best.pth"))
    save_checkpoint(state_dict_from_jax(jax_params(TINY_JAX, 1)), str(ckpt / "unet_NV_best.pth"))
    save_checkpoint(state_dict_from_jax(jax_params(TINY_JAX, 2)), str(ckpt / "unet_MEL_epoch3.pth"))
    return ckpt


def _smoke(ckpt, out, *extra):
    return _run_port_script(lambda argv: smoke_generate.main(argv, model_config=TINY),
                            ["--checkpoints", str(ckpt), "--output", str(out), "--samples", "2",
                             "--steps", "2", "--device", "cpu", *extra])


def test_smoke_generate_writes_per_class_samples(smoke_ckpt, tmp_path, monkeypatch):
    from synt_isic_tpu_torch.diffusion import sampler as sampler_module

    seen = []
    original = sampler_module.DiffusionSampler.sample

    def spy(self, model, seeds, *args, **kwargs):
        seen.append(np.asarray(seeds).tolist())
        return original(self, model, seeds, *args, **kwargs)

    monkeypatch.setattr(sampler_module.DiffusionSampler, "sample", spy)
    rc, out = _smoke(smoke_ckpt, tmp_path / "out", "--seed", "3")
    assert rc == 0 and "classes: ['MEL', 'NV']" in out
    names = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert names == ["MEL_sample0.png", "MEL_sample1.png", "NV_sample0.png", "NV_sample1.png"]
    assert seen == [[3000, 3001], [3000, 3001]]
    from PIL import Image
    assert np.asarray(Image.open(tmp_path / "out" / "NV_sample1.png")).shape == (
        TINY.sample_size, TINY.sample_size, 3)


def test_smoke_generate_epoch_checkpoint(smoke_ckpt, tmp_path):
    """--epoch 3 loads MEL's epoch snapshot (other pixels than its best) and
    falls back to NV's best, which has no such snapshot."""
    assert _smoke(smoke_ckpt, tmp_path / "best")[0] == 0
    assert _smoke(smoke_ckpt, tmp_path / "epoch", "--epoch", "3")[0] == 0
    def same(name):
        return (tmp_path / "epoch" / name).read_bytes() == (tmp_path / "best" / name).read_bytes()

    assert not same("MEL_sample0.png") and same("NV_sample0.png")


def test_smoke_generate_exits_1_on_an_empty_folder(tmp_path):
    (tmp_path / "empty").mkdir()
    rc, out = _smoke(tmp_path / "empty", tmp_path / "out")
    assert rc == 1 and out.startswith("no checkpoints found in")


def test_warm_cache_on_the_cpu(monkeypatch):
    """Every config walks twice (cold and warm) through the generator's
    block path, then the classifier at each batch; on the CPU nothing is
    built."""
    from synt_isic_tpu_torch.generator import ImageGenerator

    walks = []
    original = ImageGenerator._sample_batch

    def spy(self, class_name, seeds, capture_trajectory):
        walks.append((class_name, self.scheduler_kind, self.inference_steps, len(seeds),
                      self.model_manager.dtype, capture_trajectory))
        return original(self, class_name, seeds, capture_trajectory)

    monkeypatch.setattr(ImageGenerator, "_sample_batch", spy)
    monkeypatch.setattr(native, "build", lambda names: pytest.fail("built on the CPU"))
    rc, out = _run_port_script(lambda argv: warm_cache.main(argv, model_config=TINY),
                               ["--configs", "ddim:2:3", "dpm_solver:2:2",
                                "--classifier-batches", "1", "--dtype", "f32", "--device", "cpu"])
    assert rc == 0
    assert walks == [("NV", "ddim", 2, 3, torch.float32, False)] * 2 + \
        [("NV", "dpm_solver", 2, 2, torch.float32, False)] * 2
    for label in ("ddim:2:3: cold", "dpm_solver:2:2: cold", "classifier b1: cold"):
        assert label in out
    assert out.rstrip().endswith("every walk ran (the CPU runs no kernel)")


def _no_cache_dir(monkeypatch):
    """Unset `$SYNT_ISIC_CACHE_DIR` for the test and restore it afterwards,
    also where the code under test sets it."""
    monkeypatch.setenv("SYNT_ISIC_CACHE_DIR", "")
    monkeypatch.delenv("SYNT_ISIC_CACHE_DIR")


def test_enable_compilation_cache_moves_the_builds(tmp_path, monkeypatch):
    _no_cache_dir(monkeypatch)
    default = native.library_path("attention_fwd")
    assert compute.enable_compilation_cache() == native.DEFAULT_BUILD_DIR == default.parent
    assert native.library_path("attention_fwd") == default

    monkeypatch.setenv("SYNT_ISIC_CACHE_DIR", str(tmp_path / "env"))
    assert compute.enable_compilation_cache() == tmp_path / "env"
    assert native.library_path("attention_fwd") == tmp_path / "env" / default.name
    there = compute.enable_compilation_cache(str(tmp_path / "arg" / "nested"))
    assert there == tmp_path / "arg" / "nested"
    assert native.library_path("attention_fwd").parent == there
    assert native.build([]) == {} and there.is_dir()


def test_a_fresh_process_loads_from_the_chosen_directory(tmp_path, monkeypatch):
    """`enable_compilation_cache(dir)` reaches the processes started after
    it: a child that loads a kernel builds nothing and loads it from `dir`."""
    _no_cache_dir(monkeypatch)
    chosen = compute.enable_compilation_cache(str(tmp_path / "kernels"))
    built = native.library_path("attention_fwd")
    assert built.parent == chosen
    chosen.mkdir()
    built.touch()                           # as warm_cache leaves it
    child = ("import ctypes\n"
             "from synt_isic_tpu_torch.ops import native\n"
             "native._nvcc = lambda: exec('raise SystemExit(\"nvcc ran\")')\n"
             "ctypes.CDLL = lambda path: print(path)\n"
             "native.load('attention_fwd')\n")
    repo = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", child], cwd=repo, capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(repo)))
    assert run.returncode == 0, run.stderr
    assert run.stdout.strip() == str(built)


def test_enable_compilation_cache_raises_after_a_load(tmp_path, monkeypatch):
    _no_cache_dir(monkeypatch)
    monkeypatch.setattr(native, "build", lambda names: {})
    monkeypatch.setattr(ctypes, "CDLL", lambda path: types.SimpleNamespace(path=path))
    native.load.cache_clear()
    try:
        lib = native.load("attention_fwd")
        assert lib.path == str(native.library_path("attention_fwd"))
        with pytest.raises(RuntimeError, match="already loaded"):
            compute.enable_compilation_cache(str(tmp_path / "later"))
        assert "SYNT_ISIC_CACHE_DIR" not in os.environ
        assert (compute.enable_compilation_cache(str(native.DEFAULT_BUILD_DIR))
                == native.DEFAULT_BUILD_DIR)
    finally:
        native.load.cache_clear()


def test_gpu_peaks_hold_the_h100_figures():
    """The H100 figures of every kernel bound in PERF.md."""
    assert compute.GPU_PEAKS == {"NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 494.7e12, "bytes_per_s": 3.35e12,
        "exp_per_s": 16 * 132 * 1.98e9}}
    # chip_smoke.py takes its bounds from the table and keeps no copy
    source = (ROOT / "chip_smoke.py").read_text()
    assert 'H100 = GPU_PEAKS["NVIDIA H100 80GB HBM3"]' in source
    assert not any(figure in source for figure in ("989e12", "494.7e12", "3.35e12", "1.98e9"))


def test_scripts_take_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    (tmp_path / "ckpt").mkdir()
    save_checkpoint(state_dict_from_jax(jax_params(TINY_JAX, 0)),
                    str(tmp_path / "ckpt" / "unet_MEL_best.pth"))
    for call in (lambda: smoke_generate.main(["--checkpoints", str(tmp_path / "ckpt"),
                                              "--output", str(tmp_path / "out")], TINY),
                 lambda: warm_cache.main(["--configs", "ddim:2:2"], TINY)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert not (tmp_path / "out").exists()
