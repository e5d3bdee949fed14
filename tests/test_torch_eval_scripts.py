"""The port's image-set evaluation entry points (`synt_isic_tpu_torch/
scripts/`) at tiny sizes on the CPU, against the JAX package's scripts of
the same names where both can run here:

  * `eval_fid`: `python -m` on two image folders (the labelled
    classifier-feature proxy), and `--generate` from a tiny checkpoint with
    an `inception_v3.pth` beside it (standard Inception FID);
  * `fairness_audit`: `python -m` on a folder of PNGs, and in process
    beside the JAX script on the same images and classifier weights: the
    same report, key for key; the numbers read from the probabilities
    (group means, distributions, gaps) within 1e-5 relative, 1e-6 absolute
    (the two classifiers' probabilities agree to 3e-7 at the shrunk 64²
    input), the statistics
    battery within 1e-3 relative (it divides by spreads of about 0.04
    over 4 images, so a 3e-7 move shows there as up to 2e-5); and
    `--generate`;
  * `parity_gauntlet`: all five steps on two tiny checkpoints (FID skipped
    without Inception weights, and failing on a corrupt file), its report
    keys those of the JAX script, and the failures on an empty folder, a
    corrupt checkpoint and a conditional one without metadata.

`e2e_loop` has its own file, `tests/test_torch_e2e_loop.py`.

Every run passes `device="cpu"`; without it each entry point takes CUDA
and raises where there is none.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import synt_isic_tpu.models.classifier as jax_classifier_module
from synt_isic_tpu_torch.models.inception_v3 import random_inception_state
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.scripts import e2e_loop, eval_fid, fairness_audit, parity_gauntlet

from tests.torch_port_fixtures import (TINY, _resnet_shapes, jax_resnet_params, one_thread,  # noqa: F401
                                       port_resnet, small_classifiers)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import fairness_audit as jax_fairness_audit  # noqa: E402
import parity_gauntlet as jax_parity_gauntlet  # noqa: E402


def _run_module(name, *args, timeout=240):
    return subprocess.run([sys.executable, "-m", f"synt_isic_tpu_torch.scripts.{name}", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=timeout)


def _write_pngs(folder: Path, n: int, seed: int, size: int = 24) -> Path:
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
            folder / f"img_{i:02d}.png")
    return folder


def _key_paths(tree, path=""):
    if not isinstance(tree, dict):
        return set()
    return {f"{path}/{k}" for k in tree} | {
        p for k, v in tree.items() for p in _key_paths(v, f"{path}/{k}")}


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """Two tiny per-class UNet checkpoints (the port's own state dicts) and
    a torchvision-keyed 7-class `classifier.pth`."""
    d = tmp_path_factory.mktemp("ckpts")
    for i, cls in enumerate(["NV", "MEL"]):
        torch.manual_seed(i)
        torch.save(UNet2D(TINY).state_dict(), d / f"unet_{cls}_best.pth")
    state = port_resnet(jax_resnet_params(7, seed=1), num_classes=7).state_dict()
    torch.save({"model." + k: v for k, v in state.items()}, d / "classifier.pth")
    return d


# -- eval_fid ---------------------------------------------------------------------

def test_eval_fid_module_prints_the_labelled_proxy(tmp_path):
    a, b = _write_pngs(tmp_path / "a", 4, 0), _write_pngs(tmp_path / "b", 4, 1)
    out = _run_module("eval_fid", "--a", str(a), "--b", str(b), "--count", "4",
                      "--checkpoints", str(tmp_path / "none"), "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("frechet_distance (classifier-feature embedding, NOT Inception-FID;")
    assert line.endswith("(n_a=4, n_b=4)")
    assert np.isfinite(float(line.split("):")[1].split()[0]))


def test_eval_fid_generates_and_takes_standard_inception(tiny_ckpts, tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "unet_MEL_best.pth").write_bytes((tiny_ckpts / "unet_MEL_best.pth").read_bytes())
    torch.save({k: torch.from_numpy(v) for k, v in random_inception_state(0).items()},
               ckpt / "inception_v3.pth")
    a = _write_pngs(tmp_path / "a", 3, 2)
    assert eval_fid.main(["--a", str(a), "--generate", "MEL", "--count", "3", "--steps", "2",
                          "--checkpoints", str(ckpt), "--device", "cpu"],
                         model_config=TINY) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("FID (standard InceptionV3 pool3): ")
    assert line.endswith("(n_a=3, n_b=3)")
    with pytest.raises(SystemExit, match="no checkpoint for NV"):
        eval_fid.main(["--a", str(a), "--generate", "NV", "--checkpoints", str(ckpt),
                       "--device", "cpu"], model_config=TINY)


def test_entry_points_take_cuda_and_raise_without_it(tiny_ckpts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    a = _write_pngs(tmp_path / "a", 2, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_fid.main(["--a", str(a), "--b", str(a), "--checkpoints", str(tiny_ckpts)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fairness_audit.main(["--images", str(a), "--checkpoints", str(tiny_ckpts),
                             "--out", str(tmp_path / "r.json")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        parity_gauntlet.run_gauntlet(str(tiny_ckpts), str(tmp_path / "g.json"),
                                     work_dir=str(tmp_path / "w"), log=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        e2e_loop.run_loop(str(tmp_path / "loop"), skip_train=True, log=lambda *_: None)


# -- fairness_audit -------------------------------------------------------------------

def _close(a, b, rel, path=""):
    """Every entry of report `a` equal to report `b`'s, numbers within
    `rel` (relative, or absolute below 0.1); timestamps apart."""
    if isinstance(a, dict):
        for k in a:
            if k != "analysis_timestamp":
                _close(a[k], b[k], rel, f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, rel, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert a == pytest.approx(b, rel=rel, abs=0.1 * rel), path
    else:
        assert a == b, path


def test_fairness_audit_report_matches_jax(tiny_ckpts, tmp_path, monkeypatch):
    images = _write_pngs(tmp_path / "imgs", 8, 4, size=32)
    argv = ["--images", str(images), "--checkpoints", str(tiny_ckpts), "--target-class", "NV",
            "--split", "median-luminance", "--batch", "4"]
    # the JAX classifier's own random init runs the network at 224²; the
    # checkpoint overwrites every entry, so zeros of the shape do
    monkeypatch.setattr(jax_classifier_module, "init_resnet_params",
                        lambda model, rng, image_size=224: jax.tree_util.tree_map(
                            lambda s: jnp.zeros(s.shape, s.dtype),
                            _resnet_shapes(model.config.num_classes)))
    monkeypatch.setattr("synt_isic_tpu.utils.compute.enable_compilation_cache", lambda: None)
    with small_classifiers():
        monkeypatch.setattr(sys, "argv", ["fairness_audit.py", *argv, "--cpu",
                                          "--out", str(tmp_path / "jax.json")])
        assert jax_fairness_audit.main() == 0
        assert fairness_audit.main([*argv, "--device", "cpu",
                                    "--out", str(tmp_path / "port.json")]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert _key_paths(got) == _key_paths(want)
    assert got["n_group"] == want["n_group"] == 4
    _close(got["prediction_distribution"], want["prediction_distribution"], 1e-5)
    for block in ("confidence", "target_class_scores"):
        for key in ("group_mean", "rest_mean"):
            _close(got[block][key], want[block][key], 1e-5, f"{block}/{key}")
    _close(got, want, 1e-3)


def test_fairness_audit_module_and_generate(tiny_ckpts, tmp_path, capsys):
    images = _write_pngs(tmp_path / "imgs", 4, 5)
    out = _run_module("fairness_audit", "--images", str(images), "--checkpoints",
                      str(tiny_ckpts), "--device", "cpu", "--out", str(tmp_path / "r.json"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "verdict:" in out.stdout
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["group_source"] == "luminance_heuristic" and "verdict" in report
    assert fairness_audit.main(["--generate", "MEL:3,NV:2", "--checkpoints", str(tiny_ckpts),
                                "--steps", "2", "--batch", "2", "--device", "cpu",
                                "--split", "median-luminance",
                                "--out", str(tmp_path / "g.json")], model_config=TINY) == 0
    assert "auditing 5 images" in capsys.readouterr().out
    assert json.loads((tmp_path / "g.json").read_text())["n_group"] + \
        json.loads((tmp_path / "g.json").read_text())["n_rest"] == 5


# -- parity_gauntlet -----------------------------------------------------------------

GAUNTLET_STEPS = {"manifest", "smoke_samples", "sidecar_reproduce", "xai_e2e", "fid"}
GAUNTLET_KEYS = {"checkpoints_dir", "steps", "started", "mode", "passed", "finished"}


def _gauntlet(ckpt, tmp_path, **kw):
    return parity_gauntlet.run_gauntlet(str(ckpt), str(tmp_path / "report.json"),
                                        model_config=TINY, work_dir=str(tmp_path / "w"),
                                        log=lambda *_: None, device="cpu", **kw)


def test_gauntlet_passes_on_valid_checkpoints(tiny_ckpts, tmp_path):
    """Every step of the JAX script's gauntlet (`scripts/parity_gauntlet.py`
    records `GAUNTLET_KEYS` and `GAUNTLET_STEPS`), with FID skipped
    honestly without Inception weights."""
    with small_classifiers():
        report = _gauntlet(tiny_ckpts, tmp_path, samples_per_class=2, steps=3)
    assert report["passed"], report["steps"]
    assert set(report) == GAUNTLET_KEYS and set(report["steps"]) == GAUNTLET_STEPS
    assert all(set(s) == {"ok", "skipped", "detail"} for s in report["steps"].values())
    assert "2/2 byte-identical" in report["steps"]["sidecar_reproduce"]["detail"]
    assert "4/4 images across 2 classes" in report["steps"]["smoke_samples"]["detail"]
    assert "(real-weights classifier)" in report["steps"]["xai_e2e"]["detail"]
    assert report["steps"]["fid"]["skipped"]
    assert "synt_isic_tpu_torch.app.download_models" in report["steps"]["fid"]["detail"]
    assert json.loads((tmp_path / "report.json").read_text())["passed"] is True


def test_gauntlet_fid_step_fails_on_a_corrupt_inception_file(tiny_ckpts, tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "unet_MEL_best.pth").write_bytes((tiny_ckpts / "unet_MEL_best.pth").read_bytes())
    (ckpt / "inception_v3.pth").write_bytes(b"garbage")
    with small_classifiers():
        report = _gauntlet(ckpt, tmp_path, samples_per_class=1, steps=2)
    assert not report["passed"]
    assert all(report["steps"][s]["ok"] for s in GAUNTLET_STEPS - {"fid"})
    assert not report["steps"]["fid"]["ok"] and not report["steps"]["fid"]["skipped"]
    assert report["steps"]["fid"]["detail"].startswith("raised:")


@pytest.mark.parametrize("case", ["empty", "corrupt", "conditional_without_metadata"])
def test_gauntlet_fails_like_jax(tmp_path, case):
    """The reports of a failed gauntlet, key for key the JAX script's."""
    d = tmp_path / "ckpts"
    if case != "empty":
        d.mkdir()
        name = "unet_NV_best.pth" if case == "corrupt" else "unet_conditional_best.pth"
        (d / name).write_bytes(b"garbage")
    (tmp_path / "port").mkdir()
    got = _gauntlet(d, tmp_path / "port")
    want = jax_parity_gauntlet.run_gauntlet(str(d), str(tmp_path / "jax.json"),
                                            work_dir=str(tmp_path / "jw"), log=lambda *_: None)
    assert not got["passed"] and not want["passed"]
    assert _key_paths(got) == _key_paths(want)
    assert got["mode"] == want["mode"]
    assert {k: v["ok"] for k, v in got["steps"].items()} == \
        {k: v["ok"] for k, v in want["steps"].items()}
    assert json.loads((tmp_path / "port" / "report.json").read_text())["passed"] is False
    if case == "conditional_without_metadata":
        assert "metadata" in got["steps"]["manifest"]["detail"]


def test_gauntlet_module_fails_on_an_empty_folder(tmp_path):
    out = _run_module("parity_gauntlet", "--checkpoints", str(tmp_path / "nothing"),
                      "--out", str(tmp_path / "r.json"), "--device", "cpu")
    assert out.returncode == 1
    assert json.loads((tmp_path / "r.json").read_text())["passed"] is False
