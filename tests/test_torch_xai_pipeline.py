"""The port's comprehensive XAI pipeline against the JAX package's on the
same three 32² frames, with the same numpy ResNet-18 weights and the
classifier input shrunk to 64² in both packages (`small_classifiers`).

The JAX run's draws (the IG noise baseline, the SHAP masks from
fold_in(key, i), the coalitional permutations) are read from the keys its
analyzer handed out and injected into the port's analyzer, so the numbers
compare at the tolerances of `test_torch_xai.py`: attribution maps and
their statistics 1e-4 · max|value|, Time-SHAP (and the coalitional
values, whose frame scores are each package's own) 1e-5, Grad-CAM 1e-3,
CFI 1e-5, the statistics battery over those CFIs 1e-4. Files and JSON
keys compare exactly. The sanity checks compare on their own, with a
fixed IG function in both packages: their deterministic numbers at 1e-6
and their keys.
"""
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.xai.attribution import XAIAnalyzer as JaxXAIAnalyzer
from synt_isic_tpu.xai.pipeline import run_comprehensive_xai_pipeline as jax_pipeline
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.xai import (FairnessAuditor, IntegratedXAIAnalyzer, XAIAnalyzer,
                                     compute_gradcam, run_comprehensive_xai_pipeline,
                                     run_xai_analysis)
from synt_isic_tpu_torch.xai import standalone

from tests.torch_port_fixtures import TINY, classifier_pair, small_classifiers, tp_mesh

NUM_CLASSES, TARGET, SIZE, PATCH = 8, 1, 32, 8
TIMESTEPS = [900.0, 500.0, 0.0]
ANALYZER = dict(ig_n_steps=4, shap_n_samples=8, shap_patch_size=PATCH, seed=0)
# the sanity checks run 8 IG passes of their own at 20 and 15 steps:
# `test_sanity_checks_match_jax` holds them on their own
PIPELINE = dict(target_class_id=TARGET, target_class_name="NV",
                intervention_types=("blur", "zero"), n_bootstrap=200, n_permutations=500,
                coalitional_shap=True, coalitional_permutations=16, save_figures=False,
                with_sanity=False, log=lambda *a: None)


@pytest.fixture(scope="module")
def clfs():
    with small_classifiers():
        yield classifier_pair(NUM_CLASSES)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(21)
    return (0.95 * np.tanh(rng.normal(size=(3, SIZE, SIZE, 3)))).astype(np.float32)


def _recording(jan):
    """The JAX analyzer, recording every key its `_next_key` hands out."""
    keys, draw = [], jan._next_key
    jan._next_key = lambda: keys.append(draw()) or keys[-1]
    return keys


def _port_analyzer(clf, jan, keys, n_frames):
    """The port's analyzer with the JAX run's draws: the cached noise
    baseline, the SHAP masks of the second key, the permutations of the
    last."""
    an = XAIAnalyzer(clf, **ANALYZER)
    for (kind, shape), base in jan._baseline_cache.items():
        an._baseline_cache[(kind, shape)] = torch.from_numpy(np.asarray(base))
    ph = SIZE // PATCH
    masks = np.stack([np.asarray(jax.random.bernoulli(jax.random.fold_in(keys[1], i), 0.5,
                                                      (ANALYZER["shap_n_samples"], ph, ph)))
                      for i in range(n_frames)])
    an._draw_patch_masks = lambda *shape: torch.from_numpy(masks)
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n_frames))(
        jax.random.split(keys[-1], PIPELINE["coalitional_permutations"])))
    an._draw_permutations = lambda *shape: torch.from_numpy(perms)
    return an


@pytest.fixture(scope="module")
def runs(clfs, frames, tmp_path_factory):
    """Both pipelines on the same frames, results saved, no figures (the
    figure files are compared by `test_torch_xai_standalone.py`)."""
    jclf, clf = clfs
    jan = JaxXAIAnalyzer(jclf, **ANALYZER)
    keys = _recording(jan)
    jdir, pdir = tmp_path_factory.mktemp("jax_run"), tmp_path_factory.mktemp("port_run")
    want = jax_pipeline(jnp.asarray(frames), TIMESTEPS, jan, jclf, results_dir=jdir, **PIPELINE)
    an = _port_analyzer(clf, jan, keys, len(frames))
    got = run_comprehensive_xai_pipeline(frames, TIMESTEPS, an, clf, results_dir=pdir,
                                         **PIPELINE)
    return want, got, jdir, pdir


def close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def numbers_close(got, want, atol, path=""):
    """Same keys and types; floats within atol, the rest equal."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            numbers_close(got[key], want[key], atol, f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            numbers_close(g, w, atol, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        assert got == pytest.approx(want, abs=atol), path
    elif isinstance(want, np.ndarray):
        close(got, want, atol)
    else:
        assert got == want, path


def key_paths(tree, path=""):
    """Every dict key path of a JSON-like tree."""
    out = set()
    if isinstance(tree, dict):
        for key, value in tree.items():
            out.add(f"{path}/{key}")
            out |= key_paths(value, f"{path}/{key}")
    return out


def test_result_keys_and_files_match_jax(runs):
    want, got, jdir, pdir = runs
    assert set(got) == set(want)
    assert sorted(p.name for p in pdir.iterdir()) == sorted(p.name for p in jdir.iterdir())
    jjson = json.loads((jdir / "analysis_results.json").read_text())
    pjson = json.loads((pdir / "analysis_results.json").read_text())
    assert key_paths(pjson) == key_paths(jjson)
    assert set(got["metadata"]["stage_seconds"]) == set(want["metadata"]["stage_seconds"])
    with open(pdir / "full_results.pkl", "rb") as f:
        pickled = pickle.load(f)
    assert set(pickled) == set(got)
    # the pickle holds host arrays, no tensors
    ires = pickled["interventions"]["t_900"]["top_k"]["blur"]
    assert isinstance(ires["modified_image"], np.ndarray)


def test_attribution_maps_and_regions_match_jax(runs):
    want, got, *_ = runs
    assert list(got["xai_maps"]) == list(want["xai_maps"])
    for step, w in want["xai_maps"].items():
        g = got["xai_maps"][step]
        close(g["attribution_map"], w["attribution_map"], 1e-4)
        numbers_close(g["method_details"], w["method_details"], 1e-4 * np.abs(
            w["attribution_map"]).max())
        assert g["image_shape"] == w["image_shape"]
        for region in ("top_k", "bottom_k"):
            assert np.array_equal(got["region_analysis"][step][region]["mask"],
                                  want["region_analysis"][step][region]["mask"]), (step, region)


def test_interventions_cfi_and_statistics_match_jax(runs):
    want, got, *_ = runs
    assert list(got["cfi_analysis"]) == list(want["cfi_analysis"])
    numbers_close(got["cfi_analysis"], want["cfi_analysis"], 1e-5)
    for step, per_region in want["interventions"].items():
        for region, per_type in per_region.items():
            for itype, w in per_type.items():
                g = got["interventions"][step][region][itype]
                numbers_close(g["statistics"], w["statistics"], 1e-5)
                close(g["modified_image"], w["modified_image"], 1e-6)
    stats_got, stats_want = got["statistical_validation"], want["statistical_validation"]
    for result in (stats_got, stats_want):
        result["metadata"].pop("analysis_timestamp")
    numbers_close(stats_got, stats_want, 1e-4)


def test_time_shap_and_gradcam_match_jax(runs):
    want, got, *_ = runs
    close(got["time_shap"]["importance"], want["time_shap"]["importance"], 1e-5)
    assert got["time_shap"]["most_important_index"] == want["time_shap"]["most_important_index"]
    coal_got, coal_want = got["time_shap"]["coalitional"], want["time_shap"]["coalitional"]
    np.testing.assert_allclose(coal_got["shapley_values"], coal_want["shapley_values"],
                               rtol=0, atol=1e-5)
    assert abs(coal_got["efficiency_gap"]) < 1e-5
    for step, cam in want["gradcam"].items():
        np.testing.assert_allclose(got["gradcam"][step], cam, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["gradcam_summary"], want["gradcam_summary"], rtol=0,
                               atol=1e-3)
    assert got["gradcam_most_important"]["index"] == want["gradcam_most_important"]["index"]


class _StubAnalyzer:
    """IG maps as a fixed numpy function of (image, class, steps), so the
    sanity checks' logic runs without a network in both packages."""

    def compute_integrated_gradients(self, image, target_class, n_steps=None):
        port = isinstance(image, torch.Tensor)
        x = np.asarray(image.cpu() if port else image, np.float64)
        ramp = np.linspace(-1.0, 1.0, x.size).reshape(x.shape)
        out = (np.sin(3.0 * x * (target_class + 1)) + 0.1 * n_steps * ramp
               + (target_class == 2) * ramp ** 2).astype(np.float32)
        return torch.from_numpy(out) if port else out


def test_sanity_checks_match_jax(clfs, frames):
    """Keys and the deterministic parts: with IG a fixed function of the
    input, the weight-randomisation and class-sensitivity numbers are the
    same in both packages; the input-independence inputs are each
    package's own draws, so those numbers only exist."""
    from synt_isic_tpu.xai.sanity import sanity_check_comprehensive as jax_sanity
    from synt_isic_tpu_torch.xai import sanity_check_comprehensive

    jclf, clf = clfs
    want = jax_sanity(jclf, jnp.asarray(frames[-1:]), TARGET, _StubAnalyzer())
    got = sanity_check_comprehensive(clf, frames[-1:], TARGET, _StubAnalyzer())
    assert key_paths(got) == key_paths(want)
    for test in ("weight_randomization_test", "model_sensitivity_test"):
        numbers_close(got[test], want[test], 1e-6)
    indep_got = got["input_independence_test"]
    assert len(indep_got["independence_correlations"]) == 3
    assert set(indep_got) == set(want["input_independence_test"])
    # the port's own run, with its analyzer: the same keys
    real = sanity_check_comprehensive(clf, frames[-1:], TARGET, XAIAnalyzer(clf, **ANALYZER))
    assert key_paths(real) == key_paths(want)
    assert real["model_sensitivity_test"]["classes_tested"] == 2


def test_integrated_analyzer_writes_the_reference_layout(clfs, frames, tmp_path):
    """`analyze_trajectory` on a generator's image path: the results under
    <output>/xai_results/<class>/<stem>_<seed>, JSON-safe, with the
    trajectory mosaic; `run_xai_analysis` then previews an artifact."""
    _, clf = clfs
    image = tmp_path / "out" / "MEL" / "ISIC_0000002.png"
    image.parent.mkdir(parents=True)
    from PIL import Image
    Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(image)
    adapter = IntegratedXAIAnalyzer(classifier=clf, verbose=False, ig_n_steps=2,
                                    shap_n_samples=8, save_figures=False, with_sanity=False,
                                    n_bootstrap=20, n_permutations=50)
    adapter.xai_analyzer.shap_patch_size = PATCH
    with torch.inference_mode():
        traj = torch.from_numpy(frames)    # a trajectory kept under inference_mode
    result = adapter.analyze_trajectory(traj, "MEL", 7, 3, image.name, str(image))
    run_dir = tmp_path / "out" / "xai_results" / "MEL" / "ISIC_0000002_7"
    assert result["artifacts"]["trajectory_all_steps"] == str(run_dir / "trajectory_all_steps.png")
    assert (run_dir / "analysis_results.json").exists()
    json.dumps(result)
    assert result["metadata"]["target_class_name"] == "MEL"
    assert result["metadata"]["timesteps"] == [0.0, 1.0, 2.0]
    _, shown = run_xai_analysis(str(image))
    assert shown == str(image)      # no step figure was written: the image itself


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A directory with a seeded random tiny `unet_MEL_best.pth`."""
    from synt_isic_tpu_torch.models.unet2d import UNet2D

    path = tmp_path_factory.mktemp("tp_ckpt")
    torch.manual_seed(3)
    torch.save(UNet2D(TINY).state_dict(), path / "unet_MEL_best.pth")
    return path


SMALL = dict(ig_n_steps=2, shap_n_samples=8, seed=0)


def _maps(result):
    """The attribution maps of a pipeline result, by frame."""
    return {step: {k: v for k, v in maps.items() if isinstance(v, np.ndarray)}
            for step, maps in result["xai_maps"].items()}


def _analyzer_set_mesh(clf, mesh, frames):
    an = XAIAnalyzer(clf, **SMALL)
    an.set_mesh(mesh)
    return an.compute_time_shap(frames, TIMESTEPS, TARGET)[1]["probability_scores"]


def _pipeline(clf, mesh, frames):
    an = XAIAnalyzer(clf, shap_patch_size=PATCH, **SMALL)
    return _maps(run_comprehensive_xai_pipeline(
        frames[:1], [0.0], an, clf, TARGET, "NV", n_bootstrap=20, n_permutations=50,
        save_results=False, save_figures=False, with_sanity=False, mesh=mesh,
        log=lambda *a: None))


def _standalone(mesh, ckpt, tmp):
    return _maps(standalone.run_standalone_xai(
        mesh=mesh, device="cpu", checkpoints_dir=str(ckpt), model_config=TINY,
        results_dir=str(tmp / ("mesh" if mesh else "plain")), inference_steps=3,
        save_every=2, num_classes=NUM_CLASSES, ig_n_steps=2, shap_n_samples=4,
        n_bootstrap=10, n_permutations=20, with_sanity=False, save_figures=False,
        log=lambda *a: None))


def _generator(mesh, ckpt, tmp):
    from PIL import Image

    gen = ImageGenerator(checkpoints_dir=str(ckpt), device="cpu", model_config=TINY)
    gen.set_inference_steps(2)
    gen.set_generation_seed(5)
    gen.scheduler_kind = "ddim"
    gen.set_mesh(mesh)
    out = tmp / ("gen_mesh" if mesh else "gen_plain")
    assert gen.generate_images([("MEL", 2)], str(out))["generated"] == 2
    blocks = [json.loads(p.read_text()).get("block", {})
              for p in sorted((out / "MEL").glob("*.json"))]
    assert [b.get("dp_mesh") for b in blocks] == ([2, 2] if mesh else [None, None])
    return np.stack([np.asarray(Image.open(p), np.float64)
                     for p in sorted((out / "MEL").glob("*.png"))])


@pytest.mark.parametrize("call, rel", [
    (lambda clf, mesh, frames, ckpt, tmp: XAIAnalyzer(clf, mesh=mesh, **SMALL)
     .compute_ig_frames(frames, TARGET), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: _analyzer_set_mesh(clf, mesh, frames), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: compute_gradcam(clf, frames, TARGET, output_size=32,
                                                          mesh=mesh), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: _pipeline(clf, mesh, frames), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: IntegratedXAIAnalyzer(
        classifier=clf, mesh=mesh, verbose=False, **SMALL).xai_analyzer
     .compute_shap_frames(frames, TARGET, patch_size=PATCH), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: FairnessAuditor(clf, batch_size=2, mesh=mesh)
     .probabilities((frames * 127.5 + 127.5).astype(np.uint8)), 1e-5),
    (lambda clf, mesh, frames, ckpt, tmp: _standalone(mesh, ckpt, tmp), 1e-5),
    # one 8-bit level of the written images
    (lambda clf, mesh, frames, ckpt, tmp: _generator(mesh, ckpt, tmp), 1 / 255),
], ids=["analyzer", "set_mesh", "gradcam", "pipeline", "integrated", "fairness", "standalone",
        "generator"])
def test_mesh_arguments_refuse(clfs, frames, tiny_ckpt, tmp_path, call, rel):
    """Tensor parallelism is ported: every surface takes a 1 x 2 ('data',
    'model') mesh and gives the result it gives without one (the XAI
    surfaces split their frames over 'data' on each row's first device and
    the 'model' axis replicates, as JAX's `shard_map` with `P()` does; the
    generator walks its blocks on the row with the UNet channel-sharded and
    records the mesh's 2 devices in its sidecars), within rel of each
    output's largest magnitude."""
    got = call(clfs[1], tp_mesh(), frames, tiny_ckpt, tmp_path)
    want = call(clfs[1], None, frames, tiny_ckpt, tmp_path)
    if isinstance(want, dict):
        assert set(got) == set(want) and want
        for step in want:
            assert set(got[step]) == set(want[step]) and want[step]
            for key in want[step]:
                close(got[step][key], want[step][key], rel)
    else:
        close(got, want, rel)


def test_standalone_main_refuses_a_mesh(monkeypatch):
    """`XAI_MESH_DEVICES` builds its mesh on the cards unless `XAI_DEVICE`
    names the CPU: without CUDA it raises, never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("XAI_MESH_DEVICES", "2")
    monkeypatch.delenv("XAI_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        standalone.main()
