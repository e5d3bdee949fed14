"""The port's standalone XAI run against the JAX package's, end to end at a
tiny size on the CPU: the tiny UNet checkpoint of `torch_port_fixtures`
(16² images, DDPM 4 steps, every third frame kept: 2 frames), a
torchvision-keyed `classifier.pth` with 8 outputs written here, the
classifier input shrunk to 64² in both packages, figures on.

The port runs through `main()` and its environment protocol with
`XAI_DEVICE=cpu`. The two trajectories come from different noise streams
by design (each package's own seeded generators), so the numbers differ;
the files (but for the most important step's, which the numbers pick),
the JSON keys, the kept timesteps and the classifier's load counts must
not.
"""
import functools
import json

import jax
import jax.numpy as jnp
import pytest
import torch

import synt_isic_tpu.models.classifier as jax_classifier_module
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu.xai.standalone import run_standalone_xai as jax_standalone
from synt_isic_tpu_torch.xai import standalone

from tests.torch_port_fixtures import (TINY, TINY_JAX, _resnet_shapes, jax_params,
                                       jax_resnet_params, port_resnet, small_classifiers)

RUN = dict(target_class="MEL", seed=11, inference_steps=4, save_every=3, ig_n_steps=2,
           shap_n_samples=4, n_bootstrap=20, n_permutations=50, with_sanity=False)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("checkpoints")
    save_pth(flax_to_torch(jax_params()), str(path / "unet_MEL_best.pth"))
    state = port_resnet(jax_resnet_params(8, seed=1)).state_dict()
    torch.save({"model." + k: v for k, v in state.items()}, path / "classifier.pth")
    return path


def _key_paths(tree, path=""):
    if not isinstance(tree, dict):
        return set()
    return {f"{path}/{k}" for k in tree} | {
        p for k, v in tree.items() for p in _key_paths(v, f"{path}/{k}")}


def test_standalone_files_and_keys_match_jax(ckpt_dir, tmp_path, monkeypatch):
    logs = []
    with small_classifiers():
        # the JAX classifier's own random init runs the network at 224²;
        # the checkpoint overwrites every entry, so zeros of the shape do
        monkeypatch.setattr(jax_classifier_module, "init_resnet_params",
                            lambda model, rng, image_size=224: jax.tree_util.tree_map(
                                lambda s: jnp.zeros(s.shape, s.dtype),
                                _resnet_shapes(model.config.num_classes)))
        want = jax_standalone(checkpoints_dir=str(ckpt_dir), model_config=TINY_JAX,
                              results_dir=str(tmp_path / "jax"), log=logs.append, **RUN)
        monkeypatch.setattr(standalone, "run_standalone_xai", functools.partial(
            standalone.run_standalone_xai, model_config=TINY, log=logs.append,
            **{k: v for k, v in RUN.items() if k not in ("target_class", "seed",
                                                         "inference_steps", "save_every")}))
        for name, value in (("XAI_TARGET_CLASS", "MEL"), ("XAI_GENERATION_SEED", "11"),
                            ("XAI_INFERENCE_STEPS", "4"), ("XAI_SAVE_EVERY_N", "3"),
                            ("XAI_CHECKPOINTS_DIR", str(ckpt_dir)),
                            ("XAI_RESULTS_DIR", str(tmp_path / "port")),
                            ("XAI_DEVICE", "cpu")):
            monkeypatch.setenv(name, value)
        assert standalone.main() == 0
    (run_dir,) = (tmp_path / "port" / "MEL").iterdir()
    assert run_dir.name.startswith("standalone_seed11_")
    names, jnames = ([p.name for p in d.iterdir() if not p.name.startswith("gradcam_most")]
                     for d in (run_dir, tmp_path / "jax"))
    assert sorted(names) == sorted(jnames)
    assert "xai_step_t_750_SHAP.png" in names and "gradcam_overview.png" in names
    assert len(list(run_dir.glob("gradcam_most_important_t*.png"))) == 1
    got = json.loads((run_dir / "analysis_results.json").read_text())
    jwant = json.loads((tmp_path / "jax" / "analysis_results.json").read_text())
    assert _key_paths(got) == _key_paths(jwant)
    assert got["metadata"]["n_timesteps"] == want["metadata"]["n_timesteps"] == 2
    assert got["metadata"]["timesteps"] == want["metadata"]["timesteps"]
    loads = [line for line in logs if "classifier loaded" in line]
    assert len(loads) == 2 and loads[0].split(": ", 1)[1] == loads[1].split(": ", 1)[1]
    assert "'loaded': 102, 'skipped': 0" in loads[1]


def test_main_reads_the_environment(monkeypatch, tmp_path):
    seen = {}

    def fake(**kwargs):
        seen.update(kwargs)
        return None

    monkeypatch.setattr(standalone, "run_standalone_xai", fake)
    monkeypatch.setenv("XAI_TARGET_CLASS", "NV")
    monkeypatch.setenv("XAI_GENERATION_SEED", "7")
    monkeypatch.setenv("XAI_CHECKPOINTS_DIR", str(tmp_path / "ckpt"))
    monkeypatch.setenv("XAI_COALITIONAL_SHAP", "1")
    monkeypatch.delenv("XAI_DEVICE", raising=False)
    monkeypatch.delenv("XAI_RESULTS_DIR", raising=False)
    assert standalone.main() == 1                     # no results: rc 1
    assert (seen["target_class"], seen["seed"], seen["checkpoints_dir"]) == (
        "NV", 7, str(tmp_path / "ckpt"))
    assert seen["device"] is None and seen["results_dir"] is None   # CUDA by default
    assert seen["coalitional_shap"] is True


def test_missing_ddpm_returns_none(tmp_path):
    assert standalone.run_standalone_xai(checkpoints_dir=str(tmp_path), device="cpu",
                                         log=lambda *a: None) is None
