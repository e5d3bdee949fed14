"""Every surface that takes a mesh in the JAX package takes one in the port:
training (against the unsharded step and against the JAX `train_class` over
a 2-device mesh), distillation, the CLI, the library generator, the
server, and the XAI fan-out; on the CPU, with meshes of repeated CPU
devices and the tiny configuration of `tests/torch_port_fixtures.py`.

A data-parallel step equals the unsharded step up to the order of the
gradient sum; after Adam's first steps (each weight moves by about +-lr) a
parameter is held to 1e-5 of the unsharded step's here (the attention key
biases, whose exact gradient is zero, to 3 * lr), and to 3 * lr of the JAX
step's, the bound of `tests/test_torch_train.py`.
"""
import functools
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.parallel.mesh import create_mesh as jax_create_mesh
from synt_isic_tpu.train import procedural as jax_procedural
from synt_isic_tpu.train import train_ddpm as jax_train
from synt_isic_tpu_torch import cli, serve
from synt_isic_tpu_torch.diffusion.schedules import DiffusionSchedule
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.io.manifest import normalize_key
from synt_isic_tpu_torch.io.pth import load_checkpoint
from synt_isic_tpu_torch.parallel import create_mesh
from synt_isic_tpu_torch.serve import GenerationServer, request
from synt_isic_tpu_torch.train import distill, train_ddpm
from synt_isic_tpu_torch.xai import FairnessAuditor, XAIAnalyzer, standalone
from synt_isic_tpu_torch.xai.gradcam import compute_gradcam

from tests.test_torch_serve import _tiny_init
from tests.torch_port_fixtures import (TINY, TINY_COND, TINY_COND_JAX, TINY_JAX,  # noqa: F401
                                       classifier_input, jax_params, jax_resnet_params,
                                       one_thread, port_model, port_resnet)

CPU = torch.device("cpu")
SIZE = TINY.sample_size


# two distinct devices that both compute on the CPU: each its own replica
TWO_DEVICES = [CPU, torch.device("cpu", 1)]


def _mesh(n):
    return create_mesh({"data": n}, [CPU] * n)


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=4)


@pytest.fixture(scope="module")
def ckpt_dir(params, tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_ckpt")
    save_pth(flax_to_torch(params), str(path / "unet_MEL_best.pth"))
    return path


def _batches(n_steps, batch, seed=0):
    rng = np.random.default_rng(seed)
    return [np.tanh(rng.normal(size=(batch, SIZE, SIZE, 3))).astype(np.float32)
            for _ in range(n_steps)]


def _train(params, mesh, cfg, batches, draws=None):
    """`make_train_step` from the same weights over `batches`; the step's
    (t, eps) from `draws` when given, else from a seeded generator."""
    model = port_model(params)
    state = train_ddpm.create_train_state(model, cfg, mesh=mesh)
    step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i, batch in enumerate(batches):
        kw = ({} if draws is None else
              dict(t=torch.from_numpy(draws[i][0]), eps=torch.from_numpy(draws[i][1])))
        losses.append(float(step(state, torch.from_numpy(batch), gen, **kw)))
        for other in state.replicas.others() if state.replicas is not None else []:
            for a, b in zip(model.state_dict().values(), other.state_dict().values()):
                assert torch.equal(a, b)
    return losses, model.state_dict()


@pytest.mark.parametrize("labels", [False, True], ids=["uncond", "cond-minsnr"])
def test_dp_step_equals_the_unsharded_step(params, labels):
    """Two steps on a 2-entry mesh against the single-device steps, with
    the draws (t, eps and, labelled, the CFG dropout) taken once for the
    global batch: losses to rtol 1e-6, weights to 1e-5, and after each step
    every replica `torch.equal` to the primary (checked in `_train`)."""
    cfg = train_ddpm.TrainConfig(image_size=SIZE, batch_size=4, bf16_compute=False,
                                 min_snr_gamma=5.0 if labels else 0.0, ema_decay=0.9)
    batches = _batches(2, 4)
    if labels:
        params = jax_params(TINY_COND_JAX, seed=4)
        lab = torch.tensor([0, 1, 2, 1])
        batches = [(b, lab) for b in batches]

        def run(mesh):
            model = port_model(params, config=TINY_COND)
            state = train_ddpm.create_train_state(model, cfg, mesh=mesh)
            step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
            gen = torch.Generator().manual_seed(0)
            losses = [float(step(state, (torch.from_numpy(b), y), gen)) for b, y in batches]
            return losses, model.state_dict(), state.ema
        one, two = run(None), run(_mesh(2))
        np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
        _weights_close(two[1], one[1], cfg.learning_rate)
        _weights_close(two[2], one[2], cfg.learning_rate)
        return
    one = _train(params, None, cfg, batches)
    two = _train(params, _mesh(2), cfg, batches)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
    _weights_close(two[1], one[1], cfg.learning_rate)


def test_dp_step_with_two_replicas_equals_the_unsharded_step(params):
    """Two steps on [cpu, cpu:1], two distinct devices of the one CPU: the
    second shard's backward runs on its own replica, whose gradients are
    summed into the primary's, and the updated weights are copied back.
    Losses to rtol 1e-6, weights as `_weights_close` holds them, and after
    each step the replica `torch.equal` to the primary (in `_train`)."""
    cfg = train_ddpm.TrainConfig(image_size=SIZE, batch_size=4, bf16_compute=False,
                                 ema_decay=0.9)
    batches = _batches(2, 4)
    model = port_model(params)
    mesh = create_mesh({"data": 2}, TWO_DEVICES)
    assert len(train_ddpm.create_train_state(model, cfg, mesh=mesh).replicas.others()) == 1
    one = _train(params, None, cfg, batches)
    two = _train(params, mesh, cfg, batches)
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
    _weights_close(two[1], one[1], cfg.learning_rate)


def _weights_close(got, want, lr):
    """Every weight within 1e-5, but the attention key biases within 3 *
    lr: their gradient is zero in exact arithmetic (softmax ignores a shift
    shared by every key), so Adam scales the rounding of the sum to a step
    of up to +-lr, whatever the order."""
    for name, w in want.items():
        atol = 3 * lr if name.endswith("to_k.bias") else 1e-5
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_dp_train_class_matches_jax_train_class(params, tmp_path, monkeypatch):
    """The JAX `train_class` over a 2-device mesh for one epoch of 2 steps,
    and the port's dp step on a 2-entry mesh over the same batches with the
    JAX step's (t, eps) draws injected: losses to rtol 1e-4, weights to 3 *
    lr. Then the port's own `train_class(mesh=)` runs the same epoch and
    writes its checkpoint."""
    cfg_kw = dict(image_size=SIZE, batch_size=2, epochs=1, bf16_compute=False)
    jcfg = jax_train.TrainConfig(**cfg_kw)
    monkeypatch.setattr(jax_train, "create_train_state",
                        functools.partial(jax_train.create_train_state, params=params))
    dataset = jax_procedural.ProceduralDataset("MEL", 4, image_size=SIZE, seed=0)
    logs = []
    with jax.default_matmul_precision("highest"):
        want = jax_train.train_class("MEL", dataset, str(tmp_path / "jax"), jcfg,
                                     model=JaxUNet2D(config=TINY_JAX),
                                     mesh=jax_create_mesh({"data": 2}, jax.devices()[:2]),
                                     log=logs.append)
    # the batches and keys the JAX loop drew
    batches = [np.asarray(b) for b in dataset.batches(2, np.random.default_rng(0))]
    key, draws = jax.random.PRNGKey(0), []
    for b in batches:
        key, sub = jax.random.split(key)
        k_t, k_eps, _ = jax.random.split(sub, 3)
        draws.append((np.array(jax.random.randint(k_t, (2,), 0, 1000)),
                      np.array(jax.random.normal(k_eps, b.shape))))
    cfg = train_ddpm.TrainConfig(**cfg_kw)
    losses, weights = _train(params, _mesh(2), cfg, batches, draws)
    assert want["steps"] == 2
    np.testing.assert_allclose(np.mean(losses), want["history"][0], rtol=1e-4)
    jweights = {normalize_key(k): v for k, v in
                load_checkpoint(str(tmp_path / "jax" / "unet_MEL_best.pth")).items()}
    for name, p in weights.items():
        np.testing.assert_allclose(p.numpy(), jweights[name].numpy(), rtol=0,
                                   atol=3 * cfg.learning_rate, err_msg=name)

    from synt_isic_tpu_torch.train.procedural import ProceduralDataset

    out = train_ddpm.train_class("MEL", ProceduralDataset("MEL", 4, image_size=SIZE, seed=0,
                                                          device=CPU),
                                 str(tmp_path / "port"), cfg, model=port_model(params),
                                 mesh=_mesh(2), device="cpu", log=logs.append)
    assert out["steps"] == 2 and (tmp_path / "port" / "unet_MEL_best.pth").exists()


def test_dp_distill_step_equals_the_unsharded_step(params):
    """One distillation step on a 2-entry mesh (the teacher's two forwards
    and the student's pass per shard) against the unsharded step with the
    same (k, eps): weights to 1e-5, and the loss to rtol 2e-4. The
    truncated-SNR weight (about 1e3 at the smallest timestep) magnifies the
    batch-composition rounding of the x0 error: the same rows at batch 2
    and at batch 4 differ by 1e-4 there."""
    cfg = distill.DistillConfig(batch_size=4, bf16_compute=False, steps_per_phase=4,
                                warmup_steps=1)
    step = distill.make_distill_step(DiffusionSchedule.create(), cfg, 4)
    batch = torch.from_numpy(_batches(1, 4)[0])
    gen_k, gen_e = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    k = torch.randint(0, 4, (4,), generator=gen_k)
    eps = torch.randn(batch.shape, generator=gen_e)

    def run(mesh):
        student, teacher = port_model(params), port_model(params).requires_grad_(False)
        state = distill.create_distill_state(student, cfg, mesh)
        teachers = (teacher if mesh is None
                    else distill.Replicas(teacher, mesh))
        loss = float(step(state, teachers, batch, k=k, eps=eps))
        return loss, student.state_dict()

    one, two = run(None), run(_mesh(2))
    assert two[0] == pytest.approx(one[0], rel=2e-4)
    _weights_close(two[1], one[1], cfg.learning_rate)


def test_cli_dp_mesh_sidecar_round_trip(ckpt_dir, tmp_path, monkeypatch, capsys):
    """`--device cpu --dp-mesh 2` (two repeats of the CPU device): the
    sidecars record `dp_mesh: 2`, `--reproduce` rebuilds the 2-entry mesh
    and is byte-identical, and the images are the no-mesh run's within one
    8-bit level (the batch composition changes the convolutions' rounding)."""
    monkeypatch.setattr(cli, "ConsoleGenerator",
                        functools.partial(cli.ConsoleGenerator, model_config=TINY))
    argv = ["--checkpoints", str(ckpt_dir), "--class-counts", "MEL:3", "--batch", "3",
            "--steps", "2", "--scheduler", "ddim", "--seed", "5", "--device", "cpu"]
    assert cli.main([*argv, "--base-dir", str(tmp_path / "mesh"), "--dp-mesh", "2"]) == 0
    assert cli.main([*argv, "--base-dir", str(tmp_path / "plain")]) == 0
    sidecars = sorted((tmp_path / "mesh" / "ISIC2018_Task3_synt").glob("*.json"))
    assert len(sidecars) == 3
    for sc in sidecars:
        meta = json.loads(sc.read_text())
        assert meta["block"]["dp_mesh"] == 2 and len(meta["block"]["seeds"]) == 3
        plain = tmp_path / "plain" / "ISIC2018_Task3_synt" / meta["filename"]
        from PIL import Image
        a = np.asarray(Image.open(sc.with_name(meta["filename"])), np.int16)
        b = np.asarray(Image.open(plain), np.int16)
        assert np.abs(a - b).max() <= 1
    capsys.readouterr()
    assert cli.reproduce_from_sidecar(str(sidecars[1]), str(ckpt_dir), model_config=TINY,
                                      device="cpu") == 0
    assert "byte-identical" in capsys.readouterr().out
    redo = json.loads(sidecars[1].with_name(
        sidecars[1].stem + "_reproduced.json").read_text())
    assert redo["block"]["dp_mesh"] == 2
    assert "repeated device" in " ".join(cli.build_parser().format_help().split())


def test_generator_mesh_blocks_reproduce(ckpt_dir, tmp_path):
    """`ImageGenerator.set_mesh` over 2 CPU entries: every sidecar (one
    image blocks included) records the mesh, `--reproduce` is byte-identical,
    and the images are the unsharded generator's within one 8-bit level."""
    def gen(mesh):
        g = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY, device="cpu")
        g.set_inference_steps(2)
        g.set_generation_seed(3)
        g.scheduler_kind = "ddim"
        g.batch_size = 3
        g.set_mesh(mesh)
        return g

    out_mesh, out_plain = tmp_path / "mesh", tmp_path / "plain"
    assert gen(_mesh(2)).generate_images([("MEL", 4)], str(out_mesh))["generated"] == 4
    assert gen(None).generate_images([("MEL", 4)], str(out_plain))["generated"] == 4
    sidecars = sorted((out_mesh / "MEL").glob("*.json"))
    blocks = [json.loads(s.read_text())["block"] for s in sidecars]
    assert [b["dp_mesh"] for b in blocks] == [2, 2, 2, 2]
    assert [len(b["seeds"]) for b in blocks] == [3, 3, 3, 1]
    from PIL import Image
    for s in sidecars:
        name = s.with_suffix(".png").name
        a = np.asarray(Image.open(out_mesh / "MEL" / name), np.int16)
        b = np.asarray(Image.open(out_plain / "MEL" / name), np.int16)
        assert np.abs(a - b).max() <= 1
    for s in (sidecars[1], sidecars[3]):
        assert cli.reproduce_from_sidecar(str(s), str(ckpt_dir), model_config=TINY,
                                          device="cpu") == 0
        redo = s.with_name(s.stem + "_reproduced.png")
        assert redo.read_bytes() == s.with_suffix(".png").read_bytes()


def test_serve_mesh_rounds_the_batch_and_answers(ckpt_dir, tmp_path, monkeypatch, capsys):
    """`serve --device cpu --mesh 2 --batch 3`: the device batch and the
    coalescing cap round up to 4, `status` and the warmup report the mesh,
    and a bulk generate request is answered through the sharded sampler
    (its sidecars record the mesh)."""
    replies = []

    def serve_once(self):
        host, port = self.address
        replies.append(request(host, port, {"op": "status"}))
        replies.append(request(host, port, {"op": "generate", "class": "MEL", "count": 3,
                                            "seed": 1, "postprocess": False}))
        self.stop()

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(GenerationServer, "serve_forever", serve_once)
    monkeypatch.setattr(ImageGenerator, "__init__", _tiny_init())
    rc = serve.main(["--device", "cpu", "--checkpoints", str(ckpt_dir), "--port", "0",
                     "--steps", "2", "--batch", "3", "--scheduler", "ddim", "--dtype", "f32",
                     "--mesh", "2", "--warmup", "MEL", "--interactive-cost", "1",
                     "--output-root", str(tmp_path / "out")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "serving over a {'data': 2} mesh (device batch 4)" in out
    assert "'mesh': {'data': 2}" in out and "'compiled_batches': [1, 4]" in out
    status, reply = replies
    assert status["mesh"] == {"data": 2} and status["device_batch"] == 4
    assert status["max_batch"] == 4
    assert reply["ok"] and len(reply["files"]) == 3
    meta = json.loads(open(reply["files"][0][:-4] + ".json").read())
    assert meta["block"]["dp_mesh"] == 2


@pytest.fixture(scope="module")
def classifier():
    from synt_isic_tpu_torch.models.classifier import LesionClassifier

    with classifier_input(64):
        yield LesionClassifier(port_resnet(jax_resnet_params(8, seed=2), 8), device="cpu")


FRAMES = (0.95 * np.tanh(np.random.default_rng(8).normal(size=(3, SIZE, SIZE, 3)))
          ).astype(np.float32)


@pytest.mark.parametrize("shards", [2, 4])
def test_xai_fan_out_equals_unsharded(classifier, shards):
    """IG and patch-SHAP over every frame, the Time-SHAP scores, Grad-CAM
    and the fairness probabilities on a mesh of 2 and of 4 (3 frames padded
    with the last) against the analyzer without a mesh, the same draws on
    both sides: rtol=atol=1e-5 of each output's largest magnitude."""
    _xai_fan_out_close(classifier, _mesh(shards))


def test_xai_fan_out_over_two_devices_equals_unsharded(classifier):
    """The fan-out of `test_xai_fan_out_equals_unsharded` over [cpu, cpu:1]:
    the second device's shards score on a classifier replica, at the same
    bounds."""
    from synt_isic_tpu_torch.parallel.replicas import sampling_replica

    _xai_fan_out_close(classifier, create_mesh({"data": 2}, TWO_DEVICES))
    assert sampling_replica(classifier, TWO_DEVICES[1]) is not classifier


def _xai_fan_out_close(classifier, mesh):
    def close(got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-30))

    plain = XAIAnalyzer(classifier, ig_n_steps=4, shap_n_samples=8, batch_size=4, seed=3)
    sharded = XAIAnalyzer(classifier, ig_n_steps=4, shap_n_samples=8, batch_size=4, seed=3,
                          mesh=mesh)
    close(sharded.compute_ig_frames(FRAMES, 2), plain.compute_ig_frames(FRAMES, 2))
    close(sharded.compute_shap_frames(FRAMES, 2, patch_size=4),
          plain.compute_shap_frames(FRAMES, 2, patch_size=4))
    close(sharded.compute_time_shap(FRAMES, [2.0, 1.0, 0.0], 2)[1]["probability_scores"],
          plain.compute_time_shap(FRAMES, [2.0, 1.0, 0.0], 2)[1]["probability_scores"])
    close(compute_gradcam(classifier, FRAMES, 2, output_size=32, mesh=mesh),
          compute_gradcam(classifier, FRAMES, 2, output_size=32))
    images = (np.random.default_rng(1).integers(0, 256, size=(5, SIZE, SIZE, 3))
              .astype(np.uint8))
    close(FairnessAuditor(classifier, batch_size=3, mesh=mesh).probabilities(images),
          FairnessAuditor(classifier, batch_size=3).probabilities(images))


def test_standalone_xai_mesh_devices(ckpt_dir, classifier, tmp_path, monkeypatch):
    """`XAI_MESH_DEVICES=2` with `XAI_DEVICE=cpu` through `main()` against
    the same run without a mesh: the attributions of every frame at
    rtol=atol=1e-5 of their largest magnitude."""
    run = dict(ig_n_steps=2, shap_n_samples=4, n_bootstrap=10, n_permutations=20,
               with_sanity=False, save_figures=False, model_config=TINY, log=lambda *a: None)
    for name, value in (("XAI_TARGET_CLASS", "MEL"), ("XAI_GENERATION_SEED", "11"),
                        ("XAI_INFERENCE_STEPS", "3"), ("XAI_SAVE_EVERY_N", "2"),
                        ("XAI_CHECKPOINTS_DIR", str(ckpt_dir)), ("XAI_DEVICE", "cpu")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(standalone, "run_standalone_xai", functools.partial(
        standalone.run_standalone_xai, **run))
    monkeypatch.setenv("XAI_RESULTS_DIR", str(tmp_path / "plain"))
    assert standalone.main() == 0
    monkeypatch.setenv("XAI_MESH_DEVICES", "2")
    seen = []
    original = standalone.XAIAnalyzer

    def analyzer(*args, **kw):
        seen.append(kw.get("mesh"))
        return original(*args, **kw)

    monkeypatch.setattr(standalone, "XAIAnalyzer", analyzer)
    monkeypatch.setenv("XAI_RESULTS_DIR", str(tmp_path / "mesh"))
    assert standalone.main() == 0
    assert seen[0].shape == {"data": 2}
    (plain_dir,), (mesh_dir,) = ((tmp_path / kind / "MEL").iterdir() for kind in ("plain", "mesh"))
    want = pickle.loads((plain_dir / "full_results.pkl").read_bytes())
    got = pickle.loads((mesh_dir / "full_results.pkl").read_bytes())
    assert set(got["xai_maps"]) == set(want["xai_maps"])
    for step, maps in want["xai_maps"].items():
        for key, value in maps.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_allclose(got["xai_maps"][step][key], value, rtol=1e-5,
                                           atol=1e-5 * max(np.abs(value).max(), 1e-30))
