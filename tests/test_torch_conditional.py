"""The port's class-conditional family against the JAX package's, on the
CPU: the classifier-free-guidance sampler, `ModelManager(conditional=True)`,
labelled training (`train_conditional`, `LabeledMixtureDataset`, the
stratified probe), mixed-class `ImageGenerator` blocks, and `--reproduce`
of conditional sidecars.

The tiny conditional UNet (three classes plus the null row) gets its
parameters from numpy in the JAX layout and is carried over by
`state_dict_from_jax`. The JAX side runs its CPU route at highest matmul
precision. Tolerances are stated at each test.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion import DiffusionSampler as JaxSampler
from synt_isic_tpu.diffusion import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.diffusion import SamplerConfig as JaxSamplerConfig
from synt_isic_tpu.diffusion import ddim as jddim
from synt_isic_tpu.diffusion import ddpm as jddpm
from synt_isic_tpu.generator import ImageGenerator as JaxImageGenerator
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.manifest import expected_unet2d_state_shapes as jax_manifest
from synt_isic_tpu.io.manifest import validate_state_dict as jax_validate
from synt_isic_tpu.io.pth import load_pth, save_pth, unwrap_state_dict
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.train import procedural as jax_procedural
from synt_isic_tpu.train.train_conditional import LabeledMixtureDataset as JaxMixture
from synt_isic_tpu.train.train_conditional import write_conditional_metadata as jax_metadata
from synt_isic_tpu.train import train_ddpm as jax_train
from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.model_manager import ModelManager
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.train import __main__ as train_main
from synt_isic_tpu_torch.train import procedural, train_ddpm
from synt_isic_tpu_torch.train.train_conditional import LabeledMixtureDataset, train_conditional

from tests.torch_port_fixtures import (COND_CLASSES, TINY, TINY_COND, TINY_COND_JAX,
                                       jax_params, port_model, tp_mesh)

STEPS = 3
SIZE = TINY_COND.sample_size
NULL = len(COND_CLASSES)
LABELS = np.array([0, 2, 1], np.int32)


@pytest.fixture(scope="module")
def params():
    return jax_params(TINY_COND_JAX, seed=5)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params, TINY_COND)


@pytest.fixture(scope="module")
def jax_apply():
    jmodel = JaxUNet2D(config=TINY_COND_JAX)
    return jax.jit(lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y))


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory, params):
    """A conditional checkpoint as the JAX trainer leaves one: the .pth and
    its metadata JSON."""
    path = tmp_path_factory.mktemp("cond")
    save_pth(flax_to_torch(params), str(path / "unet_conditional_best.pth"))
    jax_metadata(str(path), COND_CLASSES, 0.1)
    return path


def _noise(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_sampler(scheduler="ddim", conditional=True, null_label=NULL, **kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                          scheduler=scheduler, deterministic_posterior=True,
                                          **kw),
                            device="cpu", conditional=conditional, null_label=null_label)


GUIDANCE = [("ddim", {"guidance_scale": 0.0}), ("ddim", {"guidance_scale": 1.0}),
            ("ddim", {"guidance_scale": 3.0}), ("ddpm", {"guidance_scale": 0.0}),
            ("ddpm", {"guidance_scale": 3.0}),
            ("ddim", {"guidance_table": (2.5, 1.0, 4.0, 1.0)})]


@pytest.mark.parametrize("scheduler,guidance", GUIDANCE,
                         ids=[f"{s}-{next(iter(g.values()))}" for s, g in GUIDANCE])
def test_cfg_walk_matches_jax(params, model, jax_apply, scheduler, guidance):
    """The port's conditional walk against the JAX sampler's own predictor
    (`_make_predict`: one 2B-batched forward and the combine when guided)
    stepped by the JAX step functions, on the same injected noise with
    `deterministic_posterior`. Every frame: the first to 1e-4, the last to
    1e-3, as in `tests/test_torch_sampler.py`."""
    noise = _noise((3, SIZE, SIZE, 3))
    jcfg = JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE, scheduler=scheduler,
                            deterministic_posterior=True, **guidance)
    jsampler = JaxSampler(jax_apply, JaxSchedule.create(), jcfg, conditional=True,
                          null_label=NULL)
    predict = jsampler._make_predict()
    step = jddim.ddim_step if scheduler == "ddim" else jddpm.ddpm_step
    x, want = jnp.asarray(noise), []
    with jax.default_matmul_precision("highest"):
        for k in range(STEPS):
            t = jnp.broadcast_to(jsampler.params.timesteps[k], (3,))
            x = step(x, predict(params, x, t, jnp.asarray(LABELS)), k, jsampler.params, None)
            want.append(np.asarray(x))
    out = _port_sampler(scheduler, **guidance).sample(
        model, [0, 1, 2], capture_trajectory=True, initial_noise=noise, class_labels=LABELS)
    got = out["trajectory"].numpy()
    assert got.shape == (STEPS, 3, SIZE, SIZE, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3, atol=1e-3)


def test_guided_ddpm_with_injected_step_noise(params, model, jax_apply):
    """Ancestral DDPM, guided, with the same posterior noise injected on
    both sides (`step_noise=` keeps working with labels); final images to
    1e-3, as the unconditional case in `tests/test_torch_sampler.py`."""
    noise = _noise((3, SIZE, SIZE, 3), seed=4)
    z = _noise((STEPS, 3, SIZE, SIZE, 3), seed=5)
    jsampler = JaxSampler(jax_apply, JaxSchedule.create(),
                          JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                           scheduler="ddpm", guidance_scale=3.0),
                          conditional=True, null_label=NULL)
    predict = jsampler._make_predict()
    x = jnp.asarray(noise)
    with jax.default_matmul_precision("highest"):
        for k in range(STEPS):
            t = jnp.broadcast_to(jsampler.params.timesteps[k], (3,))
            x = jddpm.ddpm_step(x, predict(params, x, t, jnp.asarray(LABELS)), k,
                                jsampler.params, jnp.asarray(z[k]))
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                             scheduler="ddpm", guidance_scale=3.0),
                               device="cpu", conditional=True, null_label=NULL)
    got = sampler.sample(model, [0, 1, 2], initial_noise=noise, step_noise=z,
                         class_labels=LABELS)["images"]
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=1e-3, atol=1e-3)


def test_guided_scan_matches_jax(params, model, jax_apply):
    """The JAX sampler's compiled walk itself (guidance 3, DDIM), final
    images to 1e-3."""
    noise = _noise((3, SIZE, SIZE, 3), seed=1)
    jsampler = JaxSampler(jax_apply, JaxSchedule.create(),
                          JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                           scheduler="ddim", guidance_scale=3.0),
                          conditional=True, null_label=NULL)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsampler.sample(params, [0, 1, 2], initial_noise=jnp.asarray(noise),
                                          class_labels=LABELS)["images"])
    got = _port_sampler(guidance_scale=3.0).sample(model, [0, 1, 2], initial_noise=noise,
                                                   class_labels=LABELS)["images"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_guidance_one_is_close_to_the_plain_forward(model):
    """A table row of 1.0 runs the 2B forward and eps_u + 1 (eps_c - eps_u):
    close to the plain conditional forward (1e-5), not held to bit
    equality. The scalar g = 1 IS the plain forward."""
    noise = _noise((3, SIZE, SIZE, 3), seed=2)
    kw = dict(initial_noise=noise, class_labels=LABELS)
    plain = _port_sampler(guidance_scale=0.0).sample(model, [0, 1, 2], **kw)["images"]
    ones = _port_sampler(guidance_table=(1.0,) * 4).sample(model, [0, 1, 2], **kw)["images"]
    one = _port_sampler(guidance_scale=1.0).sample(model, [0, 1, 2], **kw)["images"]
    torch.testing.assert_close(ones, plain, rtol=1e-5, atol=1e-5)
    assert torch.equal(one, plain)


def test_labels_iff_conditional(model):
    noise = _noise((3, SIZE, SIZE, 3), seed=3)
    with pytest.raises(ValueError, match="requires class_labels"):
        _port_sampler().sample(model, [0, 1, 2], initial_noise=noise)
    with pytest.raises(ValueError, match="unconditional"):
        _port_sampler(conditional=False).sample(model, [0, 1, 2], initial_noise=noise,
                                                class_labels=LABELS)
    for kw in ({"guidance_scale": 3.0}, {"guidance_table": (2.0,) * 4}):
        with pytest.raises(ValueError, match="null_label"):
            _port_sampler(null_label=None, **kw)
    _port_sampler(null_label=None, guidance_scale=1.0)     # unguided: no null row needed
    # a scalar label broadcasts to the batch
    sampler = _port_sampler(guidance_scale=2.0)
    torch.testing.assert_close(
        sampler.sample(model, [0, 1], initial_noise=noise[:2], class_labels=2)["images"],
        sampler.sample(model, [0, 1], initial_noise=noise[:2],
                       class_labels=np.array([2, 2]))["images"], rtol=0, atol=0)
    with pytest.raises(ValueError):
        SamplerConfig(guidance_scale=-1.0)
    with pytest.raises(ValueError):
        SamplerConfig(guidance_table=[1.0, -2.0])
    assert SamplerConfig(guidance_table=[2, 3]).guidance_table == (2.0, 3.0)


def test_model_manager_conditional(tmp_path, ckpt_dir):
    with pytest.raises(FileNotFoundError):
        ModelManager(str(tmp_path), device="cpu", model_config=TINY, conditional=True)
    (tmp_path / "unet_conditional_best.json").write_text(json.dumps({"classes": []}))
    with pytest.raises(ValueError, match="no classes"):
        ModelManager(str(tmp_path), device="cpu", model_config=TINY, conditional=True)

    mm = ModelManager(str(ckpt_dir), device="cpu", model_config=TINY, conditional=True)
    assert mm.config.num_class_embeds == 4 and mm.null_label == NULL
    assert mm.get_available_classes() == list(COND_CLASSES)
    assert [mm.class_id(c) for c in COND_CLASSES] == [0, 1, 2]
    assert mm.checkpoint_path("NV") == ckpt_dir / "unet_conditional_best.pth"
    assert mm.load_model("MEL") and mm.load_model("NV") and not mm.load_model("XXX")
    weight = {c: mm.loaded_models[c].conv_in.weight for c in ("MEL", "NV")}
    assert weight["MEL"].data_ptr() == weight["NV"].data_ptr()   # one resident copy
    assert mm.validate_model("NV")
    sampler = mm.create_sampler(STEPS, scheduler="ddim", guidance_scale=3.0)
    assert sampler.conditional and sampler.null_label == NULL
    assert sampler.config.guidance_scale == 3.0
    assert mm.create_sampler(STEPS, scheduler="ddim", guidance_scale=3.0) is sampler
    table = mm.create_sampler(STEPS, scheduler="ddim", guidance_table=[2, 1, 1, 1])
    assert table is not sampler and table.config.guidance_table == (2.0, 1.0, 1.0, 1.0)
    # the knobs and a device change keep the conditional config and the alias
    mm.set_attention_tuning(heads_per_program=2)
    mm.change_device("cpu")
    assert mm.config.num_class_embeds == 4
    assert mm.loaded_models["MEL"] is mm.loaded_models["NV"]
    assert mm.loaded_models["MEL"].class_embedding.weight.shape[0] == 4
    # an unconditional manager ignores guidance
    plain = ModelManager(str(ckpt_dir), device="cpu", model_config=TINY)
    assert plain.create_sampler(STEPS, guidance_scale=3.0).config.guidance_scale == 0.0


def _jax_labelled_draws(key, shape, p, T=1000):
    """The (t, eps, drop) the JAX step draws from `key` for a labelled batch."""
    k_t, k_eps, _, k_drop = jax.random.split(key, 4)
    t = jax.random.randint(k_t, (shape[0],), 0, T)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    drop = jax.random.bernoulli(k_drop, p, (shape[0],))
    return np.array(t), np.array(eps), np.array(drop)


def test_three_labelled_train_steps_match_jax(params):
    """Three steps of the conditional UNet on an (images, labels) batch, the
    JAX draws of t, eps and the dropout mask injected into the port. Losses
    to rtol 1e-4; parameters to 3 * lr (Adam's first steps move every
    weight by about +-lr, so a near-zero gradient of opposite sign can
    differ by 2 * lr)."""
    cfg_kw = dict(image_size=SIZE, batch_size=3, bf16_compute=False, cond_dropout=0.5)
    jcfg = jax_train.TrainConfig(**cfg_kw)
    jmodel = JaxUNet2D(config=TINY_COND_JAX)
    jstate, tx = jax_train.create_train_state(jmodel, jcfg, params=params)
    images = np.random.default_rng(4).uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jstep = jax_train.make_train_step(jmodel, JaxSchedule.create(), tx, jcfg)
        jlosses, draws = [], []
        for i in range(3):
            key = jax.random.fold_in(jax.random.PRNGKey(1), i)
            draws.append(_jax_labelled_draws(key, images.shape, 0.5))
            jstate, loss = jstep(jstate, (jnp.asarray(images), jnp.asarray(LABELS)), key)
            jlosses.append(float(loss))
    assert any(d[2].any() for d in draws) and not all(d[2].all() for d in draws)

    model = port_model(params, TINY_COND, use_fused_attention=True)
    cfg = train_ddpm.TrainConfig(**cfg_kw)
    state = train_ddpm.create_train_state(model, cfg)
    step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
    batch = (torch.from_numpy(images), torch.from_numpy(LABELS))
    losses = [float(step(state, batch, t=torch.from_numpy(t), eps=torch.from_numpy(e),
                         drop=torch.from_numpy(d))) for t, e, d in draws]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    want = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=3 * cfg.learning_rate, err_msg=name)


class _Lazy:
    """A lazy per-class dataset (`load_raw` in [0, 1]), as SingleClassDataset."""

    def __init__(self, cls, n):
        self.images = None
        self._raw = (procedural.procedural_images(cls, n, SIZE, 0) + 1.0) / 2.0

    def __len__(self):
        return len(self._raw)

    def load_raw(self, i):
        return self._raw[i]


def test_labeled_mixture_matches_jax():
    """Materialized (host and device pools) and lazy mixtures against the
    JAX class: the same pool, labels, batches and epoch gather for the same
    rng (bit for bit: the procedural images and augmentations are the same
    numpy code)."""
    want = JaxMixture(
        {c: jax_procedural.ProceduralDataset(c, 3, SIZE) for c in COND_CLASSES}, SIZE)
    for device in (None, "cpu"):
        got = LabeledMixtureDataset(
            {c: procedural.ProceduralDataset(c, 3, SIZE, device=device)
             for c in COND_CLASSES}, SIZE)
        assert len(got) == len(want) == 9 and hasattr(got, "epoch_batches")
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        for (gi, gl), (wi, wl) in zip(got.batches(2, np.random.default_rng(3)),
                                      want.batches(2, np.random.default_rng(3))):
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
            np.testing.assert_array_equal(gl, wl)
        gi, gl = got.epoch_batches(2, np.random.default_rng(4))
        wi, wl = want.epoch_batches(2, np.random.default_rng(4))
        assert tuple(gi.shape) == (4, 2, SIZE, SIZE, 3)
        np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
        np.testing.assert_array_equal(gl, wl)
    lazy = {c: _Lazy(c, 2) for c in COND_CLASSES}
    got = LabeledMixtureDataset(lazy, SIZE)
    want = JaxMixture(lazy, SIZE)
    assert not hasattr(got, "epoch_batches") and len(got) == 6
    for (gi, gl), (wi, wl) in zip(got.batches(2, np.random.default_rng(5)),
                                  want.batches(2, np.random.default_rng(5))):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError):
        LabeledMixtureDataset({})


def test_probe_labels_are_stratified():
    """A class-concatenated pool is probed at evenly spaced indices (the JAX
    trainer's rule), so every class is in the probe; a lazy labelled set
    gives its batches' labels; an unconditional model gets no labels."""
    mix = LabeledMixtureDataset(
        {c: procedural.ProceduralDataset(c, 4, SIZE) for c in COND_CLASSES}, SIZE)
    cfg = train_ddpm.TrainConfig(image_size=SIZE, eval_probe_images=4, batch_size=2)
    images, labels = train_ddpm._probe(mix, cfg, torch.device("cpu"), conditional=True)
    idx = np.unique(np.linspace(0, 11, 4).astype(np.int64))
    np.testing.assert_array_equal(labels.numpy(), mix.labels[idx])
    assert set(labels.tolist()) == {0, 1, 2}
    np.testing.assert_array_equal(images.numpy(), mix.images[idx])
    prefix, none = train_ddpm._probe(mix, cfg, torch.device("cpu"))
    assert none is None
    np.testing.assert_array_equal(prefix.numpy(), mix.images[:4])
    lazy = LabeledMixtureDataset({c: _Lazy(c, 2) for c in COND_CLASSES},
                                                   SIZE)
    images, labels = train_ddpm._probe(lazy, cfg, torch.device("cpu"), conditional=True)
    first = [b for _, b in zip(range(2), lazy.batches(2, np.random.default_rng(cfg.seed + 1)))]
    np.testing.assert_array_equal(labels.numpy(), np.concatenate([lab for _, lab in first]))
    assert images.shape == (4, SIZE, SIZE, 3)


def test_train_conditional_end_to_end(params, tmp_path):
    """`train_conditional` on the CPU with the tiny conditional model: the
    metadata JSON has the JAX key set and values; the checkpoint is read
    by the JAX `load_pth` and passes the JAX manifest with
    `num_class_embeds`; colour statistics land under each class; the
    probe-based best selection runs; `ModelManager(conditional=True)`
    loads the result; the same run on a tensor-parallel mesh gives the
    same checkpoint."""
    datasets = {c: procedural.ProceduralDataset(c, 2, SIZE) for c in COND_CLASSES}
    cfg = train_ddpm.TrainConfig(image_size=SIZE, batch_size=2, epochs=1, eval_every=1,
                                 eval_probe_images=3, eval_t_points=2, bf16_compute=False)
    out = train_conditional(
        datasets, str(tmp_path), cfg, model=port_model(params, TINY_COND),
        device="cpu", log=lambda msg: None)
    assert out["classes"] == list(COND_CLASSES) and out["num_class_embeds"] == 4
    assert out["steps"] == 3 and np.isfinite(out["best_val"])
    meta = json.loads((tmp_path / "unet_conditional_best.json").read_text())
    jax_metadata(str(tmp_path / "jax"), COND_CLASSES,
                                               cfg.cond_dropout)
    assert meta == json.loads((tmp_path / "jax" / "unet_conditional_best.json").read_text())
    state = unwrap_state_dict(load_pth(str(tmp_path / "unet_conditional_best.pth")))
    assert not jax_validate(state, jax_manifest(**dataclasses.asdict(TINY_COND_JAX)))
    assert state["class_embedding.weight"].shape[0] == 4
    stats = json.loads((tmp_path / "color_statistics.json").read_text())
    assert set(COND_CLASSES) <= set(stats)
    mm = ModelManager(str(tmp_path), device="cpu", model_config=TINY, conditional=True)
    assert mm.load_model("VASC")
    with pytest.raises(ValueError, match="num_class_embeds"):   # 1 class + null != 4
        train_conditional({"MEL": datasets["MEL"]}, str(tmp_path), cfg,
                                            model=UNet2D(TINY_COND), device="cpu")
    # tensor parallelism is ported: on a 1 x 2 ('data', 'model') mesh the
    # state is replicated over 'model', so the run is the unsharded one
    # (weights within 1e-5, the attention key biases, whose exact gradient
    # is zero, within 3 * lr: tests/test_torch_mesh_surfaces.py)
    tp_out = train_conditional(datasets, str(tmp_path / "tp"), cfg,
                               model=port_model(params, TINY_COND), mesh=tp_mesh(),
                               device="cpu", log=lambda msg: None)
    assert tp_out["steps"] == out["steps"]
    assert tp_out["best_val"] == pytest.approx(out["best_val"], rel=1e-5)
    tp_state = unwrap_state_dict(load_pth(str(tmp_path / "tp" / "unet_conditional_best.pth")))
    for key, want in state.items():
        atol = 3 * cfg.learning_rate if key.endswith("to_k.bias") else 1e-5
        np.testing.assert_allclose(np.asarray(tp_state[key]), np.asarray(want), rtol=0,
                                   atol=atol, err_msg=key)


def test_entry_point_conditional(tmp_path, capsys):
    """`train --conditional` (classes comma-separated) on the CPU: the
    full-width UNet at 16x16 for one epoch writes the conditional checkpoint
    and its metadata."""
    rc = train_main.main(["--conditional", "--classes", "MEL,NV", "--device", "cpu",
                          "--procedural", "2", "--image-size", "16", "--batch", "2",
                          "--epochs", "1", "--checkpoints", str(tmp_path)])
    assert rc == 0 and "conditional done" in capsys.readouterr().out
    assert (tmp_path / "unet_conditional_best.pth").exists()
    meta = json.loads((tmp_path / "unet_conditional_best.json").read_text())
    assert meta["classes"] == ["MEL", "NV"] and meta["num_class_embeds"] == 3


def _gen(ckpt_dir, **kw) -> ImageGenerator:
    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY, device="cpu",
                         conditional=True, **kw)
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(2)
    gen.set_generation_seed(7)
    return gen


@pytest.mark.parametrize("scale,gmap", [(0.0, None), (3.0, None), (0.0, {"MEL": 2.5}),
                                         (3.0, {"MEL": 2.5, "NV": 0.5}),
                                         (1.0, {"MEL": 1.0})])
def test_guidance_table_matches_jax(ckpt_dir, scale, gmap):
    got = _gen(ckpt_dir, guidance_scale=scale, guidance_map=gmap)._guidance_table()
    want = JaxImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY_COND_JAX,
                             conditional=True, guidance_scale=scale,
                             guidance_map=gmap)._guidance_table()
    assert got == want


def test_mixed_block_equals_per_class_runs(ckpt_dir):
    """A block spanning classes gives each image what a one-class block of
    the same seeds gives it (per-class guidance included), to 1e-5: only
    the batch size, and with it the convolution's order of summation,
    differs."""
    gen = _gen(ckpt_dir, guidance_scale=3.0, guidance_map={"MEL": 2.5, "NV": 1.0})
    classes = ["MEL", "NV", "VASC", "MEL"]
    seeds = np.array([11, 12, 13, 14], np.uint32)
    mixed = gen._sample_block(classes, seeds, False)["images"]
    for cls in COND_CLASSES:
        idx = [i for i, c in enumerate(classes) if c == cls]
        alone = gen._sample_block([cls] * len(idx), seeds[idx], False)["images"]
        torch.testing.assert_close(mixed[idx], alone, rtol=1e-5, atol=1e-5)
    unconditional = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY,
                                   device="cpu")
    with pytest.raises(ValueError, match="conditional"):
        unconditional._sample_block(["MEL", "NV"], seeds[:2], False)


def test_mixed_blocks_seed_index_and_dead_class(ckpt_dir, tmp_path):
    """Blocks span classes; the seed index continues over duplicate entries
    (no seed is handed out twice); an unknown class is dropped without its
    block-mates; sidecars carry the conditional fields and the block's
    classes."""
    gen = _gen(ckpt_dir, guidance_scale=3.0, guidance_map={"MEL": 2.5, "NV": 1.0})
    gen.batch_size = 4
    result = gen.generate_images([("MEL", 2), ("XXX", 1), ("NV", 2), ("MEL", 2),
                                  ("VASC", 1)], str(tmp_path / "run"))
    assert result["generated"] == 7
    metas = {p.relative_to(tmp_path / "run").as_posix(): json.loads(p.read_text())
             for p in sorted((tmp_path / "run").rglob("ISIC_*.json"))}
    assert sorted(metas) == [f"MEL/ISIC_000000{i}.json" for i in (1, 2, 3, 4)] + [
        "NV/ISIC_0000001.json", "NV/ISIC_0000002.json", "VASC/ISIC_0000001.json"]
    mel = [m["seed"] for k, m in metas.items() if k.startswith("MEL")]
    assert mel == [mel[0] + i for i in range(4)]
    for key, meta in metas.items():
        sched = meta["scheduler"]
        cls = key.split("/")[0]
        assert sched["conditional"] is True
        assert sched["guidance_scale"] == {"MEL": 2.5, "NV": 1.0}.get(cls, 3.0)
        assert sched["guidance_map"] == {"MEL": 2.5, "NV": 1.0}
        assert sched["guidance_default"] == 3.0
    spanning = [m["block"] for m in metas.values()
                if m.get("block") and len(set(m["block"]["classes"])) > 1]
    assert spanning and all(len(b["seeds"]) == len(b["classes"]) for b in spanning)
    rows = (tmp_path / "run" / "synthetic_dataset.csv").read_text().splitlines()[1:]
    assert len(rows) == 7


def test_conditional_reproduce_is_byte_identical(ckpt_dir, tmp_path):
    """`--reproduce` of conditional sidecars on the CPU: an image of a mixed
    block with a guidance map (the whole block rebuilt), a single image,
    and a console JPEG, each byte-identical to its original."""
    gen = _gen(ckpt_dir, guidance_scale=3.0, guidance_map={"MEL": 2.5, "NV": 1.0})
    gen.batch_size = 3
    assert gen.generate_images([("MEL", 2), ("NV", 2), ("VASC", 2)],
                               str(tmp_path / "run"))["generated"] == 6
    sidecar = tmp_path / "run" / "VASC" / "ISIC_0000001.json"
    assert len(set(json.loads(sidecar.read_text())["block"]["classes"])) > 1
    kw = dict(model_config=TINY, device="cpu")
    assert cli.reproduce_from_sidecar(str(sidecar), str(ckpt_dir), **kw) == 0
    single = _gen(ckpt_dir, guidance_scale=2.0)
    assert single.generate_single_image("NV", str(tmp_path / "one.png"), seed=9)[0]
    assert cli.reproduce_from_sidecar(str(tmp_path / "one.json"), str(ckpt_dir), **kw) == 0

    console = cli.ConsoleGenerator(base_dir=str(tmp_path / "console"),
                                   checkpoints_dir=str(ckpt_dir), inference_steps=2,
                                   batch_size=2, scheduler="ddim", seed=0,
                                   model_config=TINY, device="cpu", conditional=True,
                                   guidance_scale=3.0, guidance_map={"NV": 1.5})
    assert console.generate({"NV": 2, "VASC": 1}) == {"NV": 2, "VASC": 1}
    jpegs = sorted((tmp_path / "console" / "ISIC2018_Task3_synt").glob("*.json"))
    metas = [json.loads(p.read_text()) for p in jpegs]
    assert [m["scheduler"]["guidance_scale"] for m in metas] == [1.5, 1.5, 3.0]
    for path in (jpegs[1], jpegs[2]):
        assert cli.reproduce_from_sidecar(str(path), str(ckpt_dir), **kw) == 0


def test_reproduce_rebuilds_the_guidance_table(ckpt_dir, tmp_path, monkeypatch):
    """With a map whose row for the image's class is 1 (no guidance), the
    table still guides the classes absent from the map at the generator's
    scalar. The sidecar records that scalar beside the map, so the
    regeneration rebuilds the same table (the JAX contract records only the
    class's own weight, which would collapse the table to the single-forward
    path: ROADMAP C5)."""
    gen = _gen(ckpt_dir, guidance_scale=3.0, guidance_map={"MEL": 1.0})
    gen.batch_size = 2
    assert gen.generate_images([("MEL", 1), ("NV", 1)], str(tmp_path / "run"))["generated"] == 2
    sidecar = tmp_path / "run" / "MEL" / "ISIC_0000001.json"
    sched = json.loads(sidecar.read_text())["scheduler"]
    assert sched["guidance_scale"] == 1.0 and sched["guidance_default"] == 3.0
    built = []
    init = ImageGenerator.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)
    monkeypatch.setattr(ImageGenerator, "__init__", spy)
    assert cli.reproduce_from_sidecar(str(sidecar), str(ckpt_dir), model_config=TINY,
                                      device="cpu") == 0
    assert built[-1]._guidance_table() == gen._guidance_table() == (1.0, 3.0, 3.0, 3.0)


def test_cli_parser_takes_the_conditional_flags():
    args = cli.build_parser().parse_args(["--conditional", "--guidance-scale", "2.5",
                                          "--guidance-map", "MEL=3,NV=1"])
    assert args.conditional and args.guidance_scale == 2.5
    assert args.guidance_map == "MEL=3,NV=1"
