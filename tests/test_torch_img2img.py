"""img2img and inpainting in the port against the JAX package, on the CPU,
and their generator and CLI surfaces.

The sampler: ddim, stochastic ddpm with a mask, and a conditional guided
case, each through the JAX package's own `img2img` with the noise it
draws, recomputed here (its `initial_noise(seeds)`, the posterior's
`fold_in(key, k + 1)` and the known region's `fold_in(key, S + 1 + k)`) and
injected into the port: final images within 1e-3 (the JAX side at highest
matmul precision), `strength`, `start_index` and `t_start` equal. The
strengths take in Python's half-to-even rounding (0.25 x 10 steps runs 2
steps, 0.35 x 10 runs 4). The generator and the CLI: an augmented image and
its sidecar, `--reproduce` of it byte for byte, and the refusals.
"""
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from synt_isic_tpu.diffusion import DiffusionSampler as JaxSampler
from synt_isic_tpu.diffusion import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.diffusion import SamplerConfig as JaxSamplerConfig
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.cli import reproduce_from_sidecar
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.generator import ImageGenerator

from tests.torch_port_fixtures import (COND_CLASSES, TINY, TINY_COND, TINY_COND_JAX,
                                       TINY_JAX, jax_params, port_model)

STEPS = 10
SIZE = TINY_JAX.sample_size
SHAPE = (SIZE, SIZE, 3)
SEEDS = [3, 4]
NULL = len(COND_CLASSES)


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=3)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


def _init(seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = SHAPE if batch is None else (batch,) + SHAPE
    return np.clip(rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)


def _left_mask():
    """1 (regenerate) on the left half, 0 (keep) on the right."""
    mask = np.zeros((SIZE, SIZE), np.float32)
    mask[:, :SIZE // 2] = 1.0
    return mask


def _port_sampler(scheduler="ddim", conditional=False, **kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                          scheduler=scheduler, **kw),
                            device="cpu", conditional=conditional,
                            null_label=NULL if conditional else None)


def _jax_draws(seeds, stream_ids):
    """(len(stream_ids), B, H, W, C): the JAX sampler's normal draws
    `fold_in(PRNGKey(seed), i)` for each i, as its walk makes them."""
    keys = JaxSampler.keys_for_seeds(seeds)
    return np.stack([np.asarray(jax.vmap(
        lambda key, i=i: jax.random.normal(jax.random.fold_in(key, i), SHAPE,
                                           jnp.float32))(keys)) for i in stream_ids])


CASES = {
    # name: (scheduler, strength, masked, conditional)
    "ddim": ("ddim", 0.25, False, False),
    "ddpm_inpaint": ("ddpm", 0.5, True, False),
    "conditional_guided": ("ddim", 0.35, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_img2img_matches_jax(params, model, case):
    scheduler, strength, masked, conditional = CASES[case]
    if conditional:
        params = jax_params(TINY_COND_JAX, seed=5)
        model = port_model(params, TINY_COND)
        jmodel = JaxUNet2D(config=TINY_COND_JAX)
        apply = lambda p, x, t, y: jmodel.apply({"params": p}, x, t, y)  # noqa: E731
        labels = np.asarray([0, 2])
        kw = {"guidance_scale": 3.0}
    else:
        jmodel = JaxUNet2D(config=TINY_JAX)
        apply = lambda p, x, t: jmodel.apply({"params": p}, x, t)  # noqa: E731
        labels, kw = None, {}
    jsampler = JaxSampler(apply, JaxSchedule.create(),
                          JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                           scheduler=scheduler, **kw),
                          conditional=conditional, null_label=NULL if conditional else None)
    init = _init(1)
    mask = _left_mask() if masked else None
    with jax.default_matmul_precision("highest"):
        want = jsampler.img2img(params, SEEDS, init, strength=strength, mask=mask,
                                class_labels=labels)
    k0 = want["start_index"]
    assert k0 == STEPS - max(1, round(strength * STEPS))
    run = range(k0, STEPS)
    got = _port_sampler(scheduler, conditional, **kw).img2img(
        model, SEEDS, init, strength=strength, mask=mask, class_labels=labels,
        initial_noise=np.array(jsampler.initial_noise(SEEDS)),
        step_noise=_jax_draws(SEEDS, [k + 1 for k in run]) if scheduler == "ddpm" else None,
        inpaint_noise=_jax_draws(SEEDS, [STEPS + 1 + k for k in run]) if masked else None)
    for key in ("strength", "start_index", "t_start"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]),
                               rtol=1e-3, atol=1e-3)
    if masked:
        kept = mask == 0
        np.testing.assert_array_equal(got["images"].numpy()[:, kept],
                                      np.broadcast_to(init, (2,) + SHAPE)[:, kept])


def test_round_half_to_even():
    sampler = _port_sampler()
    for strength, start in ((0.25, 8), (0.35, 6), (0.45, 6), (0.05, 9), (1.0, 0)):
        out = sampler.img2img(lambda x, t: x * 0, [1], _init(), strength=strength)
        assert out["start_index"] == start, strength
        assert out["t_start"] == int(sampler.timesteps[start])


def test_own_noise_streams_and_capture(model):
    """Without injection the port draws from its own streams: results are
    a function of the seeds, the known region is kept, the trajectory holds
    the executed steps only, and a mask of ones equals no mask."""
    sampler = _port_sampler("ddpm")
    init = _init(2)
    a = sampler.img2img(model, SEEDS, init, strength=0.3, mask=_left_mask(),
                        capture_trajectory=True)
    b = sampler.img2img(model, SEEDS, init, strength=0.3, mask=_left_mask())
    np.testing.assert_array_equal(a["images"].numpy(), b["images"].numpy())
    assert a["trajectory"].shape == (3, 2) + SHAPE
    np.testing.assert_array_equal(a["trajectory"][-1].numpy(), a["images"].numpy())
    assert a["noise_hashes"] == _port_sampler().sample(lambda x, t: x, SEEDS)["noise_hashes"]
    ones = sampler.img2img(model, SEEDS, init, strength=0.3, mask=np.ones((SIZE, SIZE)))
    plain = sampler.img2img(model, SEEDS, init, strength=0.3)
    np.testing.assert_array_equal(ones["images"].numpy(), plain["images"].numpy())


def test_refusals(model):
    for scheduler in ("dpm_solver", "dpm_solver_sde", "unipc"):
        with pytest.raises(NotImplementedError):
            _port_sampler(scheduler).img2img(model, [1], _init())
    sampler = _port_sampler()
    for strength in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="strength"):
            sampler.img2img(model, [1], _init(), strength=strength)
    for bad in (np.zeros((SIZE, SIZE + 1)), np.zeros((2, SIZE, SIZE, 2)),
                np.zeros((3, SIZE, SIZE, 1)), np.zeros(SIZE)):
        with pytest.raises(ValueError, match="mask"):
            sampler.img2img(model, [1, 2], _init(), mask=bad)
    for bad in (_init(batch=3), np.zeros((SIZE, SIZE))):
        with pytest.raises(ValueError, match="init_image"):
            sampler.img2img(model, [1, 2], bad)
    with pytest.raises(ValueError, match="class_labels"):
        sampler.img2img(model, [1], _init(), class_labels=0)


# -- the generator and the CLI ---------------------------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory, params):
    path = tmp_path_factory.mktemp("ckpt")
    save_pth(flax_to_torch(params), str(path / "unet_MEL_best.pth"))
    return path


@pytest.fixture
def files(tmp_path):
    """A source PNG from seeded pixels and a mask PNG keeping its right half."""
    src = tmp_path / "src.png"
    pixels = np.random.default_rng(7).integers(0, 256, SHAPE, dtype=np.uint8)
    Image.fromarray(pixels).save(src)
    mask = tmp_path / "mask.png"
    Image.fromarray((_left_mask() * 255).astype(np.uint8)).save(mask)
    return src, mask, pixels


def _gen(ckpt_dir):
    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY, device="cpu")
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(4)
    return gen


def _reproduce(sidecar, ckpt_dir):
    return reproduce_from_sidecar(str(sidecar), str(ckpt_dir), model_config=TINY,
                                  device="cpu")


def test_augment_writes_and_reproduces(tmp_path, ckpt_dir, files, capsys):
    src, mask, pixels = files
    out = tmp_path / "out" / "aug.png"
    out.parent.mkdir()
    ok, traj = _gen(ckpt_dir).augment_single_image("MEL", str(src), str(out), strength=0.5,
                                                   mask=str(mask), seed=11)
    assert ok and traj.shape == (2,) + SHAPE
    meta = json.loads(out.with_suffix(".json").read_text())
    block = meta["img2img"]
    assert block["strength"] == 0.5 and block["postprocess"] is False
    assert block["source"] == "src.png" and block["mask"] == "mask.png"
    assert block["source_path"] == str(src.resolve())
    # 4 leading steps visit 750, 500, 250, 0; strength 0.5 runs the last two
    assert block["t_start"] == 250 and len(block["source_sha256"]) == 64
    assert meta["seed"] == 11 and meta["scheduler"]["kind"] == "ddim"
    written = np.asarray(Image.open(out)).astype(int)
    assert np.abs(written[:, SIZE // 2:] - pixels[:, SIZE // 2:]).max() <= 1
    capsys.readouterr()
    assert _reproduce(out.with_suffix(".json"), ckpt_dir) == 0
    assert "byte-identical" in capsys.readouterr().out
    assert (tmp_path / "out" / "aug_reproduced.png").read_bytes() == out.read_bytes()

    src.write_bytes(src.read_bytes() + b"\0")      # changed since the run
    assert _reproduce(out.with_suffix(".json"), ckpt_dir) == 1
    assert "CHANGED" in capsys.readouterr().err
    src.unlink()
    assert _reproduce(out.with_suffix(".json"), ckpt_dir) == 1
    assert "not found" in capsys.readouterr().err


def test_augment_from_an_array_cannot_reproduce(tmp_path, ckpt_dir, files):
    _, _, pixels = files
    out = tmp_path / "array.png"
    assert _gen(ckpt_dir).augment_single_image("MEL", pixels, str(out), strength=0.3,
                                               seed=2)[0]
    meta = json.loads(out.with_suffix(".json").read_text())
    assert "source" not in meta["img2img"] and "mask_sha256" not in meta["img2img"]
    assert _reproduce(out.with_suffix(".json"), ckpt_dir) == 2
    assert not (tmp_path / "array_reproduced.png").exists()


def test_load_source_and_mask_rules(tmp_path):
    dark = np.ones((4, 4, 3), np.uint8)              # uint8 with every pixel <= 1
    arr, name, _ = ImageGenerator._load_source_image(dark, 4)
    assert name is None and np.allclose(arr, 1 / 127.5 - 1)
    unit = np.full((4, 4, 3), 0.5, np.float32)       # float already in [-1, 1]
    assert np.array_equal(ImageGenerator._load_source_image(unit, 4)[0], unit)
    path = tmp_path / "big.png"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    arr, name, digest = ImageGenerator._load_source_image(str(path), 4)
    assert arr.shape == (4, 4, 3) and name == "big.png"
    assert digest == hashlib.sha256(path.read_bytes()).hexdigest()
    mpath = tmp_path / "m.png"
    Image.fromarray(np.kron([[0, 255], [255, 0]], np.ones((4, 4))).astype(np.uint8)).save(mpath)
    m, mname, _ = ImageGenerator._load_mask(str(mpath), 2)
    assert mname == "m.png" and np.array_equal(m, [[0, 1], [1, 0]])   # NEAREST
    assert ImageGenerator._load_mask(None, 4) == (None, None, None)


def test_cli_augment(tmp_path, ckpt_dir, files, monkeypatch):
    src, mask, pixels = files
    base = ["--checkpoints", str(ckpt_dir), "--augment-source", str(src),
            "--augment-mask", str(mask), "--device", "cpu", "--steps", "4"]
    assert cli.main(base + ["--classes", "MEL", "--scheduler", "unipc"]) == 1
    assert cli.main(base + ["--classes", "MEL", "NV", "--scheduler", "ddim"]) == 1
    assert cli.main(base + ["--scheduler", "ddim"]) == 1
    args = cli.build_parser().parse_args(base + [
        "--classes", "MEL", "--scheduler", "ddim", "--augment-strength", "0.5",
        "--count", "2", "--seed", "4", "--output", str(tmp_path / "aug")])
    assert cli.augment_from_cli(args, model_config=TINY) == 0
    outs = sorted((tmp_path / "aug").glob("src_aug_*.png"))
    assert [p.name for p in outs] == ["src_aug_0000.png", "src_aug_0001.png"]
    seeds = [json.loads(p.with_suffix(".json").read_text())["seed"] for p in outs]
    assert seeds == [4, 5]
    for p in outs:
        kept = np.asarray(Image.open(p)).astype(int)[:, SIZE // 2:]
        assert np.abs(kept - pixels[:, SIZE // 2:]).max() <= 1
    # a class without a checkpoint writes nothing: rc 1
    args.classes = ["NV"]
    assert cli.augment_from_cli(args, model_config=TINY) == 1
