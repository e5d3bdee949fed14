"""The port's training path against the JAX package's, on the CPU.

Inputs, parameters and noise are made with numpy (or drawn by JAX and
injected into the port) and go through both packages. The JAX side runs its
own CPU route (einsum attention) at highest matmul precision; the port's
UNet takes the fused-attention route, which on the CPU is the autograd
Function over the plain forward and backward. Tolerances are stated at each
test.
"""
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.io.convert import torch_to_flax
from synt_isic_tpu.io.pth import load_pth
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.train import data as jax_data
from synt_isic_tpu.train import procedural as jax_procedural
from synt_isic_tpu.train import train_ddpm as jax_train
from synt_isic_tpu_torch.diffusion.schedules import DiffusionSchedule
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.io.pth import load_checkpoint
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.parallel.mesh import create_mesh
from synt_isic_tpu_torch.train import __main__ as train_main
from synt_isic_tpu_torch.train import data, procedural, train_ddpm
from synt_isic_tpu_torch.train.async_ckpt import AsyncCheckpointer

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params, nchw, port_model, tp_mesh

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def params():
    return jax_params()


def _batch(seed=0, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)


def _jax_draws(key, shape, T=1000):
    """The (t, eps) the JAX step draws from `key` (unconditional branch)."""
    k_t, k_eps, _ = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (shape[0],), 0, T)
    return np.array(t), np.array(jax.random.normal(k_eps, shape, jnp.float32))


def test_unet_grads_match_jax(params):
    """Per-leaf gradients of the training loss through the port's fused
    attention route against jax.grad of the JAX einsum model, same
    parameters, f32 on both sides: only the order of summation differs, so
    1e-4 * max|g| per leaf. The key bias's gradient is zero in exact
    arithmetic (softmax ignores a shift shared by every key), so both sides
    give rounding noise there: it is held to 1e-4 of the largest gradient."""
    x, eps = _batch(1), _batch(2)
    t = np.array([10, 700])
    jmodel = JaxUNet2D(config=TINY_JAX)

    def loss(p):
        pred = jmodel.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean((pred - jnp.asarray(eps)) ** 2)

    with jax.default_matmul_precision("highest"):
        want = state_dict_from_jax(jax.device_get(jax.jit(jax.grad(loss))(params)))
    model = port_model(params, use_fused_attention=True)
    pred = model(nchw(x), torch.from_numpy(t))
    torch.mean((pred - nchw(eps)) ** 2).backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        scale = largest if name.endswith("to_k.bias") else float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


def test_three_train_steps_match_jax(params):
    """Three `make_train_step` steps from the same parameters on both sides,
    the JAX draws of t and eps injected into the port. Losses to rtol 1e-4;
    parameters to 3 * lr: Adam's first steps move every weight by about
    +-lr, so a near-zero gradient of opposite sign can differ by 2 * lr."""
    cfg_kw = dict(image_size=16, batch_size=2, bf16_compute=False)
    jcfg = jax_train.TrainConfig(**cfg_kw)
    jmodel = JaxUNet2D(config=TINY_JAX)
    jstate, tx = jax_train.create_train_state(jmodel, jcfg, params=params)
    batch = _batch(3)
    with jax.default_matmul_precision("highest"):
        jstep = jax_train.make_train_step(jmodel, JaxSchedule.create(), tx, jcfg)
        jlosses, draws = [], []
        for i in range(3):
            key = jax.random.fold_in(jax.random.PRNGKey(0), i)
            draws.append(_jax_draws(key, batch.shape))
            jstate, loss = jstep(jstate, jnp.asarray(batch), key)
            jlosses.append(float(loss))

    model = port_model(params, use_fused_attention=True)
    cfg = train_ddpm.TrainConfig(**cfg_kw)
    state = train_ddpm.create_train_state(model, cfg)
    step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
    losses = [float(step(state, torch.from_numpy(batch), t=torch.from_numpy(t),
                         eps=torch.from_numpy(e))) for t, e in draws]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == 3
    want = state_dict_from_jax(jax.device_get(jstate.params))
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=3 * cfg.learning_rate, err_msg=name)


def test_bf16_compute_keeps_f32_parameters():
    """`param_dtype=f32, dtype=bf16`: the weights stay f32 after a step, and
    an update far below the bf16 ulp of the weights still changes them. The
    default (`param_dtype=dtype`) keeps the sampling model's bf16 weights."""
    sampling = UNet2D(TINY, dtype=torch.bfloat16)
    assert sampling.conv_in.weight.dtype == torch.bfloat16
    torch.manual_seed(0)
    model = UNet2D(TINY, dtype=torch.bfloat16, param_dtype=torch.float32,
                   use_fused_attention=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = train_ddpm.TrainConfig(image_size=16, batch_size=2, learning_rate=1e-6)
    state = train_ddpm.create_train_state(model, cfg)
    step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
    loss = step(state, torch.from_numpy(_batch(4)), torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    w0, w1 = before["conv_in.weight"], model.conv_in.weight.detach()
    assert w1.dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    step_size = (w1 - w0).abs()
    assert step_size.max() <= 2 * cfg.learning_rate     # Adam's first step: ~lr
    # updates below half a bf16 ulp of the weight (lost if it were stored in
    # bf16) are most of them, and f32 storage keeps every one
    below = step_size < w0.abs() * 2.0 ** -9
    assert below.float().mean() > 0.9
    assert (w1[below] != w0[below]).all()


def test_train_class_checkpoint_read_by_jax_and_resume(params, tmp_path):
    """`train_class` on the CPU with the tiny model: it writes
    unet_<C>_best.pth, which the JAX package's load_pth + torch_to_flax
    reads into the same UNet output as the port's (f32, 1e-4); resuming
    after the last epoch runs no epoch and keeps best_loss; resuming with
    one more epoch runs exactly that one."""
    ds = procedural.ProceduralDataset("MEL", 4, image_size=16, seed=0)
    cfg = train_ddpm.TrainConfig(image_size=16, batch_size=2, epochs=2,
                                 bf16_compute=False)
    kw = dict(config=cfg, device="cpu", log=lambda msg: None)
    out = train_ddpm.train_class("MEL", ds, str(tmp_path),
                                 model=port_model(params, use_fused_attention=True), **kw)
    best = tmp_path / "unet_MEL_best.pth"
    assert best.exists() and (tmp_path / "train_state_MEL.pt").exists()
    assert len(out["history"]) == 2 and out["steps"] == 4
    assert out["best_loss"] == min(out["history"])

    x, t = _batch(5), np.array([3, 600])
    jtree = torch_to_flax(load_pth(str(best)))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(JaxUNet2D(config=TINY_JAX).apply)(
            {"params": jtree}, jnp.asarray(x), jnp.asarray(t)))
    model = UNet2D(TINY)
    model.load_state_dict(load_checkpoint(str(best)), strict=True)
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    written = best.read_bytes()
    again = train_ddpm.train_class("MEL", ds, str(tmp_path), model=UNet2D(TINY),
                                   resume=True, **kw)
    assert again["history"] == [] and again["steps"] == 4
    assert again["best_loss"] == out["best_loss"]
    assert best.read_bytes() == written

    cfg3 = train_ddpm.TrainConfig(image_size=16, batch_size=2, epochs=3,
                                  bf16_compute=False)
    more = train_ddpm.train_class("MEL", ds, str(tmp_path), model=UNet2D(TINY),
                                  resume=True, config=cfg3, device="cpu",
                                  log=lambda msg: None)
    assert len(more["history"]) == 1 and more["steps"] == 6


def test_train_class_with_ema_and_eval_probe(params, tmp_path):
    """EMA export and probe-based best selection: the best checkpoint holds
    the EMA weights of the epoch whose probe loss was lowest."""
    ds = procedural.ProceduralDataset("NV", 4, image_size=16, seed=0)
    cfg = train_ddpm.TrainConfig(image_size=16, batch_size=2, epochs=2,
                                 bf16_compute=False, ema_decay=0.9, eval_every=1,
                                 eval_probe_images=2, eval_t_points=2, snapshot_every=1)
    out = train_ddpm.train_class("NV", ds, str(tmp_path),
                                 model=port_model(params, use_fused_attention=True),
                                 config=cfg, device="cpu", log=lambda msg: None)
    assert np.isfinite(out["best_val"]) and out["steps"] == 4
    for name in ("unet_NV_best.pth", "unet_NV_epoch1.pth", "unet_NV_epoch2.pth"):
        assert (tmp_path / name).exists(), name
    assert "NV" in (tmp_path / "color_statistics.json").read_text()


@pytest.mark.parametrize("kw,total", [
    (dict(), None),
    (dict(warmup_steps=4), None),
    (dict(lr_schedule="cosine", warmup_steps=3), 40),
    (dict(lr_schedule="cosine", warmup_steps=0, lr_end_factor=0.1), 25),
])
def test_lr_schedules_match_optax(kw, total):
    jax_fn = jax_train.make_lr_schedule(jax_train.TrainConfig(**kw), total)
    fn = train_ddpm.make_lr_schedule(train_ddpm.TrainConfig(**kw), total)
    for count in range(0, 45):
        want = float(jax_fn(count)) if callable(jax_fn) else jax_fn
        assert fn(count) == pytest.approx(want, rel=1e-6, abs=1e-12), count


def test_ema_update_matches_jax():
    rng = np.random.default_rng(6)
    e, p = rng.normal(size=(2, 5)).astype(np.float32)
    for step in (0, 3, 1000):
        want = jax_train.ema_update({"w": jnp.asarray(e)}, {"w": jnp.asarray(p)},
                                    jnp.int32(step), 0.999)["w"]
        ema = {"w": torch.from_numpy(e.copy())}
        train_ddpm.ema_update(ema, {"w": torch.from_numpy(p)}, step, 0.999)
        np.testing.assert_allclose(ema["w"].numpy(), np.asarray(want), rtol=1e-6)


def test_eval_fn_is_deterministic(params):
    model = port_model(params, use_fused_attention=True)
    cfg = train_ddpm.TrainConfig(image_size=16, eval_t_points=3)
    fn = train_ddpm.make_eval_fn(model, DiffusionSchedule.create(), cfg,
                                 torch.from_numpy(_batch(7)))
    first = fn(model.state_dict())
    assert np.isfinite(first) and fn(model.state_dict()) == first


@pytest.mark.parametrize("name,index,hard", [("MEL", 0, 0.0), ("VASC", 7, 0.0),
                                             ("NV", 3, 0.4), ("XYZ", 1, 0.0)])
def test_procedural_image_identical_to_jax(name, index, hard):
    np.testing.assert_array_equal(
        procedural.procedural_image(name, index, 32, seed=2, hard=hard),
        jax_procedural.procedural_image(name, index, 32, seed=2, hard=hard))


def test_procedural_batches_draw_the_jax_order():
    mine = procedural.ProceduralDataset("NV", 6, image_size=16, seed=1,
                                        device=torch.device("cpu"))
    ref = jax_procedural.ProceduralDataset("NV", 6, image_size=16, seed=1)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for got, want in zip(mine.batches(2, a), ref.batches(2, b)):
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(mine.epoch_batches(2, a).numpy(),
                                  np.asarray(ref.epoch_batches(2, b)))


def test_augment_and_enhance_identical_to_jax():
    img = np.random.default_rng(8).uniform(0, 1, (24, 24, 3)).astype(np.float32)
    np.testing.assert_array_equal(data.enhance_color(img, 1),
                                  jax_data.enhance_color(img, 1))
    np.testing.assert_array_equal(
        data.augment_image(img, np.random.default_rng(9), 16),
        jax_data.augment_image(img, np.random.default_rng(9), 16))


def test_async_checkpointer_fifo_coalesce_snapshot_and_errors():
    gate = threading.Event()
    written = []

    def write(tree, path):
        if path == "hold":
            assert gate.wait(timeout=10)
        written.append((path, tree["w"].clone()))

    w = torch.zeros(3)
    ckpt = AsyncCheckpointer(max_pending=8)
    ckpt.submit({"w": w}, write, "hold")           # the worker blocks on it
    ckpt.submit({"w": w}, write, "epoch1")
    w.add_(1.0)                                     # in place, after submit
    ckpt.submit({"w": w}, write, "best-a", coalesce="best")
    ckpt.submit({"w": w + 1}, write, "best-b", coalesce="best")   # drops best-a
    ckpt.submit({"w": w}, write, "epoch2")
    gate.set()
    ckpt.wait()
    assert [p for p, _ in written] == ["hold", "epoch1", "best-b", "epoch2"]
    assert written[1][1].tolist() == [0.0, 0.0, 0.0]   # the value at submit
    assert written[2][1].tolist() == [2.0, 2.0, 2.0]

    def broken(tree, path):
        raise OSError("disk full")

    ckpt.submit({"w": w}, broken, "x")
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    ckpt.close()
    with pytest.raises(RuntimeError):
        ckpt.submit({"w": w}, write, "late")


def test_entry_point_on_cpu(tmp_path):
    """`python -m synt_isic_tpu_torch.train --device cpu` trains the
    full-width UNet (at 32x32) for one epoch and exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "synt_isic_tpu_torch.train", "--device", "cpu",
         "--procedural", "4", "--epochs", "1", "--image-size", "32", "--batch", "2",
         "--classes", "MEL", "--checkpoints", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "unet_MEL_best.pth").exists()
    assert "MEL done" in proc.stdout


def test_entry_point_refuses_what_it_cannot_do(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA default where CUDA is absent")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main.main(["--classes", "MEL", "--procedural", "4",
                         "--checkpoints", str(tmp_path)])
    # data-parallel training is ported (tests/test_torch_mesh_surfaces.py):
    # a global batch that does not divide by the mesh, and tensor
    # parallelism, are refused
    two = create_mesh({"data": 2}, [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        train_ddpm.train_class("MEL", procedural.ProceduralDataset("MEL", 2, 16),
                               str(tmp_path), train_ddpm.TrainConfig(batch_size=3),
                               mesh=two, device="cpu")
    # tensor parallelism is ported: on a 1 x 2 ('data', 'model') mesh the
    # state is replicated over 'model', so the epoch is the unsharded one
    # (weights within 1e-5, the attention key biases, whose exact gradient
    # is zero, within 3 * lr: tests/test_torch_mesh_surfaces.py)
    cfg = train_ddpm.TrainConfig(image_size=16, batch_size=2, epochs=1, bf16_compute=False)
    saved = {}
    for name, mesh in (("tp", tp_mesh()), ("plain", None)):
        out = train_ddpm.train_class("MEL", procedural.ProceduralDataset("MEL", 2, 16),
                                     str(tmp_path / name), cfg,
                                     model=port_model(jax_params(seed=6)), mesh=mesh,
                                     device="cpu", log=lambda msg: None)
        saved[name] = (out, load_checkpoint(str(tmp_path / name / "unet_MEL_best.pth")))
    assert saved["tp"][0]["history"] == pytest.approx(saved["plain"][0]["history"], rel=1e-6)
    for key, want in saved["plain"][1].items():
        atol = 3 * cfg.learning_rate if key.endswith("to_k.bias") else 1e-5
        np.testing.assert_allclose(saved["tp"][1][key].numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=key)
