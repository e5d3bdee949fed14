"""The port's progressive distillation against the JAX package's, on the CPU.

Parameters and images are made with numpy; the JAX draws (student step
indices k and noise eps) are rebuilt from the same key and injected into
the port. Both sides run the tiny UNet in f32 (the JAX side at highest
matmul precision, the port on its fused-attention route, which on the CPU
is the autograd Function over the plain forward and backward), so only the
order of summation differs. Tolerances are stated at each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from synt_isic_tpu.diffusion.schedules import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.io.convert import torch_to_flax
from synt_isic_tpu.io.pth import load_pth
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.train import distill as jax_distill
from synt_isic_tpu.train import train_ddpm as jax_train
from synt_isic_tpu_torch.diffusion.schedules import DiffusionSchedule
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.model_manager import ModelManager
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.train import __main__ as train_main
from synt_isic_tpu_torch.train import distill
from synt_isic_tpu_torch.train.procedural import ProceduralDataset

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params, port_model, tp_mesh

N_STUDENT = 4


@pytest.fixture(scope="module")
def teacher_params():
    return jax_params(seed=0)


@pytest.fixture(scope="module")
def student_params():
    return jax_params(seed=1)


def _batch(seed=0, n=2):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)


def _jax_draws(key, shape, n_student=N_STUDENT):
    """The (k, eps) the JAX loss draws from `key`."""
    k_idx, k_eps = jax.random.split(key)
    k = jax.random.randint(k_idx, (shape[0],), 0, n_student)
    eps = jax.random.normal(k_eps, shape, jnp.float32)
    return torch.from_numpy(np.array(k)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("n_student", [2, 4, 8, 32])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_phase_tables_equal_jax(spacing, n_student):
    """Element for element, in float64: the same numpy on the same
    schedule tables."""
    want = jax_distill.phase_tables(JaxSchedule.create(), n_student, spacing)
    got = distill.phase_tables(DiffusionSchedule.create(), n_student, spacing)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_target_algebra_exact(spacing):
    """One DDIM step with the implied x0 lands on any endpoint, for every
    step of the student grid, in float64 (to 1e-9, as the JAX package's
    `test_target_algebra_exact`)."""
    tab = distill.phase_tables(DiffusionSchedule.create(), 8, spacing)
    rng = np.random.default_rng(0)
    z_t, z_end = rng.normal(size=(2, 8, 5))
    col = {k: tab[k][:, None] for k in ("a_t", "s_t", "a_p", "s_p", "denom")}
    x0 = distill.implied_x0(z_t, z_end, col["a_t"], col["s_t"], col["a_p"], col["s_p"],
                            denom=col["denom"])
    eps = (z_t - col["a_t"] * x0) / col["s_t"]
    np.testing.assert_allclose(col["a_p"] * x0 + col["s_p"] * eps, z_end, atol=1e-9)
    # without the table's denominator, and on tensors
    again = distill.implied_x0(*(torch.from_numpy(z) for z in (z_t, z_end)),
                               *(torch.from_numpy(col[k]) for k in ("a_t", "s_t", "a_p", "s_p")))
    np.testing.assert_allclose(again.numpy(), x0, rtol=1e-12)


def test_loss_and_gradients_match_jax(teacher_params, student_params):
    """The distillation loss to rtol 1e-4, and the student's gradients per
    leaf to 1e-4 * max|g| of that leaf (the key bias's, zero in exact
    arithmetic, to 1e-4 of the largest gradient). The teacher's x0 clip is
    off here and on in the three-step test."""
    cfg_kw = dict(clip_teacher_x0=False)
    jcfg = jax_distill.DistillConfig(**cfg_kw)
    jloss = jax_distill.make_distill_loss(JaxUNet2D(config=TINY_JAX), JaxSchedule.create(),
                                          jcfg, N_STUDENT)
    batch = _batch(1)
    key = jax.random.PRNGKey(7)
    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(
            student_params, teacher_params, jnp.asarray(batch), key)
    want_grads = state_dict_from_jax(jax.device_get(want_grads))

    loss_fn = distill.make_distill_loss(DiffusionSchedule.create(),
                                        distill.DistillConfig(**cfg_kw), N_STUDENT)
    student = port_model(student_params, use_fused_attention=True)
    teacher = port_model(teacher_params, use_fused_attention=True).requires_grad_(False)
    k, eps = _jax_draws(key, batch.shape)
    loss = loss_fn(student, teacher, torch.from_numpy(batch), k=k, eps=eps)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    got = dict(student.named_parameters())
    largest = max(float(w.abs().max()) for w in want_grads.values())
    for name, w in want_grads.items():
        scale = largest if name.endswith("to_k.bias") else float(w.abs().max())
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    assert all(p.grad is None for p in teacher.parameters())


def test_global_norm_clip_is_optax():
    """Both branches of optax.clip_by_global_norm: untouched below the
    limit, scaled to it above (no epsilon), to f32 rounding."""
    rng = np.random.default_rng(3)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    for max_norm in (2 * norm, norm / 3):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        got_norm = distill.clip_by_global_norm_(params, max_norm)
        assert float(got_norm) == pytest.approx(norm, rel=1e-6)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if max_norm > norm:
            assert all(np.array_equal(p.grad.numpy(), g) for p, g in zip(params, grads))


def test_three_distill_steps_match_jax(teacher_params):
    """Three `make_distill_step` steps (global-norm clip that bites, Adam,
    warmup-cosine lr, EMA, the teacher's x0 clipped) from the same student
    = teacher start, the JAX draws injected: losses to rtol 1e-4; parameters and the EMA to 3 * lr
    (Adam's first steps move every weight by about +-lr, so a near-zero
    gradient of opposite sign can differ by 2 * lr)."""
    cfg_kw = dict(learning_rate=1e-3, warmup_steps=1, steps_per_phase=10,
                  ema_decay=0.9, grad_clip=1e-3, batch_size=2, clip_teacher_x0=True)
    jcfg = jax_distill.DistillConfig(**cfg_kw)
    jmodel, jschedule = JaxUNet2D(config=TINY_JAX), JaxSchedule.create()
    lr = jax_train.warmup_cosine_schedule(jcfg.learning_rate, jcfg.warmup_steps,
                                          jcfg.steps_per_phase, jcfg.lr_end_factor)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.grad_clip), optax.adam(lr))
    copy = lambda tree: jax.tree_util.tree_map(jnp.array, tree)  # noqa: E731
    jstate = jax_distill.DistillState(params=copy(teacher_params),
                                      opt_state=tx.init(teacher_params),
                                      step=jnp.zeros((), jnp.int32),
                                      ema_params=copy(teacher_params))
    batches = [_batch(10 + i) for i in range(3)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), i) for i in range(3)]
    with jax.default_matmul_precision("highest"):
        jstep = jax_distill.make_distill_step(jmodel, jschedule, tx, jcfg, N_STUDENT)
        jlosses = []
        for batch, key in zip(batches, keys):
            jstate, loss = jstep(jstate, teacher_params, jnp.asarray(batch), key)
            jlosses.append(float(loss))

    cfg = distill.DistillConfig(**cfg_kw)
    student = port_model(teacher_params, use_fused_attention=True)
    teacher = port_model(teacher_params, use_fused_attention=True).requires_grad_(False)
    state = distill.create_distill_state(student, cfg)
    step = distill.make_distill_step(DiffusionSchedule.create(), cfg, N_STUDENT)
    losses = []
    for batch, key in zip(batches, keys):
        k, eps = _jax_draws(key, batch.shape)
        losses.append(float(step(state, teacher, torch.from_numpy(batch), k=k, eps=eps)))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    assert state.step == 3
    for got, want in ((student.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        want = state_dict_from_jax(jax.device_get(want))
        for name, p in got.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                       atol=3 * cfg.learning_rate, err_msg=name)


def test_progressive_distill_writes_students_both_packages_load(teacher_params, tmp_path):
    """8 -> 2 steps: `distill4` and `distill2` written; each loads in the
    JAX package (`torch_to_flax(load_pth)`, the tree of the tiny UNet, the
    same values) and in the port's `ModelManager(variant=...)`, where the
    2-step student samples 2 trailing DDIM steps."""
    cfg = distill.DistillConfig(batch_size=2, steps_per_phase=2, warmup_steps=1,
                                learning_rate=1e-3)
    model = UNet2D(TINY, use_fused_attention=True)
    teacher = state_dict_from_jax(teacher_params)
    dataset = ProceduralDataset("MEL", 4, image_size=16, seed=0)
    logs = []
    out = distill.progressive_distill(teacher, dataset, "MEL", str(tmp_path), start_steps=8,
                                      end_steps=2, config=cfg, model=model, device="cpu",
                                      log=logs.append)
    assert [p["n_student"] for p in out["phases"]] == [4, 2]
    assert all(np.isfinite(p["final_loss"]) for p in out["phases"])
    assert out["timestep_spacing"] == "trailing"
    assert sum("[distill:4] step 2/2" in line for line in logs) == 1
    shapes = jax.tree_util.tree_map(np.shape, teacher_params)
    for n in (4, 2):
        path = tmp_path / f"unet_MEL_distill{n}.pth"
        tree = torch_to_flax(load_pth(str(path)))
        assert jax.tree_util.tree_map(np.shape, tree) == shapes
        saved = torch.load(path, weights_only=True)
        for name, value in state_dict_from_jax(tree).items():
            assert torch.equal(value, saved[name]), name
    # the students moved away from the teacher
    assert not torch.equal(saved["conv_in.weight"], teacher["conv_in.weight"])

    mm = ModelManager(checkpoints_dir=str(tmp_path), device="cpu", model_config=TINY,
                      variant="distill2")
    assert mm.load_model("MEL")
    images = mm.create_sampler(2, scheduler="ddim", timestep_spacing="trailing").sample(
        mm.loaded_models["MEL"], np.arange(2, dtype=np.uint32))["images"]
    assert images.shape == (2, 16, 16, 3) and bool(torch.isfinite(images).all())


def test_entry_point_distills_on_cpu(tmp_path):
    """`--distill-from` with the {CLASS} rule and the default batch clamped
    to a small dataset, on the full-width UNet at 16x16 (one phase of two
    steps); several classes without {CLASS} refuse; a phase on a
    tensor-parallel mesh is the unsharded phase."""
    torch.manual_seed(0)
    torch.save(UNet2D(UNet2DConfig(sample_size=16)).state_dict(), tmp_path / "unet_MEL_best.pth")
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--procedural", "3", "--image-size", "16",
            "--distill-from", str(tmp_path / "unet_{CLASS}_best.pth"), "--distill-start", "4",
            "--distill-end", "2", "--distill-steps-per-phase", "2", "--checkpoints", str(out)]
    assert train_main.main(["--classes", "MEL", *argv]) == 0
    assert sorted(p.name for p in out.iterdir()) == ["unet_MEL_distill2.pth"]
    assert train_main.main(["--classes", "MEL,NV", "--device", "cpu", "--distill-from",
                            str(tmp_path / "unet_MEL_best.pth")]) == 1
    # tensor parallelism is ported: a phase on a 1 x 2 ('data', 'model')
    # mesh (the state replicated over 'model') is the unsharded phase, the
    # losses to rtol 2e-4 and the weights to 1e-5 (the attention key biases,
    # whose exact gradient is zero, to 3 * lr), the bounds of
    # tests/test_torch_mesh_surfaces.py
    params = jax_params(seed=8)
    cfg = distill.DistillConfig(batch_size=2, bf16_compute=False, steps_per_phase=2,
                                warmup_steps=1)
    runs = [distill.distill_phase(port_model(params), DiffusionSchedule.create(),
                                  port_model(params).state_dict(),
                                  ProceduralDataset("MEL", 2, TINY.sample_size), 2, cfg,
                                  mesh=mesh, log=lambda msg: None)
            for mesh in (tp_mesh(), None)]
    assert runs[0]["history"] == pytest.approx(runs[1]["history"], rel=2e-4)
    for key, want in runs[1]["params"].items():
        atol = 3 * cfg.learning_rate if key.endswith("to_k.bias") else 1e-5
        np.testing.assert_allclose(runs[0]["params"][key].numpy(), want.numpy(), rtol=0,
                                   atol=atol, err_msg=key)
