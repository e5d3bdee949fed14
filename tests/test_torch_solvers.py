"""The port's multistep solvers (DPM-Solver++(2M) ODE and SDE, UniPC) and
their sampler families against the JAX package's, on the CPU.

Tables at f32 rtol 1e-7 (timesteps exact) over S in {1, 2, 3, 10, 50} at
both spacings, which takes in the S <= 2 edge rules; single steps on
seeded inputs at rtol = atol = 1e-6; golden chains through both samplers
with the carried-over tiny UNet and the same injected initial noise, 5
steps, batch 2, every frame captured, first frame within 1e-4 and last
within 1e-3 (the tolerances of `test_torch_sampler.py`), the JAX side at
highest matmul precision. The SDE also runs stochastically in the JAX
package with the noise it draws itself, recomputed here from
`fold_in(PRNGKey(seed), k + 1)` and injected into the port, which holds the
mapping of the noise streams onto the steps as well as the arithmetic.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion import DiffusionSampler as JaxSampler
from synt_isic_tpu.diffusion import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.diffusion import SamplerConfig as JaxSamplerConfig
from synt_isic_tpu.diffusion import dpm as jdpm
from synt_isic_tpu.diffusion import unipc as junipc
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu_torch.diffusion import (DiffusionSampler, DiffusionSchedule,
                                           DPMSolverParams, SamplerConfig, UniPCParams,
                                           dpm_solver_step, unipc_step)
from synt_isic_tpu_torch.diffusion.sampler import save_indices

from tests.torch_port_fixtures import TINY_JAX, jax_params, port_model

STEPS = 5
SIZE = TINY_JAX.sample_size
SEEDS = [5, 6]
MULTISTEP = ["dpm_solver", "dpm_solver_sde", "unipc"]


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=3)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


@pytest.fixture(scope="module")
def jax_apply():
    """The JAX UNet's apply, jitted once for the module."""
    jmodel = JaxUNet2D(config=TINY_JAX)
    return jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))


def _noise(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_sampler(scheduler, steps=STEPS, **kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=steps, image_size=SIZE,
                                          scheduler=scheduler, **kw),
                            device="cpu")


def _tables(kind, steps, spacing):
    """(port params, JAX params) of one solver kind."""
    if kind == "unipc":
        return (UniPCParams.create(DiffusionSchedule.create(), steps,
                                   timestep_spacing=spacing, device="cpu"),
                junipc.UniPCParams.create(JaxSchedule.create(), steps,
                                          timestep_spacing=spacing))
    sde = kind == "dpm_solver_sde"
    return (DPMSolverParams.create(DiffusionSchedule.create(), steps,
                                   timestep_spacing=spacing, sde=sde, device="cpu"),
            jdpm.DPMSolverParams.create(JaxSchedule.create(), steps,
                                        timestep_spacing=spacing, sde=sde))


TABLES = {"dpm": ("inv_alpha", "sigma", "sample_coeff", "d_coeff", "c2", "noise_coeff"),
          "unipc": ("inv_alpha", "sigma", "c_pass", "c_xt", "c_d0", "c_d1",
                    "p_xt", "p_d0", "p_d1")}


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("steps", [1, 2, 3, 10, 50])
@pytest.mark.parametrize("kind", MULTISTEP)
def test_tables_match_jax(kind, steps, spacing):
    mine, ref = _tables(kind, steps, spacing)
    np.testing.assert_array_equal(mine.timesteps.numpy(), np.asarray(ref.timesteps))
    for name in TABLES["unipc" if kind == "unipc" else "dpm"]:
        got = getattr(mine, name)
        assert got.dtype == torch.float32 and got.shape == (steps,), name
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-7, atol=0, err_msg=name)
    assert mine.stochastic == (kind == "dpm_solver_sde")
    assert mine.clip_sample == ref.clip_sample


def test_table_edges():
    """The edge rules themselves: no history term at the first and final
    step, h = inf at the final step (sample coefficient 0, x0 weight 1), no
    SDE noise at the final step, UniPC's corrector passing through at k = 0."""
    for spacing in ("leading", "trailing"):
        ode, _ = _tables("dpm_solver", 10, spacing)
        sde, _ = _tables("dpm_solver_sde", 10, spacing)
        uni, _ = _tables("unipc", 10, spacing)
        for p in (ode, sde):
            assert p.c2[0] == 0 and p.c2[-1] == 0 and bool((p.c2[1:-1] > 0).all())
            assert p.sample_coeff[-1] == 0 and p.d_coeff[-1] == 1
        assert bool((ode.noise_coeff == 0).all()) and sde.noise_coeff[-1] == 0
        assert bool((sde.noise_coeff[:-1] > 0).all())
        assert uni.c_pass[0] == 1 and bool((uni.c_pass[1:] == 0).all())
        assert uni.p_d1[0] == 0 and uni.p_d1[-1] == 0 and uni.p_xt[-1] == 0
    for steps in (1, 2):
        assert bool((_tables("dpm_solver", steps, "trailing")[0].c2 == 0).all())
        assert bool((_tables("unipc", steps, "trailing")[0].p_d1 == 0).all())


@pytest.mark.parametrize("k", [0, 4, 9])
@pytest.mark.parametrize("kind", ["dpm_solver", "dpm_solver_sde", "dpm_solver_sde_mean",
                                  "unipc"])
def test_step_matches_jax(kind, k):
    """One step on seeded inputs wide enough that the x0 clip acts."""
    x, prev, x0_prev, eps, z = (_noise((2, 4, 4, 3), seed=s) * 2.0 for s in range(5))
    mine, ref = _tables("dpm_solver_sde" if kind.startswith("dpm_solver_sde") else kind,
                        10, "leading")
    t = torch.from_numpy
    if kind == "unipc":
        want = junipc.unipc_step(jnp.asarray(x), jnp.asarray(prev), jnp.asarray(x0_prev),
                                 jnp.asarray(eps), k, ref)
        got = unipc_step(t(x), t(prev), t(x0_prev), t(eps), k, mine)
    else:
        noise = None if kind == "dpm_solver_sde_mean" else z
        want = jdpm.dpm_solver_step(jnp.asarray(x), jnp.asarray(x0_prev), jnp.asarray(eps),
                                    k, ref, None if noise is None else jnp.asarray(noise))
        got = dpm_solver_step(t(x), t(x0_prev), t(eps), k, mine,
                              None if noise is None else t(noise))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


def _jax_walk(apply, params, scheduler, spacing, noise):
    """Every frame of the JAX package's multistep walk from `noise`, step by
    step with its tables, its step functions and its sampler's carry
    (`synt_isic_tpu/diffusion/sampler.py:271-299`: (x, x0_prev = 0) for
    DPM-Solver, (x_pred, x_prev = x, x0_prev = 0) for UniPC, the frame the
    carry's first element), the SDE on its mean path."""
    _, ref = _tables(scheduler, STEPS, spacing)
    x = jnp.asarray(noise)
    carry = (x, x, jnp.zeros_like(x)) if scheduler == "unipc" else (x, jnp.zeros_like(x))
    frames = []
    with jax.default_matmul_precision("highest"):
        for k in range(STEPS):
            eps = apply(params, carry[0], jnp.broadcast_to(ref.timesteps[k], (x.shape[0],)))
            carry = (junipc.unipc_step(*carry, eps, k, ref) if scheduler == "unipc"
                     else jdpm.dpm_solver_step(*carry, eps, k, ref, None))
            frames.append(np.asarray(carry[0]))
    return np.stack(frames)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("scheduler", MULTISTEP)
def test_golden_chain_matches_jax(params, model, jax_apply, scheduler, spacing):
    noise = _noise((2, SIZE, SIZE, 3), seed=1)
    want = _jax_walk(jax_apply, params, scheduler, spacing, noise)
    out = _port_sampler(scheduler, timestep_spacing=spacing,
                        deterministic_posterior=True).sample(
        model, SEEDS, capture_trajectory=True, initial_noise=noise)
    got = out["trajectory"].numpy()
    assert got.shape == want.shape == (STEPS, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(out["images"].numpy(), got[-1])


def test_sde_with_the_jax_package_noise(params, model, jax_apply):
    """The JAX sampler draws its own SDE noise, fold_in(PRNGKey(seed), k+1)
    per step; the same draws injected into the port give the same images."""
    spacing = "trailing"
    shape = (SIZE, SIZE, 3)
    jsampler = JaxSampler(jax_apply, JaxSchedule.create(),
                          JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                           scheduler="dpm_solver_sde",
                                           timestep_spacing=spacing))
    keys = JaxSampler.keys_for_seeds(SEEDS)
    init = np.array(jsampler.initial_noise(SEEDS))
    step_noise = np.stack([np.asarray(jax.vmap(
        lambda key, k=k: jax.random.normal(jax.random.fold_in(key, k + 1), shape,
                                           jnp.float32))(keys)) for k in range(STEPS)])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsampler.sample(params, SEEDS)["images"])
    sampler = _port_sampler("dpm_solver_sde", timestep_spacing=spacing)
    got = sampler.sample(model, SEEDS, initial_noise=init, step_noise=step_noise)["images"]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    # the noise matters: the mean path lies well away
    mean = sampler.sample(model, SEEDS, initial_noise=init,
                          step_noise=np.zeros_like(step_noise))["images"].numpy()
    assert np.abs(mean - want).max() > 1e-2


@pytest.mark.parametrize("scheduler", ["ddpm", "dpm_solver_sde", "unipc"])
def test_windowed_and_streamed_capture(model, scheduler):
    """Every carry family (simple, dpm, unipc; each here with its own step
    noise where it draws any): the frames at save_indices equal the same
    frames of a full capture, and the host-streamed trajectory is the
    on-device one."""
    sampler = _port_sampler(scheduler)
    full = sampler.sample(model, SEEDS, capture_trajectory=True)
    for every in (2, 50):
        idx = save_indices(STEPS, every, sampler.timesteps, 1000)
        windowed = sampler.sample(model, SEEDS, capture_trajectory=every)
        streamed = sampler.sample(model, SEEDS, capture_trajectory=every, stream_to_host=True)
        assert windowed["save_indices"] == streamed["save_indices"] == idx
        torch.testing.assert_close(windowed["trajectory"], full["trajectory"][idx],
                                   rtol=0, atol=0)
        assert isinstance(streamed["trajectory"], np.ndarray)
        np.testing.assert_array_equal(streamed["trajectory"], windowed["trajectory"].numpy())
        torch.testing.assert_close(streamed["images"], full["images"], rtol=0, atol=0)
    every_step = sampler.sample(model, SEEDS, capture_trajectory=True, stream_to_host=True)
    assert every_step["save_indices"] == list(range(STEPS))
    np.testing.assert_array_equal(every_step["trajectory"], full["trajectory"].numpy())


def test_unipc_frame_is_the_prediction(model):
    """The sample UniPC carries, each frame and the final image, is the
    predictor's output x_pred, not the corrected x_corr."""
    sampler = _port_sampler("unipc")
    out = sampler.sample(model, SEEDS, capture_trajectory=True)
    x = sampler.initial_noise(SEEDS).permute(0, 3, 1, 2).contiguous()
    carry = (x, x, torch.zeros_like(x))
    with torch.inference_mode():
        for k in range(STEPS):
            eps = model(carry[0], sampler.params.timesteps[k].expand(2))
            carry = unipc_step(*carry, eps, k, sampler.params)
            torch.testing.assert_close(out["trajectory"][k], carry[0].permute(0, 2, 3, 1),
                                       rtol=0, atol=0)
    assert not torch.equal(carry[0], carry[1])


def test_sde_batch_composition_independence(model):
    """An SDE image depends on its seed only, not on the rest of its batch
    (up to the f32 reordering a batch-size-dependent conv may bring)."""
    sampler = _port_sampler("dpm_solver_sde", 3)
    pair = sampler.sample(model, [3, 7])
    alone = sampler.sample(model, [7])
    assert pair["noise_hashes"][1] == alone["noise_hashes"][0]
    np.testing.assert_allclose(pair["images"][1].numpy(), alone["images"][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    # the SDE draws noise: with it off the image moves
    mean = _port_sampler("dpm_solver_sde", 3, deterministic_posterior=True).sample(
        model, [7])["images"]
    assert not torch.allclose(mean, alone["images"], atol=1e-3)


def test_sample_single(model):
    sampler = _port_sampler("unipc", 2)
    one = sampler.sample_single(model, 9, capture_trajectory=True)
    np.testing.assert_array_equal(one["seeds"], [9])
    assert one["trajectory"].shape == (2, 1, SIZE, SIZE, 3)
    torch.testing.assert_close(one["images"], sampler.sample(model, [9])["images"],
                               rtol=0, atol=0)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("scheduler", MULTISTEP)
def test_exact_denoiser_reaches_its_point(scheduler, spacing):
    """With the exact denoiser of a point mass at x0*, every solver's final
    image is x0*: the last step returns its x0 estimate."""
    x0_star = 0.42
    ab = torch.from_numpy(DiffusionSchedule.create().alphas_cumprod).float()

    def exact(x, t):
        a = ab[t].reshape(-1, 1, 1, 1)
        return (x - a.sqrt() * x0_star) / (1.0 - a).sqrt()

    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=8, image_size=2, channels=1,
                                             scheduler=scheduler, timestep_spacing=spacing,
                                             clip_sample=False),
                               device="cpu")
    out = sampler.sample(exact, np.arange(4))
    np.testing.assert_allclose(out["images"].numpy(), x0_star, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["euler", "DDIM", ""])
def test_unknown_scheduler_refused(name):
    with pytest.raises(ValueError):
        SamplerConfig(scheduler=name)
