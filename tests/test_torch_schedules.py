"""The port's schedule tables against the JAX package's.

The float64 host tables are the same numpy code on both sides and must be
equal exactly; the f32 device tables are the same float64 values rounded
once to f32 and must be equal to 0 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion import ddim as jddim
from synt_isic_tpu.diffusion import ddpm as jddpm
from synt_isic_tpu.diffusion import schedules as jsched
from synt_isic_tpu_torch.diffusion import ddim, ddpm, schedules

STEPS = [1, 7, 20, 50, 1000]


@pytest.mark.parametrize("beta_schedule", ["squaredcos_cap_v2", "linear"])
def test_host_tables_equal(beta_schedule):
    want = jsched.DiffusionSchedule.create(beta_schedule=beta_schedule)
    got = schedules.DiffusionSchedule.create(beta_schedule=beta_schedule)
    for name in ("betas", "alphas", "alphas_cumprod"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("steps", STEPS)
def test_timesteps_equal(spacing, steps):
    np.testing.assert_array_equal(schedules.spaced_timesteps(1000, steps, spacing),
                                  jsched.spaced_timesteps(1000, steps, spacing))


def test_device_tables_equal():
    want = jsched.DiffusionSchedule.create().device_tables()
    got = schedules.DiffusionSchedule.create().device_tables(device="cpu")
    for name, table in want.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(table))


def _assert_params_equal(got, want, fields):
    np.testing.assert_array_equal(got.timesteps.numpy(), np.asarray(want.timesteps))
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("steps", STEPS)
def test_ddpm_params_equal(spacing, steps):
    sched = jsched.DiffusionSchedule.create()
    want = jddpm.DDPMParams.create(sched, steps, timestep_spacing=spacing)
    got = ddpm.DDPMParams.create(schedules.DiffusionSchedule.create(), steps,
                                 timestep_spacing=spacing, device="cpu")
    _assert_params_equal(got, want, ("inv_sqrt_alphas_cumprod",
                                     "sqrt_one_minus_alphas_cumprod",
                                     "pred_original_coeff", "current_sample_coeff",
                                     "posterior_std"))
    assert got.stochastic == bool(np.any(np.asarray(want.posterior_std) > 0))


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("steps", STEPS)
def test_ddim_params_equal(eta, spacing, steps):
    sched = jsched.DiffusionSchedule.create()
    want = jddim.DDIMParams.create(sched, steps, eta=eta, timestep_spacing=spacing)
    got = ddim.DDIMParams.create(schedules.DiffusionSchedule.create(), steps,
                                 eta=eta, timestep_spacing=spacing, device="cpu")
    _assert_params_equal(got, want, ("inv_sqrt_alphas_cumprod",
                                     "sqrt_one_minus_alphas_cumprod",
                                     "sqrt_alphas_cumprod_prev", "dir_coeff", "sigma"))
    assert got.stochastic == (eta > 0 and steps > 1)


def test_add_noise_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    eps = rng.normal(size=x.shape).astype(np.float32)
    t = np.array([0, 500, 999])
    want = jddpm.add_noise(jsched.DiffusionSchedule.create(), jnp.asarray(x),
                           jnp.asarray(eps), jnp.asarray(t))
    got = ddpm.add_noise(schedules.DiffusionSchedule.create(), torch.from_numpy(x),
                         torch.from_numpy(eps), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
