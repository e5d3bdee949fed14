"""The port's DDPM/DDIM sampler against the JAX package's, on the CPU.

Golden chain: the same carried-over tiny UNet weights and the same injected
initial noise through both samplers, 5 steps, every frame compared. The JAX
side runs at highest matmul precision, so the comparison is of the
algorithms; the tolerances are tighter than `tests/test_golden_chain.py`'s
(2e-2 first frame, 8e-2 last, which allow for XLA's default precision).
PyTorch cannot reproduce JAX's random bits, so stochastic DDPM is compared
with injected step noise.
"""
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
from synt_isic_tpu.diffusion.sampler import noise_hash as jax_noise_hash
from synt_isic_tpu.diffusion.sampler import save_indices as jax_save_indices
from synt_isic_tpu.diffusion.sampler import to_uint8_images as jax_to_uint8
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu_torch.diffusion import (DDIMParams, DDPMParams, DiffusionSampler,
                                           DiffusionSchedule, SamplerConfig,
                                           ddim_step, ddpm_step)
from synt_isic_tpu_torch.diffusion.sampler import noise_hash, save_indices, to_uint8_images

from tests.torch_port_fixtures import TINY_JAX, jax_params, port_model

STEPS = 5
SIZE = TINY_JAX.sample_size


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=3)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


def _noise(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port_sampler(steps=STEPS, **kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=steps, image_size=SIZE, **kw),
                            device="cpu")


@pytest.mark.parametrize("scheduler", ["ddim", "ddpm"])
def test_golden_chain_matches_jax(params, model, scheduler):
    noise = _noise((2, SIZE, SIZE, 3))
    jmodel = JaxUNet2D(config=TINY_JAX)
    jsampler = JaxSampler(lambda p, x, t: jmodel.apply({"params": p}, x, t),
                          JaxSchedule.create(),
                          JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                           scheduler=scheduler,
                                           deterministic_posterior=True))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsampler.sample(params, [0, 1], capture_trajectory=True,
                                          initial_noise=jnp.asarray(noise))["trajectory"])
    out = _port_sampler(scheduler=scheduler, deterministic_posterior=True).sample(
        model, [0, 1], capture_trajectory=True, initial_noise=noise)
    got = out["trajectory"].numpy()
    assert got.shape == want.shape == (STEPS, 2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(out["images"].numpy(), got[-1])
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999999


def test_stochastic_ddpm_with_injected_step_noise(params, model):
    """Ancestral DDPM with the same posterior noise on both sides: the JAX
    walk is written out with its own model and `ddpm_step`."""
    steps = 3
    noise = _noise((2, SIZE, SIZE, 3), seed=1)
    z = _noise((steps, 2, SIZE, SIZE, 3), seed=2)
    jmodel = JaxUNet2D(config=TINY_JAX)
    apply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    jp = jddpm.DDPMParams.create(JaxSchedule.create(), steps)
    x = jnp.asarray(noise)
    with jax.default_matmul_precision("highest"):
        for k in range(steps):
            eps = apply(params, x, jnp.broadcast_to(jp.timesteps[k], (2,)))
            x = jddpm.ddpm_step(x, eps, k, jp, jnp.asarray(z[k]))
    out = _port_sampler(steps).sample(model, [0, 1], initial_noise=noise, step_noise=z)
    np.testing.assert_allclose(out["images"].numpy(), np.asarray(x), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("k", [0, 3, 9])
@pytest.mark.parametrize("kind", ["ddpm", "ddim"])
def test_step_with_injected_noise_matches_jax(kind, k):
    x, eps, z = (_noise((2, 4, 4, 3), seed=s) * 2.0 for s in (4, 5, 6))
    if kind == "ddpm":
        jp = jddpm.DDPMParams.create(JaxSchedule.create(), 10)
        want = jddpm.ddpm_step(jnp.asarray(x), jnp.asarray(eps), k, jp, jnp.asarray(z))
        got = ddpm_step(torch.from_numpy(x), torch.from_numpy(eps), k,
                        DDPMParams.create(DiffusionSchedule.create(), 10, device="cpu"),
                        torch.from_numpy(z))
    else:
        jp = jddim.DDIMParams.create(JaxSchedule.create(), 10, eta=0.7)
        want = jddim.ddim_step(jnp.asarray(x), jnp.asarray(eps), k, jp, jnp.asarray(z))
        got = ddim_step(torch.from_numpy(x), torch.from_numpy(eps), k,
                        DDIMParams.create(DiffusionSchedule.create(), 10, eta=0.7,
                                          device="cpu"),
                        torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_batch_composition_independence(model):
    """An image depends on its seed only, not on the rest of its batch (up
    to the f32 reordering a batch-size-dependent conv may bring)."""
    sampler = _port_sampler(3)
    pair = sampler.sample(model, [3, 7])
    alone = sampler.sample(model, [7])
    assert pair["noise_hashes"][1] == alone["noise_hashes"][0]
    np.testing.assert_allclose(pair["images"][1].numpy(), alone["images"][0].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(pair["images"][0].numpy(), pair["images"][1].numpy())


def test_noise_hashes_and_streams():
    sampler = _port_sampler()
    seeds = np.array([11, 12], np.uint32)
    noise = sampler.initial_noise(seeds)
    assert noise.shape == (2, SIZE, SIZE, 3) and noise.dtype == torch.float32
    torch.testing.assert_close(noise[1], sampler.initial_noise([12])[0], rtol=0, atol=0)
    # step noise is a pure function of (seed, k), distinct across k
    z = sampler.step_noise(seeds, 2)
    torch.testing.assert_close(z[0], sampler.step_noise(np.array([11]), 2)[0], rtol=0, atol=0)
    assert not torch.equal(z, sampler.step_noise(seeds, 3))
    # the recorded hash is that of the returned initial noise, by the same
    # function as the JAX package's
    injected = _noise((2, SIZE, SIZE, 3), seed=9)
    assert noise_hash(injected[0]) == jax_noise_hash(injected[0])


def test_returned_noise_hashes(model):
    sampler = _port_sampler(1, scheduler="ddim")
    out = sampler.sample(model, [21, 22])
    noise = sampler.initial_noise([21, 22]).numpy()
    assert out["noise_hashes"] == [noise_hash(n) for n in noise]
    injected = _noise((1, SIZE, SIZE, 3), seed=4)
    out = sampler.sample(model, [0], initial_noise=injected)
    assert out["noise_hashes"] == [noise_hash(injected[0])]


@pytest.mark.parametrize("every", [2, 50])
def test_windowed_capture(model, every):
    sampler = _port_sampler(scheduler="ddim")
    want_idx = jax_save_indices(STEPS, every, sampler.timesteps, 1000)
    out = sampler.sample(model, [1], capture_trajectory=every)
    full = sampler.sample(model, [1], capture_trajectory=True)
    assert out["save_indices"] == want_idx
    torch.testing.assert_close(out["trajectory"], full["trajectory"][want_idx],
                               rtol=0, atol=0)


@pytest.mark.parametrize("args", [(50, 10), (7, 3), (20, 20), (10, 250), (5, 1)])
def test_save_indices_match(args):
    ts = np.arange(args[0])[::-1] * (1000 // args[0])
    assert save_indices(*args, ts, 1000) == jax_save_indices(*args, ts, 1000)


def test_to_uint8_matches():
    x = _noise((2, 4, 4, 3), seed=7) * 1.5
    np.testing.assert_array_equal(to_uint8_images(torch.from_numpy(x)), jax_to_uint8(x))


def test_config_rejects_unported_schedulers():
    """The five schedulers of the JAX package are ported; another name is
    refused."""
    for name in ("ddpm", "ddim", "dpm_solver", "dpm_solver_sde", "unipc"):
        assert SamplerConfig(scheduler=name).scheduler == name
    with pytest.raises(ValueError):
        SamplerConfig(scheduler="euler")
