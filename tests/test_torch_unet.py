"""The port's UNet2D against the JAX package's, on the CPU.

Weights are carried over from a JAX parameter tree (`state_dict_from_jax`)
and loaded with `strict=True`; the JAX side runs its own CPU route
(`use_fused_attention=False`, einsum attention) at highest matmul
precision, so the f32 comparison is of the algorithms: 1e-4 covers f32
reordering through the tiny network (measured max about 2e-6). bf16 runs
every conv and linear in bf16 on both sides with different rounding
points: 0.1 at outputs of magnitude about 3 is a few bf16 ulps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.manifest import expected_unet2d_state_shapes
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu_torch.io.pth import load_checkpoint
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig, get_timestep_embedding

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params, nchw, port_model


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    return rng.normal(size=(2, 16, 16, 3)).astype(np.float32), np.array([5, 900])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 1e-1)])
@pytest.mark.parametrize("fast_norm", [False, True])
def test_forward_matches_jax(params, inputs, fast_norm, dtype, tol):
    x, t = inputs
    jmodel = JaxUNet2D(config=TINY_JAX, dtype=getattr(jnp, dtype), fast_norm=fast_norm)
    apply = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    model = port_model(params, dtype=getattr(torch, dtype), fast_norm=fast_norm)
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t))
    assert got.dtype == torch.float32   # f32 conv_norm_out/conv_out tail
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=tol, atol=tol)


def test_fused_flag_is_the_plain_path_on_cpu(params, inputs):
    x, t = inputs
    with torch.no_grad():
        a = port_model(params)(nchw(x), torch.from_numpy(t))
        b = port_model(params, use_fused_attention=True)(nchw(x), torch.from_numpy(t))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_timestep_embedding_matches_jax():
    """Both embeddings against a float64 evaluation of the same formula,
    per element. Each side computes in f32 the exponent e = -ln(P) i / half
    (two roundings, relative 2^-24 each), f = exp(e) (within one f32 ulp,
    2^-23 relative), and the argument x = t f (half an ulp of x). So x is
    within half an ulp of x plus |x| 2^-24 (2|e| + 2) of the exact t
    exp(e); sin and cos have slope at most 1, and their f32 results add a
    few ulps (4 x 2^-24 for values up to 1). At t = 999 the largest
    argument is 999, where half an f32 ulp alone is 3.05e-5."""
    from synt_isic_tpu.models.unet2d import get_timestep_embedding as jax_embedding

    t = np.array([0, 1, 250, 999])
    u = 2.0 ** -24
    for dim, flip in ((64, True), (33, False)):
        half = dim // 2
        e = -np.log(10000.0) * np.arange(half) / half
        x = t[:, None] * np.exp(e)[None, :]
        want = np.concatenate([np.cos(x), np.sin(x)] if flip else [np.sin(x), np.cos(x)], -1)
        bound = np.spacing(x.astype(np.float32)) / 2 + x * u * (2 * np.abs(e) + 2)
        tol = np.concatenate([bound, bound], -1) + 4 * u
        if dim % 2:
            want, tol = (np.pad(z, ((0, 0), (0, 1))) for z in (want, tol))
        for got in (np.asarray(jax_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip)),
                    get_timestep_embedding(torch.from_numpy(t), dim,
                                           flip_sin_to_cos=flip).numpy()):
            assert got.shape == want.shape
            assert np.all(np.abs(got - want) <= tol), (dim, np.abs(got - want).max())


def test_full_width_state_dict_matches_manifest():
    """The reference architecture's keys and shapes, without building its
    weights (meta device)."""
    with torch.device("meta"):
        state = UNet2D(UNet2DConfig()).state_dict()
    got = {k: tuple(v.shape) for k, v in state.items()}
    assert got == expected_unet2d_state_shapes()


def test_conditional_state_dict_matches_manifest():
    cfg = dataclasses.replace(TINY, num_class_embeds=8)
    with torch.device("meta"):
        state = UNet2D(cfg).state_dict()
    assert ({k: tuple(v.shape) for k, v in state.items()}
            == expected_unet2d_state_shapes(**dataclasses.asdict(cfg)))


def test_bf16_weights_round_like_jax(params):
    """Conv and linear weights live in the compute dtype; norms and the
    output conv stay f32 (the JAX model's f32 tail)."""
    model = port_model(params, dtype=torch.bfloat16)
    assert model.conv_in.weight.dtype == torch.bfloat16
    assert model.conv_out.weight.dtype == torch.float32
    assert model.conv_norm_out.weight.dtype == torch.float32
    want = np.asarray(jnp.asarray(params["conv_in"]["kernel"], jnp.bfloat16)
                      .astype(jnp.float32)).transpose(3, 2, 0, 1)
    np.testing.assert_array_equal(model.conv_in.weight.detach().float().numpy(), want)


def test_loads_pth_written_by_jax_package(params, inputs, tmp_path):
    path = str(tmp_path / "unet_MEL_best.pth")
    save_pth(flax_to_torch(params), path)
    model = UNet2D(TINY).eval()
    model.load_state_dict(load_checkpoint(path), strict=True)
    x, t = inputs
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t))
        want = port_model(params)(nchw(x), torch.from_numpy(t))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_class_labels_contract(params):
    model = port_model(params)
    x = torch.zeros(1, 3, 16, 16)
    with pytest.raises(ValueError):
        model(x, torch.tensor([1]), class_labels=torch.tensor([0]))
    cond = UNet2D(dataclasses.replace(TINY, num_class_embeds=3))
    with pytest.raises(ValueError):
        cond(x, torch.tensor([1]))
    with torch.no_grad():
        assert cond(x, torch.tensor(1), class_labels=torch.tensor([2])).shape == x.shape
