"""The port's f32-statistics GroupNorm against the JAX package's, in f32
(same math, f32 rounding: 2e-5 as in `tests/test_fast_norm.py`) and bf16
(arithmetic in bf16 on both sides: one bf16 ulp, 2^-6 at |y| < 4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.ops.norms import group_norm_silu_fast as jax_norm
from synt_isic_tpu_torch.ops.norms import group_norm_silu_fast


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2 ** -6)])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((3, 4, 4, 32), 32)])
def test_matches_jax(shape, groups, dtype, tol, silu):
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, shape).astype(np.float32)
    scale = rng.normal(1.0, 0.1, shape[-1]).astype(np.float32)
    bias = rng.normal(0.0, 0.1, shape[-1]).astype(np.float32)
    want = jax_norm(jnp.asarray(x, dtype), jnp.asarray(scale), jnp.asarray(bias),
                    groups, 1e-5, silu=silu)
    got = group_norm_silu_fast(
        torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2),
        torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5, silu=silu)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


def test_matches_torch_group_norm_f32():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(0.5, 3.0, (2, 16, 5, 5)).astype(np.float32))
    norm = torch.nn.GroupNorm(4, 16)
    torch.nn.init.normal_(norm.weight)
    torch.nn.init.normal_(norm.bias)
    with torch.no_grad():
        want = torch.nn.functional.silu(norm(x))
    got = group_norm_silu_fast(x, norm.weight.detach(), norm.bias.detach(), 4)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
