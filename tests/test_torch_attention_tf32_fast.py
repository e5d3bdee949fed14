"""f32 fast math at head_dim 8 on the CPU: the rounding order of the f32
tensor-core kernel (`attention_fast_math_kernel_order(..., step=64,
tf32x3=True)`: the 3xTF32 logits, the running max per 64-key tile taken
from the one-pass product of the TF32 hi parts) against the JAX package's
Pallas fast-math kernel, and the port's UNet with fast math against the JAX
package's. The kernel itself runs only on a GPU: `tests/test_torch_gpu.py`
holds it against this order.

Tolerances. Against the port's plain version of the Pallas order
(`attention_fast_math_reference`): 1e-2, what the kernel is held to on the
card (`chip_smoke.py` FAST_TOL); both round the weights to bf16, against
other shifts. Against the JAX Pallas kernel: rtol = atol = 2^-8, the f32
fast-math tolerance of `tests/test_torch_attention_fast.py`: a shifted logit
that rounds to the other side of a bf16 rounding point moves its weight by
about one bf16 ulp, the output by about 2^-8 of that weight's share.
Against exact attention: the JAX package's own fast-math tolerance (rtol
0.05, atol 0.02, `tests/test_pallas_ops.py`), and not equal to it. The
whole tiny UNet: rtol = atol = 2^-8 as well, since the f32 differences of
the layers before an attention block (1e-4 in `tests/test_torch_unet.py`)
flip bf16 roundings of its weights in the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.ops.pallas import attention as jax_attention
from synt_isic_tpu_torch.ops import attention

from tests.torch_port_fixtures import (TINY_JAX, attention_inputs, jax_fast_attention,
                                       jax_params, nchw, port_model)

SHAPE, SEED = (2, 4, 130, 8), 12   # three 64-key tiles, the last one short
JAX_TOL = 2.0 ** -8


def _order(q, k, v, tf32x3=True):
    return attention.attention_fast_math_kernel_order(q, k, v, attention.fast_math_step(q),
                                                      tf32x3=tf32x3)


def _qkv():
    return [torch.from_numpy(z) for z in attention_inputs(SHAPE, SEED)]


@pytest.mark.parametrize("token_minor", [True, False])
def test_tf32x3_order_matches_the_pallas_kernel(token_minor):
    """Both Pallas layouts (K1 token-minor, K2 token-major) on the same
    seeded numpy inputs."""
    got = _order(*_qkv())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_fast_attention(SHAPE, SEED, token_minor),
                               rtol=JAX_TOL, atol=JAX_TOL)


def test_tf32x3_order_is_fast_math():
    """Within 1e-2 of the Pallas-order plain version and within the JAX
    package's fast-math tolerance of exact attention, but not exact; and
    the f32 tensor-core rule (3xTF32 logits, hi.hi tile max) is not the
    plain-logit order at the same step: they round other weights."""
    q, k, v = _qkv()
    got = _order(q, k, v)
    assert (got - attention.attention_fast_math_reference(q, k, v)).abs().max().item() <= 1e-2
    exact = attention.attention_reference(q, k, v)
    torch.testing.assert_close(got, exact, rtol=0.05, atol=0.02)
    assert (got - exact).abs().max().item() > 1e-4
    assert not torch.equal(got, _order(q, k, v, tf32x3=False))


def test_unet_fast_math_matches_jax(monkeypatch):
    """The port's tiny UNet with `fused_fast_math=True` in f32 (on the CPU the
    plain fast-math version) against the JAX package's with the same flag,
    its Pallas kernel in interpret mode (as `tests/test_pallas_ops.py` runs
    the fused model on the CPU, through the module attribute the model
    reads at call time)."""
    params = jax_params()
    rng = np.random.default_rng(13)
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 900])
    pallas = jax_attention.fused_attention_trainable
    monkeypatch.setattr(jax_attention, "fused_attention_trainable",
                        lambda q, k, v, interpret, g, fast, tm: pallas(q, k, v, True, g, fast, tm))
    model = JaxUNet2D(config=TINY_JAX, use_fused_attention=True, fused_fast_math=True)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, x, t: model.apply({"params": p}, x, t))(
            params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port_model(params, use_fused_attention=True, fused_fast_math=True)(
            nchw(x), torch.from_numpy(t))
        exact = port_model(params)(nchw(x), torch.from_numpy(t))
    assert not torch.equal(got, exact)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=JAX_TOL, atol=JAX_TOL)
