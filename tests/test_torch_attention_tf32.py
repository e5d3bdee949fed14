"""The f32 tensor-core forward's rounding (`attention_tf32x3_kernel_order`,
3xTF32 products, the max moving per 64-key tile) against the JAX package's
f32 einsum attention, on the CPU.

Tolerance: rtol = atol = 2e-5, the one `tests/test_pallas_ops.py` holds the
Pallas kernel to against the einsum path. 3xTF32 carries each product to
about 2^-22 of it, as f32 does, so it meets that with room to spare; one
TF32 pass (10 mantissa bits) misses it, and the test shows that it can tell
the two apart. The kernel itself runs only on a GPU:
`tests/test_torch_gpu.py` holds it against this order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu_torch.ops import attention

from tests.torch_port_fixtures import TINY, jax_params, nchw, port_model

TOL = 2e-5
# the tiny config's attention call ((B, 4 heads, 8 x 8 tokens, head_dim 4)),
# the kernel's head_dim 8 at the same T, a ragged T, and the UNet's T=1024
SHAPES = [(2, 4, 64, 4), (2, 4, 64, 8), (2, 4, 101, 8), (1, 4, 1024, 8)]


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _jax_einsum_attention(q, k, v):
    """The JAX model's einsum path (`synt_isic_tpu/models/unet2d.py`
    AttentionBlock, as `tests/test_pallas_ops.py` writes it) in f32."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32) * scale
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(jnp.einsum("bhqk,bhkd->bhqd", probs, v,
                                 preferred_element_type=jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_order_matches_jax_einsum(shape):
    q, k, v = _qkv(shape)
    want = _jax_einsum_attention(*(jnp.asarray(z) for z in (q, k, v)))
    got = attention.attention_tf32x3_kernel_order(*(torch.from_numpy(z) for z in (q, k, v)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_misses_the_tolerance(shape, monkeypatch):
    """The same order with the lo parts dropped (hi.hi only, one TF32 pass)
    lies several times the tolerance from the einsum path on the same
    inputs: the check above tells the split from plain TF32."""
    q, k, v = _qkv(shape)
    want = _jax_einsum_attention(*(jnp.asarray(z) for z in (q, k, v)))
    split = attention.tf32_split
    monkeypatch.setattr(attention, "tf32_split", lambda x: (split(x)[0], torch.zeros_like(x)))
    got = attention.attention_tf32x3_kernel_order(
        *(torch.from_numpy(z) for z in (q, k, v))).numpy()
    ratio = np.max(np.abs(got - want) / (TOL + TOL * np.abs(want)))
    assert ratio > 5, ratio


def test_tf32_split_rounds_hi_to_nearest_away():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (`cvt.rna.tf32.f32`); lo is the rest with its 13 low bits cleared
    (truncated toward zero, as the tensor cores read it)."""
    ulp = 2.0 ** -10                 # of TF32 at 1
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 3.0,
                      1 + ulp / 4 + 2.0 ** -23])
    hi, lo = attention.tf32_split(x)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 3.0, 1.0]
    # the last: lo = ulp / 4 + 2^-23 needs 12 bits, and keeps the top 11
    assert lo.tolist() == [-ulp / 2, ulp / 2, ulp / 4, -ulp / 4, 0.0, ulp / 4]
    y = torch.from_numpy(_qkv((4, 64))[0])
    hi, lo = attention.tf32_split(y)
    bits = [z.view(torch.int32) & 0x1FFF for z in (hi, lo)]
    assert all(int(b.abs().max()) == 0 for b in bits)
    # |y - hi| <= 2^-11 |y|, and truncating it to TF32 costs under 2^-10 of
    # that: hi + lo carries y to 2^-21 of it (plus the f32 sum here)
    assert ((y - (hi + lo)).abs() <= 2.0 ** -20 * y.abs()).all()


def test_kernel_order_is_not_on_the_cpu_path(monkeypatch):
    """On the CPU the UNet's fused attention runs `attention_reference`; the
    kernel order serves only to check the card's kernel."""
    def refuse(*args):
        raise AssertionError("attention_tf32x3_kernel_order on the CPU path")

    calls = []
    reference = attention.attention_reference

    def spy(*args):
        calls.append(args[0].shape)
        return reference(*args)

    monkeypatch.setattr(attention, "attention_tf32x3_kernel_order", refuse)
    monkeypatch.setattr(attention, "attention_reference", spy)
    model = port_model(jax_params(), TINY, use_fused_attention=True)
    x = np.random.default_rng(1).normal(size=(2, TINY.sample_size, TINY.sample_size, 3))
    with torch.no_grad():
        out = model(nchw(x.astype(np.float32)), torch.tensor([10, 900]))
    assert torch.isfinite(out).all()
    assert len(calls) >= 2 and all(shape[-1] == TINY.attention_head_dim for shape in calls)
