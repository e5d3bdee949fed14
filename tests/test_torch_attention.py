"""The port's attention core against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
kernel runs in interpret mode, as the JAX package's own tests run it. The
f32 tolerance is the one `tests/test_pallas_ops.py` holds the Pallas kernel
to against its einsum reference. The hand-written CUDA kernel itself runs
only on a GPU: `tests/test_torch_gpu.py` holds it against this plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from synt_isic_tpu_torch.ops import attention

SHAPES = [(2, 4, 64, 8), (1, 2, 16, 4)]


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("token_minor", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_pallas_kernel(shape, token_minor):
    q, k, v = _qkv(shape)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True, token_minor=token_minor))
    got = attention.fused_attention(*(torch.from_numpy(z) for z in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_strided_btc_entry(shape):
    """(B, T, C) projections split into heads by a view, as the UNet's
    attention block hands them over."""
    b, h, t, d = shape
    q, k, v = _qkv(shape, seed=1)
    want = np.asarray(jax_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          interpret=True))
    btc = [torch.from_numpy(z).transpose(1, 2).reshape(b, t, h * d) for z in (q, k, v)]
    views = [z.view(b, t, h, d).transpose(1, 2) for z in btc]
    got = attention.fused_attention(*views)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_bf16_matches_pallas_kernel():
    """bf16 inputs: both sides round the probabilities and the output to
    bf16, so they may differ by one bf16 ulp of the output: 2^-6 at the
    |x| < 4 these inputs give."""
    q, k, v = _qkv((1, 2, 64, 8), seed=2)
    want = np.asarray(jax_fused_attention(
        *(jnp.asarray(z, jnp.bfloat16) for z in (q, k, v)), interpret=True)
        .astype(jnp.float32))
    got = attention.fused_attention(*(torch.from_numpy(z).bfloat16() for z in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6, atol=2 ** -6)


def test_cpu_tensors_do_not_count_launches():
    before = dict(attention.LAUNCHES)
    attention.fused_attention(*(torch.from_numpy(z) for z in _qkv((1, 2, 16, 8))))
    assert attention.LAUNCHES == before


def test_rejects_what_it_does_not_take():
    q = torch.zeros(1, 2, 16, 8)
    # fast_math is ported: on a CPU tensor it runs its plain version
    assert torch.equal(attention.fused_attention(q, q, q, fast_math=True),
                       attention.attention_fast_math_reference(q, q, q))
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q, heads_per_program=0)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError):
        attention.fused_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def test_library_path_follows_the_headers(tmp_path, monkeypatch):
    """A kernel library is keyed by its source and by the `csrc/` headers it
    may include, so an edited header never loads a stale build."""
    from synt_isic_tpu_torch.ops import native

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(native, "CSRC_DIR", tmp_path)
    first = native.library_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert native.library_path("k") != first
    (tmp_path / "h.cuh").write_text("// one\n")
    assert native.library_path("k") == first
    assert first.name.startswith("libk-")
