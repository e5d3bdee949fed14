"""The port's attention backward and autograd Function against the JAX
package's Pallas backward (`fused_attention_bwd`) and custom VJP
(`fused_attention_trainable`).

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
kernels run in interpret mode, as the JAX package's own tests run them.
Tolerance: `atol = 5e-5 * max|g|` per gradient, the one
`tests/test_pallas_ops.py` holds the Pallas backward to, at one head per
program and at `heads_per_program=2`. The CUDA kernel
itself runs only on a GPU: `tests/test_torch_gpu.py` holds it against the
plain version here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.ops.pallas.attention import fused_attention_bwd as jax_attention_bwd
from synt_isic_tpu.ops.pallas.attention import (
    fused_attention_trainable as jax_attention_trainable)
from synt_isic_tpu_torch.ops import attention

SHAPES = [(1, 2, 16, 8), (2, 4, 64, 8), (1, 2, 16, 4)]


def _arrays(shape, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _assert_grads_close(got, want):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0,
                                   atol=5e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reference_matches_pallas_kernel(shape):
    q, k, v, do = _arrays(shape, 4)
    want = jax_attention_bwd(*(jnp.asarray(z) for z in (q, k, v, do)), interpret=True)
    got = attention.fused_attention_bwd(*(torch.from_numpy(z) for z in (q, k, v, do)))
    _assert_grads_close([g.numpy() for g in got], want)


def test_bwd_reference_strided_btc_entry():
    """(B, T, C) views in, gradients with the views' strides out."""
    b, h, t, d = 1, 2, 16, 8
    q, k, v, do = _arrays((b, h, t, d), 4, seed=1)
    want = attention.attention_bwd_reference(*(torch.from_numpy(z) for z in (q, k, v, do)))
    views = [torch.from_numpy(z).transpose(1, 2).reshape(b, t, h * d)
             .view(b, t, h, d).transpose(1, 2) for z in (q, k, v, do)]
    got = attention.fused_attention_bwd(*views)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(2, 4, 32, 8), (1, 2, 16, 4)])
def test_trainable_grads_match_pallas_custom_vjp(shape):
    """torch.autograd.grad through `fused_attention_trainable` against
    jax.grad through the Pallas custom VJP, loss sum(sin(out)) as in
    tests/test_pallas_ops.py."""
    q, k, v = _arrays(shape, 3, seed=3)
    want = jax.grad(
        lambda a, b, c: jnp.sum(jnp.sin(jax_attention_trainable(a, b, c, True, 1, False, False))),
        argnums=(0, 1, 2))(*(jnp.asarray(z) for z in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(z).requires_grad_() for z in (q, k, v))
    out = attention.fused_attention_trainable(tq, tk, tv)
    got = torch.autograd.grad(out.sin().sum(), (tq, tk, tv))
    _assert_grads_close([g.numpy() for g in got], want)


def test_trainable_primal_is_the_forward():
    q, k, v = (torch.from_numpy(z) for z in _arrays((1, 2, 16, 8), 3, seed=4))
    torch.testing.assert_close(attention.fused_attention_trainable(q, k, v),
                               attention.fused_attention(q, k, v), rtol=0, atol=0)


def test_bf16_bwd_reference_keeps_the_rounding_points():
    """In bf16 the plain version rounds P to bf16 before dv and ds, and ds
    before dq/dk, as the Pallas kernel does: same inputs, both sides bf16,
    agreement to bf16 rounding of the results (2^-7 relative to max|g|)."""
    q, k, v, do = _arrays((1, 2, 16, 8), 4, seed=5)
    want = jax_attention_bwd(*(jnp.asarray(z, jnp.bfloat16) for z in (q, k, v, do)),
                             interpret=True)
    got = attention.fused_attention_bwd(*(torch.from_numpy(z).bfloat16() for z in (q, k, v, do)))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2 ** -7 * np.abs(w).max(), err_msg=name)


def test_cpu_tensors_do_not_count_launches():
    before = dict(attention.LAUNCHES)
    q, k, v = (torch.from_numpy(z).requires_grad_() for z in _arrays((1, 2, 16, 8), 3))
    attention.fused_attention_trainable(q, k, v).sum().backward()
    assert attention.LAUNCHES == before


def test_bwd_rejects_what_it_does_not_take():
    q = torch.zeros(1, 2, 16, 8)
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(q, q, q, torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(*(q.to("meta") for _ in range(4)))


def test_grouped_bwd_matches_pallas_grouped_kernel():
    """`heads_per_program=2` on both sides: the Pallas kernel runs two heads
    per program in interpret mode, the port's plain version is the same
    function whatever G is."""
    shape = (1, 4, 16, 8)
    q, k, v, do = _arrays(shape, 4, seed=6)
    want = jax_attention_bwd(*(jnp.asarray(z) for z in (q, k, v, do)), interpret=True,
                             heads_per_program=2)
    got = attention.fused_attention_bwd(*(torch.from_numpy(z) for z in (q, k, v, do)),
                                        heads_per_program=2)
    _assert_grads_close([g.numpy() for g in got], want)


def test_bwd_heads_per_program_rule():
    """As in the JAX wrapper, a G that does not divide the head count means
    1; G < 1 raises."""
    q, k, v, do = (torch.from_numpy(z) for z in _arrays((1, 4, 16, 8), 4, seed=7))
    base = attention.fused_attention_bwd(q, k, v, do)
    for group in (3, 4, 8):
        for g, w in zip(attention.fused_attention_bwd(q, k, v, do, heads_per_program=group),
                        base):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    for group in (0, -2):
        with pytest.raises(ValueError):
            attention.fused_attention_bwd(q, k, v, do, heads_per_program=group)


def test_trainable_passes_heads_per_program_to_the_backward(monkeypatch):
    seen = []
    bwd = attention.fused_attention_bwd

    def spy(*args, **kwargs):
        seen.append(args[4:] + tuple(kwargs.values()))
        return bwd(*args, **kwargs)

    monkeypatch.setattr(attention, "fused_attention_bwd", spy)
    q, k, v = (torch.from_numpy(z).requires_grad_() for z in _arrays((1, 4, 16, 8), 3))
    attention.fused_attention_trainable(q, k, v, heads_per_program=2).sum().backward()
    assert seen == [(2,)]


@pytest.mark.parametrize("shape", [(1, 2, 16, 8), (2, 4, 64, 8)])
def test_lse_reference_matches_jax_logsumexp(shape):
    """The forward's base-2 log-sum-exp: log2(e) times the natural one of
    the reference logits q k^T / sqrt(D). Both in f32 with the scale
    applied at different points: agreement to a few f32 ulps of values
    near log2(T), 1e-5."""
    q, k = _arrays(shape, 2, seed=8)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), jnp.asarray(k),
                        precision="highest") / np.sqrt(shape[-1])
    want = np.asarray(jax.nn.logsumexp(logits, axis=-1)) * np.log2(np.e)
    got = attention.attention_lse_reference(torch.from_numpy(q), torch.from_numpy(k))
    assert got.dtype == torch.float32 and got.shape == shape[:3]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def _kernel_order_inputs(shape, seed, dtype):
    q, k, v, do = (torch.from_numpy(z).to(dtype) for z in _arrays(shape, 4, seed=seed))
    o = attention.attention_reference(q, k, v)
    return q, k, v, do, o, attention.attention_lse_reference(q, k)


@pytest.mark.parametrize("shape", [(1, 2, 16, 8), (2, 4, 64, 8)])
def test_bwd_kernel_order_matches_pallas_bf16(shape):
    """The bf16 backward kernel's rounding order, fed the plain forward's
    bf16 output and log-sum-exp, against the Pallas backward in bf16
    (interpret mode): P from the log-sum-exp instead of a normalised
    softmax, and delta = do . o from the bf16 output instead of
    rowsum(dp P), change bf16 rounding only: 2^-7 relative to max|g|, as
    `test_bf16_bwd_reference_keeps_the_rounding_points`."""
    q, k, v, do, o, lse = _kernel_order_inputs(shape, 9, torch.bfloat16)
    want = jax_attention_bwd(*(jnp.asarray(z.float().numpy(), jnp.bfloat16)
                               for z in (q, k, v, do)), interpret=True)
    got = attention.attention_bwd_kernel_order(q, k, v, do, o, lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2 ** -7 * np.abs(w).max(), err_msg=name)


def test_bwd_kernel_order_is_the_gradient_in_f32():
    """In f32 the kernel's order is the same gradient as the Pallas one: P
    from the log-sum-exp and delta = do . o equal the normalised softmax
    and rowsum(dp P) in exact arithmetic; 5e-5 * max|g| as above."""
    shape = (2, 4, 64, 8)
    q, k, v, do, o, lse = _kernel_order_inputs(shape, 10, torch.float32)
    want = jax_attention_bwd(*(jnp.asarray(z.numpy()) for z in (q, k, v, do)), interpret=True)
    got = attention.attention_bwd_kernel_order(q, k, v, do, o, lse)
    _assert_grads_close([g.numpy() for g in got], want)


def test_statistics_come_from_the_cuda_kernel_only():
    """On the CPU the forward has no log-sum-exp output, and the backward
    is the plain version whatever statistics it is handed."""
    q, k, v, do = (torch.from_numpy(z) for z in _arrays((1, 2, 16, 8), 4, seed=11))
    with pytest.raises(ValueError):
        attention.fused_attention(q, k, v, with_lse=True)
    o, lse = attention.attention_reference(q, k, v), attention.attention_lse_reference(q, k)
    for g, w in zip(attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse),
                    attention.attention_bwd_reference(q, k, v, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
