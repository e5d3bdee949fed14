"""The f32 tensor-core backward's rounding (`attention_bwd_tf32x3_kernel_order`:
3xTF32 products from the forward's output and base-2 log-sum-exp, per-tile
partial sums) against the JAX package's Pallas backward in f32, on the CPU.

The Pallas kernel runs in interpret mode, as the JAX package's own tests
run it. Tolerance: `atol = 5e-5 * max|g|` per gradient, the one
`tests/test_pallas_ops.py` holds the Pallas backward to. 3xTF32 carries
each product to about 2^-21 of it, as f32 does, and meets that; one TF32
pass, or one or two passes on any single product, misses it, and the tests
show that they can tell them apart. The kernel itself runs only on a GPU:
`tests/test_torch_gpu.py` holds it against this order.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.ops.pallas.attention import fused_attention_bwd as jax_attention_bwd
from synt_isic_tpu_torch.ops import attention

from tests.torch_port_fixtures import TINY, jax_params, nchw, port_model

TOL = 5e-5
# (1, 2, 16, 8) a single key tile, (2, 4, 64, 8) a full one, 37 a ragged T
SHAPES = [(1, 2, 16, 8), (2, 4, 64, 8), (1, 2, 37, 8)]
# `_tf32x3_matmul` calls of the order function, in order: S, dP, then per
# 64-row tile dq, dk, dv
PRODUCTS = ["S", "dP", "dQ", "dK", "dV"]


@functools.cache
def _case(shape):
    """(q, k, v, do) as numpy f32 from a seed, the Pallas backward's
    gradients, and o and lse from the plain forward."""
    rng = np.random.default_rng(sum(shape))
    arrays = tuple(rng.normal(size=shape).astype(np.float32) for _ in range(4))
    want = [np.asarray(g) for g in
            jax_attention_bwd(*(jnp.asarray(z) for z in arrays), interpret=True)]
    q, k, v, _ = (torch.from_numpy(z) for z in arrays)
    return arrays, want, attention.attention_reference(q, k, v), attention.attention_lse_reference(q, k)


def _order(shape):
    arrays, want, o, lse = _case(shape)
    got = attention.attention_bwd_tf32x3_kernel_order(*(torch.from_numpy(z) for z in arrays), o, lse)
    return [g.numpy() for g in got], want


def _worst_ratio(got, want):
    """The largest max|diff| / (TOL max|g|) over dq, dk, dv."""
    return max(np.abs(g - w).max() / (TOL * np.abs(w).max()) for g, w in zip(got, want))


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_order_matches_pallas_bwd(shape):
    got, want = _order(shape)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_misses_the_tolerance(shape, monkeypatch):
    """The same order with every lo part dropped (hi.hi only, one TF32 pass)
    lies several times the tolerance from the Pallas backward on the same
    inputs: the check above tells the split from plain TF32."""
    split = attention.tf32_split
    monkeypatch.setattr(attention, "tf32_split", lambda x: (split(x)[0], torch.zeros_like(x)))
    assert _worst_ratio(*_order(shape)) > 5


@pytest.mark.parametrize("passes", [1, 2])
@pytest.mark.parametrize("product", PRODUCTS)
def test_every_product_needs_three_passes(product, passes, monkeypatch):
    """With one product at one TF32 pass (hi.hi) or two (hi.hi + hi.lo) and
    the other four at three, the gradients miss the tolerance: the kernel
    keeps all three passes on every product."""
    full = attention._tf32x3_matmul
    calls = []

    def fewer(a, b):
        index = len(calls)
        calls.append(index)
        name = PRODUCTS[index] if index < 2 else PRODUCTS[2 + (index - 2) % 3]
        if name != product:
            return full(a, b)
        ah, al = attention.tf32_split(a)
        bh, bl = attention.tf32_split(b)
        out = torch.matmul(ah, bh)
        return out if passes == 1 else torch.matmul(ah, bl) + out

    monkeypatch.setattr(attention, "_tf32x3_matmul", fewer)
    shape = (2, 4, 64, 8)
    assert _worst_ratio(*_order(shape)) > 2
    assert len(calls) == 5    # S, dP and one tile of dq, dk, dv


def test_kernel_order_is_not_on_the_cpu_path(monkeypatch):
    """On the CPU the UNet's fused attention backward runs
    `attention_bwd_reference`; the kernel order serves only to check the
    card's kernel."""
    def refuse(*args):
        raise AssertionError("attention_bwd_tf32x3_kernel_order on the CPU path")

    calls = []
    reference = attention.attention_bwd_reference

    def spy(*args):
        calls.append(args[0].shape)
        return reference(*args)

    monkeypatch.setattr(attention, "attention_bwd_tf32x3_kernel_order", refuse)
    monkeypatch.setattr(attention, "attention_bwd_reference", spy)
    model = port_model(jax_params(), TINY, use_fused_attention=True)
    x = np.random.default_rng(2).normal(size=(2, TINY.sample_size, TINY.sample_size, 3))
    model(nchw(x.astype(np.float32)), torch.tensor([10, 900])).square().mean().backward()
    assert len(calls) >= 2 and all(shape[-1] == TINY.attention_head_dim for shape in calls)
    assert all(p.grad is not None for p in model.parameters() if p.requires_grad)
