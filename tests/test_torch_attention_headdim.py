"""The attention core at head_dims other than 8, the port against the JAX
package's Pallas kernels on the CPU.

The Pallas kernels take any head_dim (their blocks hold the whole D) and
any heads_per_program G that divides the heads; the port's kernels run
every head_dim >= 1 (a staged width of 8, 16, 32 or 64 channels, above that
chunks of 64), at every such G. On the CPU the port's wrappers run their
plain versions, and the JAX kernels run in interpret mode, as the JAX
package's own tests run them. Here, at D = 4, 16, 32 and 64, and at the
wide heads D = 128 (2 heads), 256, 300, 384 and 512 (1 head) at T <= 64:
the port's plain forward and the
plain version of the f32 kernel's rounding (`attention_tf32x3_kernel_order`)
against the Pallas forward, rtol = atol = 2e-5; the fast-math plain version
and the fast-math kernel's rounding order (`fast_math_kernel_order`) against
the Pallas fast-math forward within the JAX package's fast-math tolerance
(rtol 0.05, atol 0.02); the plain backward and the f32 backward kernel's
order against the Pallas backward within 5e-5 * max|g| (the tolerances of
`tests/test_pallas_ops.py`); bf16 within one bf16 ulp of the output (2^-6 at
|x| < 4) forward and 2e-2 * max|g| backward, as `tests/test_torch_gpu.py`
holds the kernels. G = 16 at 32 heads of 8 and G = 2 at 2 heads of 128
against the Pallas kernels at that G. Then a tiny UNet at head_dim 16 and
a small one whose attention blocks are one head of 512 channels against the
JAX model, and the wrapper's route table: which (head_dim, G) the kernels
take and how many heads a block runs. The kernels themselves
run only on a GPU (`tests/test_torch_gpu.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from synt_isic_tpu.ops.pallas.attention import fused_attention_bwd as jax_fused_attention_bwd
from synt_isic_tpu_torch.ops import attention

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params, nchw, port_model

HEAD_DIMS = (4, 16, 32, 64)
SEQ_LENS = (16, 64, 101)
# the wide heads at T <= 64: (head_dim, T), at 2 heads of 128 and 1 of 256,
# 300 (not a multiple of 64), 384 and 512
WIDE_CASES = ((128, 64), (256, 40), (300, 37), (384, 40), (512, 24))
CASES = [(d, t) for d in HEAD_DIMS for t in SEQ_LENS] + list(WIDE_CASES)
TOL = 2e-5
FAST = {"rtol": 0.05, "atol": 0.02}
GRAD_TOL = 5e-5
BF16_TOL, BF16_GRAD_TOL = 2.0 ** -6, 2e-2


def _inputs(d, t, seed, heads=None, n=4):
    heads = heads or (1 if d > 128 else 2)
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, heads, t, d)).astype(np.float32) for _ in range(n)]


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(z).to(dtype) for z in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(z, dtype) for z in arrays]


def _grads_close(got, want, tol):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        a, w = np.asarray(a, np.float32), np.asarray(w, np.float32)
        np.testing.assert_allclose(a, w, rtol=0, atol=tol * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("d, t", CASES)
def test_forward_matches_pallas(d, t):
    q, k, v, _ = _inputs(d, t, seed=d + t)
    want = np.asarray(jax_fused_attention(*_jax(q, k, v), interpret=True))
    tq, tk, tv = _torch(q, k, v)
    np.testing.assert_allclose(attention.fused_attention(tq, tk, tv).numpy(), want,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(attention.attention_tf32x3_kernel_order(tq, tk, tv).numpy(),
                               want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d, t", [(d, t) for d in HEAD_DIMS for t in (SEQ_LENS[0], SEQ_LENS[-1])]
                         + list(WIDE_CASES))
def test_fast_math_matches_pallas(d, t):
    """The Pallas fast-math branch (bf16 exponentials of the natural-log
    logits against the row's max) beside the port's plain version of it
    and the kernel's own rounding (base-2 logits against a max that moves
    per tile of 64 keys, 3xTF32 logits in f32)."""
    q, k, v, _ = _inputs(d, t, seed=2 * d + t)
    want = np.asarray(jax_fused_attention(*_jax(q, k, v), interpret=True, fast_math=True))
    tq, tk, tv = _torch(q, k, v)
    assert attention.fast_math_step(tq) == 64
    np.testing.assert_allclose(attention.fused_attention(tq, tk, tv, fast_math=True).numpy(),
                               want, **FAST)
    np.testing.assert_allclose(attention.fast_math_kernel_order(tq, tk, tv).numpy(), want,
                               **FAST)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_grouped_matches_pallas(d):
    """The widest G the kernels take at this head_dim (G times the staged
    width at most 64, dividing the 4 heads): the Pallas kernel at that G,
    exact and fast math, against the port's call at the same G."""
    q, k, v, _ = _inputs(d, 64, seed=3 * d, heads=4)
    tq, tk, tv = _torch(q, k, v)
    groups = [g for g in (2, 4) if g * attention.staged_width(d) <= attention.MAX_GROUP_WIDTH]
    assert groups or d == 64
    for g in groups[-1:]:
        for fast_math in (False, True):
            want = np.asarray(jax_fused_attention(*_jax(q, k, v), interpret=True,
                                                  heads_per_program=g, fast_math=fast_math))
            got = attention.fused_attention(tq, tk, tv, fast_math=fast_math, heads_per_program=g)
            tol = FAST if fast_math else {"rtol": TOL, "atol": TOL}
            np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=f"G {g}")


@pytest.mark.parametrize("d, t", CASES)
def test_backward_matches_pallas(d, t):
    """The Pallas recompute backward against the port's plain backward and
    the f32 backward kernel's rounding order, which reads the forward's
    output and base-2 log-sum-exp as the kernels do."""
    q, k, v, do = _inputs(d, t, seed=5 * d + t)
    want = jax_fused_attention_bwd(*_jax(q, k, v, do), interpret=True)
    tq, tk, tv, tdo = _torch(q, k, v, do)
    _grads_close(attention.fused_attention_bwd(tq, tk, tv, tdo), want, GRAD_TOL)
    o = attention.attention_tf32x3_kernel_order(tq, tk, tv)
    lse = attention.attention_lse_reference(tq, tk)
    _grads_close(attention.attention_bwd_tf32x3_kernel_order(tq, tk, tv, tdo, o, lse), want,
                 GRAD_TOL)


@pytest.mark.parametrize("d", HEAD_DIMS + tuple(d for d, _ in WIDE_CASES))
def test_bf16_matches_pallas(d):
    """bf16 inputs, forward and backward: the port's plain versions and the
    bf16 backward kernel's rounding order against the Pallas kernels."""
    q, k, v, do = _inputs(d, 64, seed=7 * d)
    want = np.asarray(jax_fused_attention(*_jax(q, k, v, dtype=jnp.bfloat16), interpret=True)
                      .astype(jnp.float32))
    tq, tk, tv, tdo = _torch(q, k, v, do, dtype=torch.bfloat16)
    got = attention.fused_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)
    grads = [z.astype(jnp.float32)
             for z in jax_fused_attention_bwd(*_jax(q, k, v, do, dtype=jnp.bfloat16),
                                              interpret=True)]
    _grads_close([z.float() for z in attention.fused_attention_bwd(tq, tk, tv, tdo)], grads,
                 BF16_GRAD_TOL)
    lse = attention.attention_lse_reference(tq, tk)
    order = attention.attention_bwd_kernel_order(tq, tk, tv, tdo, got, lse)
    _grads_close([z.float() for z in order], grads, BF16_GRAD_TOL)


@pytest.mark.parametrize("heads, t, d, g", [(32, 16, 8, 16), (2, 16, 128, 2)])
def test_any_group_matches_pallas(heads, t, d, g):
    """A G the kernels' blocks do not hold at once (16 heads of 8, 2 heads
    of 128): the Pallas kernels at that G, forward exact and fast math and
    backward, against the port's calls at the same G, which run G / G'
    consecutive groups of G' heads (`block_group`)."""
    q, k, v, do = _inputs(d, t, seed=11 * d + g, heads=heads)
    tq, tk, tv, tdo = _torch(q, k, v, do)
    assert attention._group(heads, g) == g
    assert attention.block_group(g, d, torch.float32, True) in ((8,) if d == 8 else (1,))
    for fast_math in (False, True):
        want = np.asarray(jax_fused_attention(*_jax(q, k, v), interpret=True,
                                              heads_per_program=g, fast_math=fast_math))
        got = attention.fused_attention(tq, tk, tv, fast_math=fast_math, heads_per_program=g)
        tol = FAST if fast_math else {"rtol": TOL, "atol": TOL}
        np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=f"fast_math {fast_math}")
    want = jax_fused_attention_bwd(*_jax(q, k, v, do), interpret=True, heads_per_program=g)
    _grads_close(attention.fused_attention_bwd(tq, tk, tv, tdo, heads_per_program=g), want,
                 GRAD_TOL)


def test_unet_at_head_dim_16_matches_jax():
    """The tiny UNet with attention_head_dim 16 (the weights' shapes do not
    depend on it): the port with its fused attention on (the plain version
    on the CPU) against the JAX model, f32, within the 1e-4 of
    `tests/test_torch_unet.py`; and the head_dim changes what it computes."""
    params = jax_params()
    rng = np.random.default_rng(1)
    x, t = rng.normal(size=(2, 16, 16, 3)).astype(np.float32), np.array([5, 900])
    jmodel = JaxUNet2D(config=dataclasses.replace(TINY_JAX, attention_head_dim=16))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))(
            params, jnp.asarray(x), jnp.asarray(t)))
    outs = {}
    for head_dim in (16, TINY.attention_head_dim):
        model = port_model(params, dataclasses.replace(TINY, attention_head_dim=head_dim),
                           use_fused_attention=True)
        with torch.no_grad():
            outs[head_dim] = model(nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(outs[16], want, rtol=1e-4, atol=1e-4)
    assert np.abs(outs[16] - outs[TINY.attention_head_dim]).max() > 1e-3


# a small UNet whose attention blocks (the second level's and the middle's)
# are 512 channels wide, at attention_head_dim 512: one head of 512
UNET_512 = dict(sample_size=8, layers_per_block=1, block_out_channels=(8, 512),
                attention_head_dim=512, norm_num_groups=4,
                down_block_types=("DownBlock2D", "AttnDownBlock2D"),
                up_block_types=("AttnUpBlock2D", "UpBlock2D"))


def test_unet_at_head_dim_512_matches_jax(monkeypatch):
    """The small UNet of UNET_512, weights carried across from the JAX tree
    (`state_dict_from_jax`): the port with its fused attention on (the
    plain version on the CPU, one head of 512 channels a call) against the
    JAX model, f32, within the 1e-4 of `tests/test_torch_unet.py`; every
    attention call of the port is one head of 512."""
    from synt_isic_tpu.models.unet2d import UNet2DConfig as JaxUNet2DConfig
    from synt_isic_tpu_torch.models.unet2d import UNet2DConfig

    jcfg = JaxUNet2DConfig(**UNET_512)
    params = jax_params(jcfg, seed=4)
    rng = np.random.default_rng(2)
    x, t = rng.normal(size=(2, 8, 8, 3)).astype(np.float32), np.array([7, 800])
    jmodel = JaxUNet2D(config=jcfg)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))(
            params, jnp.asarray(x), jnp.asarray(t)))
    model = port_model(params, UNet2DConfig(**UNET_512), use_fused_attention=True)
    shapes = []
    plain = attention.attention_reference

    def spy(q, k, v):
        shapes.append(tuple(q.shape))
        return plain(q, k, v)

    monkeypatch.setattr(attention, "attention_reference", spy)
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert shapes and all(s[1] == 1 and s[3] == 512 for s in shapes), shapes


def test_route_table():
    """Which calls the CUDA kernels take, read without a card: every
    head_dim >= 1, and only head_dim 0 (or less) raises; up to 256 channels
    a head has a staged width (the least of 8, 16, 32, 64, 128, 256 that
    holds it), above none; the f32 order limits' width (`staged_channels`) is
    the staged width up to 64, above it the head's 64-channel chunks;
    heads wider than 64 run the wide kernels (the bf16 forward above 256,
    `uses_wide`; below, from a staged width of 16, the warpgroup kernel,
    `uses_wgmma`); every G >= 1 that divides the heads runs (a G that does
    not divide them means 1, and G 0 raises), as G / G' consecutive groups
    of the G' heads one block runs (`block_group`): the widest of 1, 2, 4, 8
    that divides G with G' times the staged width at most 64 on a wide
    layout, else 1, and 1 for the bf16 forward at a staged width of 16 or
    more (the warpgroup kernel) and for the wide kernels (one head a
    block)."""
    for d in (1, 64, 65, 256, 257, 300, 512, 513, 4096):
        attention._check_head_dim(d)
    widths = {d: attention.staged_width(d)
              for d in (1, 4, 8, 9, 16, 17, 32, 33, 64, 65, 100, 128, 129, 256)}
    assert widths == {1: 8, 4: 8, 8: 8, 9: 16, 16: 16, 17: 32, 32: 32, 33: 64, 64: 64, 65: 128,
                      100: 128, 128: 128, 129: 256, 256: 256}
    assert sorted({attention.staged_width(d) for d in range(1, 257)}) == list(
        attention.STAGED_WIDTHS)
    for d in (257, 512):
        with pytest.raises(ValueError, match="no staged width"):
            attention.staged_width(d)
    # a wide layout: the head fills the channels it is staged in
    assert [attention._wide(torch.zeros(1, 1, 4, d)) for d in (5, 8, 64, 100, 128, 300, 320)] \
        == [False, True, True, False, True, False, True]
    assert {d: attention.staged_channels(d) for d in (4, 64, 65, 128, 129, 256, 300, 320, 512, 1000)} \
        == {4: 8, 64: 64, 65: 128, 128: 128, 129: 192, 256: 256, 300: 320, 320: 320, 512: 512,
            1000: 1024}
    for bad in (0, -1):
        with pytest.raises(ValueError, match="head_dim >= 1"):
            attention._check_head_dim(bad)
    for heads in (1, 2, 6, 8, 32):
        for g in range(1, 2 * heads + 1):
            assert attention._group(heads, g) == (g if heads % g == 0 else 1), (heads, g)
    with pytest.raises(ValueError, match=">= 1"):
        attention._group(8, 0)
    for dtype in (torch.float32, torch.bfloat16):
        for forward in (True, False):
            blocks = {w: attention.block_group(16, w, dtype, True, forward)
                      for w in attention.STAGED_WIDTHS + (384, 512)}
            wgmma = dtype == torch.bfloat16 and forward
            assert blocks == {8: 8, 16: 1 if wgmma else 4, 32: 1 if wgmma else 2, 64: 1, 128: 1,
                              256: 1, 384: 1, 512: 1}, (dtype, forward)
    for d in tuple(range(1, 257)) + (300, 512):
        for g in (1, 2, 3, 4, 6, 8, 12, 16, 32):
            gp = attention.block_group(g, d, torch.float32, True)
            assert g % gp == 0 and gp in attention.HEADS_PER_PROGRAM
            assert gp == 1 or gp * attention.staged_width(d) <= attention.MAX_GROUP_WIDTH
            assert attention.block_group(g, d, torch.float32, False) == 1
    assert [attention.block_group(g, 8, torch.float32, True) for g in (3, 6, 12, 16)] == [1, 2, 4, 8]
    assert [attention.uses_wgmma(torch.bfloat16, d) for d in (4, 8, 9, 64, 256, 257, 512)] == [
        False, False, True, True, True, False, False]
    assert not attention.uses_wgmma(torch.float32, 64)
    assert [attention.uses_wide(torch.float32, d) for d in (64, 65, 256, 257, 512)] == [
        False, True, True, True, True]
    assert [attention.uses_wide(torch.bfloat16, d) for d in (64, 65, 256, 257, 512)] == [
        False, False, False, True, True]
    assert [attention.uses_wide(dt, d, forward=False) for dt in (torch.float32, torch.bfloat16)
            for d in (64, 65, 512)] == [False, True, True] * 2
    assert attention._group(6, 4) == 1
    assert attention._group(32, 16) == 16
