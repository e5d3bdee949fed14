"""The attention knobs `fast_math` and `heads_per_program`: the port's
plain fast-math version against the JAX package's Pallas kernel (interpret
mode, as the JAX package's own tests run it), grouping, and the UNet with
the knobs set.

Tolerances. Fast math against the Pallas kernel: both round the shifted
logits to bf16 and exponentiate in bf16, but in two frameworks whose f32
exponential may differ in its last bit, which can move one weight by one
bf16 ulp; the result may differ by one bf16 ulp of the output, 2^-8
relative, held as rtol = atol = 2^-8 for f32 inputs and one bf16 ulp of the
bf16 output, 2^-6 at |x| < 4, for bf16 inputs. Grouping changes nothing on
the CPU (torch.equal), and the JAX side with the same G agrees at the f32
tolerance of `tests/test_pallas_ops.py`, 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.ops.pallas.attention import fused_attention as jax_fused_attention
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.ops import attention

from tests.torch_port_fixtures import jax_params, port_model

FAST_TOL = {np.float32: 2.0 ** -8, "bfloat16": 2.0 ** -6}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("token_minor", [False, True])
@pytest.mark.parametrize("shape", [(1, 2, 32, 8), (2, 4, 64, 8)])
def test_fast_math_matches_pallas_kernel(shape, token_minor, dtype):
    q, k, v = _qkv(shape, seed=3)
    want = np.asarray(jax_fused_attention(
        *(jnp.asarray(z, dtype) for z in (q, k, v)), interpret=True,
        fast_math=True, token_minor=token_minor).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(z).to(getattr(torch, dtype)) for z in (q, k, v))
    got = attention.fused_attention(tq, tk, tv, fast_math=True)
    assert got.dtype == tq.dtype
    assert torch.equal(got, attention.attention_fast_math_reference(tq, tk, tv))
    tol = FAST_TOL[np.float32 if dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_fast_math_is_near_exact():
    """The JAX package's own fast-math tolerance against exact attention
    (`tests/test_pallas_ops.py`: rtol 0.05, atol 0.02)."""
    q, k, v = (torch.from_numpy(z) for z in _qkv((2, 4, 64, 8), seed=4))
    fast = attention.fused_attention(q, k, v, fast_math=True)
    exact = attention.fused_attention(q, k, v)
    torch.testing.assert_close(fast, exact, rtol=0.05, atol=0.02)
    assert not torch.equal(fast, exact)


def _kernel_loop(q, k, v, step):
    """`attention_fwd.cu`'s fast-math walk in plain PyTorch, every row at
    once: keys `step` at a time (a staged tile of 64 on the kernels, any
    step here), the running max over the groups seen so far,
    bf16 exponentials of the base-2 logit minus it, an f32 rescale of the
    sum and accumulator when it moves, the division last."""
    t = q.shape[-2]
    scale_log2 = (torch.tensor(1.0 / np.sqrt(q.shape[-1]))
                  * torch.tensor(1.4426950408889634)).item()
    logits = torch.matmul(q.float() * scale_log2, k.float().transpose(-1, -2))
    m = torch.full(q.shape[:-1], -np.inf)
    total = torch.zeros(q.shape[:-1])
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],))
    for j in range(0, t, step):
        s = logits[..., j:j + step]
        new = torch.maximum(m, s.amax(dim=-1))
        c = torch.exp2(m - new)
        total, acc, m = total * c, acc * c[..., None], new
        p = torch.exp2((s - m[..., None]).to(torch.bfloat16)).float()
        total = total + p.sum(dim=-1)
        acc = acc + torch.matmul(p, v[..., j:j + step, :].float())
    return (acc / total[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 2, 33, 4), (2, 4, 64, 8)])
def test_kernel_order_follows_the_kernel(shape, dtype):
    """`attention_fast_math_kernel_order` at 2 keys per max update (the
    function takes any step; the kernels take 64) is the kernel walk at that
    step (up to f32 rounding of the rescale: 1e-5; bf16 output: one bf16 ulp, 2^-6 at
    |x| < 4), and it is fast math: within 1e-2 of the Pallas-order version
    and within the JAX package's fast-math tolerance of exact attention,
    but not exact."""
    q, k, v = (torch.from_numpy(z).to(dtype) for z in _qkv(shape, seed=9))
    got = attention.attention_fast_math_kernel_order(q, k, v, 2)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else FAST_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), _kernel_loop(q, k, v, 2).float(),
                               rtol=0, atol=tol)
    pallas_order = attention.attention_fast_math_reference(q, k, v).float()
    assert (got.float() - pallas_order).abs().max().item() <= 1e-2
    exact = attention.attention_reference(q, k, v).float()
    torch.testing.assert_close(got.float(), exact, rtol=0.05, atol=0.02)
    if dtype == torch.float32:
        assert (got - exact).abs().max().item() > 1e-4


def test_fast_math_step_names_the_kernel():
    """Keys per max update: a staged tile of 64 at every head_dim in both
    dtypes, head_dim 4 too (the tensor-core kernels run every head_dim)."""
    assert attention.fast_math_step(torch.zeros(1, 2, 16, 8, dtype=torch.bfloat16)) == 64
    assert attention.fast_math_step(torch.zeros(1, 2, 16, 8)) == 64
    assert attention.fast_math_step(torch.zeros(1, 2, 16, 4, dtype=torch.bfloat16)) == 64
    assert attention.fast_math_step(torch.zeros(1, 2, 16, 4)) == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 101, 8), (2, 4, 130, 8)])
def test_kernel_order_at_the_tensor_core_step(shape, dtype):
    """At 64 keys per max update (the tensor-core kernel; T = 101 and 130
    leave a short last tile) the order function is the walk at that step
    (the tolerances of `test_kernel_order_follows_the_kernel`), within 1e-2
    of the Pallas fast-math kernel, within the JAX package's fast-math
    tolerance of exact attention, and not exact in f32."""
    q, k, v = _qkv(shape, seed=10)
    tq, tk, tv = (torch.from_numpy(z).to(getattr(torch, dtype)) for z in (q, k, v))
    got = attention.attention_fast_math_kernel_order(tq, tk, tv, 64)
    tol = 1e-5 if dtype == "float32" else FAST_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), _kernel_loop(tq, tk, tv, 64).float(),
                               rtol=0, atol=tol)
    pallas = np.asarray(jax_fused_attention(
        *(jnp.asarray(z, dtype) for z in (q, k, v)), interpret=True,
        fast_math=True).astype(jnp.float32))
    assert np.abs(got.float().numpy() - pallas).max() <= 1e-2
    exact = attention.attention_reference(tq, tk, tv).float()
    torch.testing.assert_close(got.float(), exact, rtol=0.05, atol=0.02)
    if dtype == "float32":
        assert (got - exact).abs().max().item() > 1e-4


def test_bf16_fast_math_separates_from_exact():
    """What `chip_smoke.py` tells the bf16 tensor-core fast math from exact
    attention by, on the plain versions: at logits 8x wider, exact attention
    lies on average more than 10x as far from the fast-math rounding order
    (64 keys per max update) as the kernel's walk does. The walk differs
    from the order function only in f32 rounding (the rescale), which
    rarely moves a bf16 output; exact attention differs at every weight by
    the bf16 rounding of its shifted logit."""
    q, k, v = (torch.from_numpy(z).bfloat16() for z in _qkv((2, 4, 256, 8), seed=11))
    q = (q.float() * 8).bfloat16()
    order = attention.attention_fast_math_kernel_order(q, k, v, 64).float()
    walk = (_kernel_loop(q, k, v, 64).float() - order).abs()
    exact = (attention.attention_reference(q, k, v).float() - order).abs()
    assert walk.max().item() <= FAST_TOL["bfloat16"]
    assert exact.mean().item() > 10 * walk.mean().item()


@pytest.mark.parametrize("fast_math", [False, True])
def test_heads_per_program(fast_math):
    """G in {1, 2, 4, 3} (3 does not divide 4 heads: it means 1) gives the
    same tensor on the CPU; the Pallas kernel with the same G agrees."""
    q, k, v = _qkv((2, 4, 64, 8), seed=5)
    tq, tk, tv = (torch.from_numpy(z) for z in (q, k, v))
    base = attention.fused_attention(tq, tk, tv, fast_math=fast_math)
    for g in (1, 2, 4, 3):
        got = attention.fused_attention(tq, tk, tv, fast_math=fast_math,
                                        heads_per_program=g)
        assert torch.equal(got, base), g
        want = np.asarray(jax_fused_attention(
            *(jnp.asarray(z) for z in (q, k, v)), interpret=True,
            heads_per_program=g, fast_math=fast_math))
        tol = 2e-5 if not fast_math else FAST_TOL[np.float32]
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_trainable_takes_the_knobs():
    """The trainable forward is the fast-math primal; its backward is the
    f32-softmax derivative, the same as without fast math."""
    q, k, v = (torch.from_numpy(z).requires_grad_() for z in _qkv((1, 2, 32, 8), seed=6))
    do = torch.from_numpy(_qkv((1, 2, 32, 8), seed=7)[0])
    out = attention.fused_attention_trainable(q, k, v, True, 2)
    assert torch.equal(out.detach(), attention.attention_fast_math_reference(q, k, v).detach())
    grads = torch.autograd.grad(out, (q, k, v), do)
    want = attention.attention_bwd_reference(q.detach(), k.detach(), v.detach(), do)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_unet_with_fast_math():
    """`fused_fast_math=True` (on the CPU: the plain fast-math version) stays
    within bf16-level tolerance of the exact UNet, and the default fields
    give exactly the model without them."""
    params = jax_params()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 3, 32, 32))
                         .astype(np.float32))
    t = torch.tensor([10, 900])
    with torch.inference_mode():
        plain = port_model(params)(x, t)
        fused = port_model(params, use_fused_attention=True)(x, t)
        default = port_model(params, use_fused_attention=True,
                             fused_heads_per_program=1, fused_fast_math=False)(x, t)
        fast = port_model(params, use_fused_attention=True, fused_fast_math=True,
                          fused_heads_per_program=2)(x, t)
    assert torch.equal(default, fused)
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-5)
    err = (fast - plain).abs().max().item()
    assert 0 < err <= 2 ** -6 * plain.abs().max().item()
    blocks = [m for m in port_model(params, fused_fast_math=True).modules()
              if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.fused_fast_math and b.fused_heads_per_program == 1
                          for b in blocks)
    assert isinstance(port_model(params), UNet2D)
