"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test is marked `gpu` and skips without CUDA.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: f32 as the Pallas kernels are held to their einsum reference
(`tests/test_pallas_ops.py`: 2e-5 for the forward, 5e-5 * max|g| for the
backward); bf16 one bf16 ulp of the forward's output, 2^-6 at |x| < 4, and
2e-2 * max|g| for the backward (the whole-UNet gradient tolerance there),
since the kernels and the plain versions round at different points. The
fast-math forward: within 1e-2 of its plain version (both take bf16
exponentials, relative to different maxima), within the JAX package's
fast-math tolerance of exact attention (rtol 0.05, atol 0.02), and near the
plain version of its own rounding order at the kernel's keys per max update
(`fast_math_kernel_order`): in f32 (the 3xTF32 tensor-core kernels, at
every head_dim) each output within FAST_FLIPS moves of one bf16 flip of a
weight (`_flip_bound`, derived in `chip_smoke.py` at FLIP_MOVE), a limit
the exact kernel misses; in bf16 one bf16 ulp, as TOL;
at head_dim 8 in both dtypes, at logits 8x wider, the exact kernel's mean
distance from that order exceeds the fast kernel's FAST_SEPARATION times
(`chip_smoke.py` gives the reason for the factor). Head grouping, forward
and backward: bit-identical to one head per block. Head_dims other than 8
(`test_head_dim_*`): the same checks at D 4, 16, 32 and 64, the f32
kernels against their rounding orders within head_dim 8's limits times
sqrt(W / 8), W = `attention.staged_channels` (`chip_smoke.py` `tf32_order_tol`).
"""
import json
import math

import numpy as np
import pytest
import torch

from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.model_manager import ModelManager
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.ops import attention

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
FAST_ORDER_TOL = {torch.bfloat16: 2.0 ** -6}
FLIP_MOVE, FAST_FLIPS = 2.0 ** -7, 1
FAST_SEPARATION = 10.0


def _flip_bound(q, k, v, order):
    """Per output, the most one bf16 flip of a weight can move it:
    FLIP_MOVE * max_j |v_j - o_i| / l_i, l_i the row's weight sum in units
    of its largest weight (`chip_smoke.py` FLIP_MOVE)."""
    logits = torch.matmul(q.float() * attention._scale_log2(q.shape[-1]),
                          k.float().transpose(-1, -2))
    total = torch.exp2(logits - logits.amax(dim=-1, keepdim=True)).sum(dim=-1, keepdim=True)
    vf = v.float()
    spread = torch.maximum(vf.amax(dim=-2, keepdim=True) - order,
                           order - vf.amin(dim=-2, keepdim=True))
    return FLIP_MOVE * spread / total


def _order_limit(q, k, v, order):
    """What the fast kernel may lie from its rounding order, per output."""
    if q.dtype == torch.float32:
        return FAST_FLIPS * _flip_bound(q, k, v, order)
    return FAST_ORDER_TOL[q.dtype]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 1024, 8), (8, 32, 256, 8), (1, 2, 100, 4)])
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    before = attention.LAUNCHES[attention.KERNEL]
    got = attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.KERNEL] == before + 1
    want = attention.attention_reference(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_attention_kernel_strided_btc(cuda):
    b, h, t, d = 2, 32, 256, 8
    g = torch.Generator(device=cuda).manual_seed(1)
    btc = [torch.randn(b, t, h * d, generator=g, device=cuda) for _ in range(3)]
    views = [z.view(b, t, h, d).transpose(1, 2) for z in btc]
    got = attention.fused_attention(*views)
    assert got.stride() == views[0].stride()
    want = attention.attention_reference(*(z.contiguous() for z in views))
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])


def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(1, 2, 16, 0, device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q)                 # head_dim 0
    q = torch.zeros(1, 2, 16, 8, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q)                 # float16


def test_unet_runs_the_kernel(cuda, monkeypatch):
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    torch.manual_seed(0)
    state = UNet2D(cfg).state_dict()
    outs = {}
    # full-f32 convolutions on both sides: under TF32 a 1e-6 change in an
    # attention output can flip a TF32 rounding (2^-11 relative) downstream
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for fused in (True, False):
        model = UNet2D(cfg, use_fused_attention=fused)
        model.load_state_dict(state)
        x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1))
        before = attention.LAUNCHES[attention.KERNEL]
        with torch.inference_mode():
            outs[fused] = model.to(cuda)(x.to(cuda), torch.tensor([10, 900], device=cuda))
        assert attention.LAUNCHES[attention.KERNEL] - before == (6 if fused else 0)
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-4, atol=1e-4)


BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 1024, 8), (8, 32, 256, 8), (1, 2, 100, 4)])
def test_attention_bwd_kernel_matches_plain(cuda, shape, dtype, layout):
    b, h, t, d = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(4))
    args = (q, k, v, do)
    if layout == "BTC":      # (B, T, C) tensors split into heads by a view
        args = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                for z in args]
    before = attention.LAUNCHES[attention.BWD_KERNEL]
    got = attention.fused_attention_bwd(*args)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.BWD_KERNEL] == before + 1
    want = attention.attention_bwd_reference(q, k, v, do)
    for name, a, w, src in zip(("dq", "dk", "dv"), got, want, args[:3]):
        assert a.dtype == dtype and a.stride() == src.stride(), name
        tol = BWD_TOL[dtype] * w.float().abs().max().item()
        torch.testing.assert_close(a.float(), w.float(), rtol=0, atol=tol, msg=name)


def test_fused_attention_refuses_grad_on_cuda(cuda):
    q = torch.randn(1, 2, 16, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_attention_trainable"):
        attention.fused_attention(q, q, q)
    with torch.no_grad():                      # no graph: the forward kernel runs
        attention.fused_attention(q, q, q)


def test_unet_gradients_through_the_kernels(cuda, monkeypatch):
    """A backward through `UNet2D(use_fused_attention=True)` on CUDA gives
    every attention projection a gradient, through the forward and backward
    kernels, and they match the plain path (f32, full-f32 convolutions,
    1e-3 * max|g| per parameter). The key bias's gradient is zero in exact
    arithmetic (softmax ignores a shift shared by every key): there both
    sides are rounding noise, held to 1e-3 of the largest gradient. Groups
    of two channels: with one channel per group, GroupNorm would cancel the
    first block's biases and time projection exactly, and those gradients
    would be noise too."""
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64),
                       norm_num_groups=16)
    torch.manual_seed(0)
    state = UNet2D(cfg).state_dict()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)).to(cuda)
    eps = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(2)).to(cuda)
    t = torch.tensor([10, 900], device=cuda)
    grads = {}
    for fused in (True, False):
        model = UNet2D(cfg, use_fused_attention=fused)
        model.load_state_dict(state)
        model.to(cuda)
        before = dict(attention.LAUNCHES)
        torch.mean((model(x, t) - eps) ** 2).backward()
        torch.cuda.synchronize()
        want = 6 if fused else 0
        assert attention.LAUNCHES[attention.KERNEL] - before[attention.KERNEL] == want
        assert attention.LAUNCHES[attention.BWD_KERNEL] - before[attention.BWD_KERNEL] == want
        grads[fused] = {n: p.grad for n, p in model.named_parameters()}
    largest = max(g.abs().max().item() for g in grads[False].values())
    for name, g in grads[True].items():
        if any(p in name for p in ("to_q.", "to_k.", "to_v.")) and name.endswith("weight"):
            assert g is not None and g.abs().max().item() > 0, name
        w = grads[False][name]
        scale = largest if name.endswith("to_k.bias") else w.abs().max().item()
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3 * scale, msg=name)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 1024, 8), (8, 32, 256, 8), (1, 2, 101, 4)])
def test_fast_math_kernel_matches_plain(cuda, shape, dtype, layout):
    b, h, t, d = shape
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype) for _ in range(3))
    args = (q, k, v)
    if layout == "BTC":
        args = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                for z in args]
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention(*args, fast_math=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.FAST_KERNEL] == before[attention.FAST_KERNEL] + 1
    assert attention.LAUNCHES[attention.KERNEL] == before[attention.KERNEL]
    assert got.dtype == dtype and got.stride() == args[0].stride()
    plain = attention.attention_fast_math_reference(q, k, v).float()
    assert (got.float() - plain).abs().max().item() <= 1e-2
    exact = attention.attention_reference(q, k, v).float()
    torch.testing.assert_close(got.float(), exact, rtol=0.05, atol=0.02)
    order = attention.fast_math_kernel_order(q, k, v)
    limit = _order_limit(q, k, v, order)
    assert ((got.float() - order).abs() <= limit).all()
    if dtype == torch.float32:
        exact_kernel = attention.fused_attention(*args).float()
        assert not ((exact_kernel - order).abs() <= limit).all()


@pytest.mark.parametrize("fast_math", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernel_is_bit_identical(cuda, dtype, fast_math):
    b, h, t, d = 2, 32, 1024, 8
    g = torch.Generator(device=cuda).manual_seed(6)
    btc = [torch.randn(b, t, h * d, generator=g, device=cuda).to(dtype) for _ in range(3)]
    views = [z.view(b, t, h, d).transpose(1, 2) for z in btc]
    base = attention.fused_attention(*views, fast_math=fast_math)
    # 16 and 32 run as groups of 8 heads a block; 3 does not divide 32 heads: it means 1
    for group in (2, 4, 8, 16, 32, 3):
        before = attention.LAUNCHES[attention.GROUPED_KERNEL]
        got = attention.fused_attention(*views, fast_math=fast_math,
                                        heads_per_program=group)
        torch.cuda.synchronize()
        assert attention.LAUNCHES[attention.GROUPED_KERNEL] == before + (group != 3)
        assert torch.equal(got, base), group
    q = torch.zeros(1, 32, 16, 8, device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q, heads_per_program=0)


def test_model_manager_moved_to_cuda_runs_the_kernels(cuda, tmp_path):
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), tmp_path / "unet_MEL_best.pth")
    mm = ModelManager(str(tmp_path), device="cpu", model_config=cfg,
                      dtype=torch.bfloat16)
    assert mm.load_model("MEL")
    mm.set_attention_tuning(heads_per_program=2, fast_math=True)
    assert mm.change_device("cuda") and mm.validate_model("MEL")
    assert mm.use_fused_attention and mm.fast_norm
    blocks = [m for m in mm.loaded_models["MEL"].modules()
              if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.use_fused and b.fused_fast_math
                          and b.fused_heads_per_program == 2 for b in blocks)
    before = dict(attention.LAUNCHES)
    out = mm.create_sampler(2, scheduler="ddim").sample(mm.loaded_models["MEL"], [1, 2])
    torch.cuda.synchronize()
    assert torch.isfinite(out["images"]).all()
    got = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert got[attention.FAST_KERNEL] == got[attention.GROUPED_KERNEL] == 2 * 6
    assert got[attention.KERNEL] == 0


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_bwd_kernel_is_bit_identical(cuda, dtype, layout):
    """The backward at G heads per block gives dq, dk and dv equal to G = 1
    bit for bit, and counts a grouped launch beside the backward's."""
    b, h, t, d = 2, 32, 1024, 8
    g = torch.Generator(device=cuda).manual_seed(7)
    args = [torch.randn(b, h, t, d, generator=g, device=cuda).to(dtype) for _ in range(4)]
    if layout == "BTC":
        args = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                for z in args]
    base = attention.fused_attention_bwd(*args)
    # 16 runs as two groups of 8 heads a block; 3 does not divide 32 heads: it means 1
    for group in (2, 4, 8, 16, 3):
        before = dict(attention.LAUNCHES)
        got = attention.fused_attention_bwd(*args, heads_per_program=group)
        torch.cuda.synchronize()
        assert attention.LAUNCHES[attention.BWD_KERNEL] == before[attention.BWD_KERNEL] + 1
        assert (attention.LAUNCHES[attention.BWD_GROUPED_KERNEL]
                == before[attention.BWD_GROUPED_KERNEL] + (group != 3))
        for name, a, w in zip(("dq", "dk", "dv"), got, base):
            assert torch.equal(a, w), (group, name)
    q = torch.zeros(1, 32, 16, 8, device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(q, q, q, q, heads_per_program=0)


def test_conditional_generator_runs_one_forward_per_step(cuda, tmp_path):
    """Guided sampling runs ONE 2B-batched forward per step: a mixed block
    of 4 images over 2 DDIM steps launches the forward kernel 2 x 6 times,
    guided or not (two forwards per step would read 24)."""
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64),
                       num_class_embeds=3)
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), tmp_path / "unet_conditional_best.pth")
    (tmp_path / "unet_conditional_best.json").write_text(json.dumps(
        {"classes": ["MEL", "NV"], "num_class_embeds": 3, "null_label": 2}))
    for scale in (0.0, 3.0):
        gen = ImageGenerator(checkpoints_dir=str(tmp_path), device=cuda,
                             model_config=UNet2DConfig(sample_size=32,
                                                       block_out_channels=(32, 64, 64, 64)),
                             conditional=True, guidance_scale=scale)
        gen.scheduler_kind, gen.batch_size = "ddim", 4
        gen.set_inference_steps(2)
        gen.set_generation_seed(1)
        before = dict(attention.LAUNCHES)
        result = gen.generate_images([("MEL", 2), ("NV", 2)], str(tmp_path / f"out{scale}"))
        torch.cuda.synchronize()
        assert result["generated"] == 4
        got = {key: attention.LAUNCHES[key] - before[key] for key in before}
        assert got[attention.KERNEL] == 2 * 6 and got[attention.FAST_KERNEL] == 0


def test_f32_sidecar_written_without_tf32_reproduces(cuda, tmp_path, monkeypatch):
    """An f32 image written on CUDA with cuDNN's TF32 off records that, and
    `--reproduce` from a process with PyTorch's default (TF32 on) switches
    it off for the regeneration: byte for byte."""
    from synt_isic_tpu_torch.cli import reproduce_from_sidecar

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), tmp_path / "unet_MEL_best.pth")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    gen = ImageGenerator(checkpoints_dir=str(tmp_path), device=cuda, model_config=cfg)
    gen.scheduler_kind = "ddim"
    gen.set_inference_steps(3)
    gen.set_generation_seed(5)
    assert gen.generate_images([("MEL", 1)], str(tmp_path / "out"))["generated"] == 1
    sidecar = next((tmp_path / "out" / "MEL").glob("*.json"))
    meta = json.loads(sidecar.read_text())
    assert meta["scheduler"]["tf32"] == {
        "cudnn": False, "matmul": torch.backends.cuda.matmul.allow_tf32}
    torch.backends.cudnn.allow_tf32 = True
    assert reproduce_from_sidecar(str(sidecar), str(tmp_path), model_config=cfg,
                                  device="cuda") == 0
    assert torch.backends.cudnn.allow_tf32 is True


BWD_ORDER_TOL = 1e-2   # one bf16 ulp of max|g| (2^-7) plus f32 order and rare flips
LSE_TOL = 1e-4         # f32 sums of up to 1024 terms in another order


def _bf16_args(cuda, shape, layout, seed):
    b, h, t, d = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    args = [torch.randn(shape, generator=g, device=cuda).bfloat16() for _ in range(4)]
    if layout == "BTC":
        args = [z.transpose(1, 2).reshape(b, t, h * d).view(b, t, h, d).transpose(1, 2)
                for z in args]
    return args


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("shape", [(2, 32, 1024, 8), (8, 32, 256, 8), (1, 2, 101, 8)])
def test_bf16_bwd_from_saved_statistics(cuda, shape, layout):
    """The tensor-core backward from the exact forward's output and
    log-sum-exp: within BWD_TOL of the plain version, within BWD_ORDER_TOL
    of the plain version of its own rounding, two calls torch.equal, and no
    statistics launch."""
    q, k, v, do = _bf16_args(cuda, shape, layout, 11)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    again = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.BWD_KERNEL] == before[attention.BWD_KERNEL] + 2
    assert attention.LAUNCHES[attention.STATS_KERNEL] == before[attention.STATS_KERNEL]
    want = attention.attention_bwd_reference(q, k, v, do)
    order = attention.attention_bwd_kernel_order(q, k, v, do, o, lse)
    for name, a, w, r, a2 in zip(("dq", "dk", "dv"), got, want, order, again):
        assert torch.equal(a, a2), name
        for ref, tol in ((w, BWD_TOL[torch.bfloat16]), (r, BWD_ORDER_TOL)):
            torch.testing.assert_close(a.float(), ref.float(), rtol=0,
                                       atol=tol * ref.float().abs().max().item(), msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
def test_forward_lse_leaves_the_output_unchanged(cuda, dtype, layout):
    """The exact forward's output is torch.equal with and without the
    log-sum-exp output, at every G, and the log-sum-exp matches its plain
    version."""
    q, k, v, _ = (z.to(dtype) for z in _bf16_args(cuda, (2, 32, 256, 8), layout, 12))
    want = attention.attention_lse_reference(q, k)
    for group in (1, 2, 4, 8):
        out, lse = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
        assert torch.equal(out, attention.fused_attention(q, k, v, heads_per_program=group))
        assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
        torch.testing.assert_close(lse, want, rtol=0, atol=LSE_TOL)
    with pytest.raises(ValueError):
        attention.fused_attention(q, k, v, fast_math=True, with_lse=True)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
def test_bf16_bwd_from_saved_statistics_grouped_is_bit_identical(cuda, layout):
    q, k, v, do = _bf16_args(cuda, (2, 32, 1024, 8), layout, 13)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    base = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    for group in (2, 4, 8):
        got = attention.fused_attention_bwd(q, k, v, do, group, o=o, lse=lse)
        for name, a, w in zip(("dq", "dk", "dv"), got, base):
            assert torch.equal(a, w), (group, name)


def test_exact_trainable_reads_its_saved_statistics(cuda):
    """K4 in bf16 at head_dim 8, exact maths: one forward and one backward
    launch, no statistics launch; the same gradients as the backward from
    the forward's statistics."""
    q, k, v, do = _bf16_args(cuda, (2, 32, 1024, 8), "BTC", 14)
    leaves = [z.detach().requires_grad_() for z in (q, k, v)]
    before = dict(attention.LAUNCHES)
    got = torch.autograd.grad(attention.fused_attention_trainable(*leaves), leaves, do)
    torch.cuda.synchronize()
    launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert launched[attention.KERNEL] == launched[attention.BWD_KERNEL] == 1
    assert launched[attention.STATS_KERNEL] == 0
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    for a, w in zip(got, attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fast_math_trainable_runs_one_statistics_launch(cuda, dtype):
    """K4 with fast math keeps the exact softmax's derivative: its backward
    runs one exact statistics launch first, and its gradients are
    torch.equal to the standalone backward's."""
    q, k, v, do = (z.to(dtype) for z in _bf16_args(cuda, (2, 32, 1024, 8), "BTC", 15))
    leaves = [z.detach().requires_grad_() for z in (q, k, v)]
    before = dict(attention.LAUNCHES)
    got = torch.autograd.grad(attention.fused_attention_trainable(*leaves, True), leaves, do)
    torch.cuda.synchronize()
    launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert launched[attention.FAST_KERNEL] == launched[attention.BWD_KERNEL] == 1
    assert launched[attention.STATS_KERNEL] == 1 and launched[attention.KERNEL] == 0
    for a, w in zip(got, attention.fused_attention_bwd(q, k, v, do)):
        assert torch.equal(a, w)


def test_bf16_bwd_takes_any_layout(cuda):
    """Rows the tensor-core kernels cannot stage by 16-byte copies (a
    broadcast output gradient, as `out.sum()` gives, and channels that are
    not contiguous) are copied first: the same gradients, bit for bit, as
    from dense tensors."""
    q, k, v, _ = _bf16_args(cuda, (2, 32, 256, 8), "BHTD", 16)
    do = torch.ones((), device=cuda, dtype=torch.bfloat16).expand(q.shape)
    q_strided = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert do.stride() == (0, 0, 0, 0) and q_strided.stride(-1) != 1
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    want = attention.fused_attention_bwd(q, k, v, do.contiguous(), o=o, lse=lse)
    got = attention.fused_attention_bwd(q_strided, k, v, do, o=o, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, w), name


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("shape", [(2, 4, 101, 8), (2, 32, 1000, 8)])
def test_bf16_forward_ragged(cuda, shape, layout):
    """The tensor-core forward at a T that leaves a short last key tile and
    a short last block of rows: exact within TOL of the plain version, its
    log-sum-exp within LSE_TOL, the output torch.equal with and without it;
    fast math within one bf16 ulp of its own rounding order; every G that
    divides the heads torch.equal to G = 1, output and lse."""
    q, k, v, _ = _bf16_args(cuda, shape, layout, 17)
    out, lse = attention.fused_attention(q, k, v, with_lse=True)
    fast = attention.fused_attention(q, k, v, fast_math=True)
    assert out.stride() == q.stride()
    want = attention.attention_reference(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=TOL[torch.bfloat16], atol=TOL[torch.bfloat16])
    torch.testing.assert_close(lse, attention.attention_lse_reference(q, k), rtol=0, atol=LSE_TOL)
    assert torch.equal(out, attention.fused_attention(q, k, v))
    order = attention.attention_fast_math_kernel_order(q, k, v, 64).float()
    assert (fast.float() - order).abs().max().item() <= FAST_ORDER_TOL[torch.bfloat16]
    for group in (2, 4, 8):
        if shape[1] % group == 0:
            o_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
            assert torch.equal(o_g, out) and torch.equal(lse_g, lse), group
            assert torch.equal(attention.fused_attention(q, k, v, fast_math=True,
                                                         heads_per_program=group), fast), group


def test_bf16_forward_takes_any_layout(cuda):
    """k and v rows the tensor-core forward cannot stage by 16-byte copies
    (a contiguous tensor that starts 2 bytes off, channels that are not
    contiguous) are copied first, and q is read from its own strides: the
    same output, bit for bit, as from dense tensors, in q's strides."""
    q, k, v, _ = _bf16_args(cuda, (2, 32, 256, 8), "BHTD", 18)
    storage = torch.empty(k.numel() + 1, device=cuda, dtype=torch.bfloat16)
    k_off = storage[1:].view(k.shape)
    k_off.copy_(k)
    v_strided = v.transpose(-1, -2).contiguous().transpose(-1, -2)
    q_strided = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 != 0 and v_strided.stride(-1) != 1
    for fast_math in (False, True):
        want = attention.fused_attention(q, k, v, fast_math=fast_math)
        got = attention.fused_attention(q_strided, k_off, v_strided, fast_math=fast_math)
        assert got.stride() == q_strided.stride()
        assert torch.equal(got, want), fast_math


def test_bf16_bwd_takes_an_unaligned_contiguous_tensor(cuda):
    """A contiguous tensor whose rows start off 16 bytes is copied into
    fresh storage before the tensor-core backward stages it: the same
    gradients as from aligned tensors."""
    q, k, v, do = _bf16_args(cuda, (2, 32, 256, 8), "BHTD", 19)
    storage = torch.empty(do.numel() + 1, device=cuda, dtype=torch.bfloat16)
    do_off = storage[1:].view(do.shape)
    do_off.copy_(do)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    want = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    got = attention.fused_attention_bwd(q, k, v, do_off, o=o, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, w), name


def test_bf16_fast_math_is_told_from_exact(cuda):
    """At logits 8x wider, the exact tensor-core kernel lies on average more
    than FAST_SEPARATION times as far from the fast-math rounding order as
    the fast kernel does (the check `chip_smoke.py` makes)."""
    q, k, v, _ = _bf16_args(cuda, (2, 32, 1024, 8), "BTC", 20)
    q = (q.float() * 8).bfloat16()
    order = attention.attention_fast_math_kernel_order(q, k, v, 64).float()
    fast = (attention.fused_attention(q, k, v, fast_math=True).float() - order).abs().mean()
    exact = (attention.fused_attention(q, k, v).float() - order).abs().mean()
    assert exact.item() > FAST_SEPARATION * fast.item()


# the f32 tensor-core forward against the plain version of its own rounding
# (3xTF32 products, the max per 64-key tile): they differ only where f32
# rounds (the tensor cores' accumulation, ex2.approx's 2^-22, the order of
# the row sums), a few f32 ulps of outputs under 4 (2^-22 = 2.4e-7 each);
# 5e-6 allows 20 of them, a fourth of TOL (`chip_smoke.py` TF32_ORDER_TOL)
TF32_ORDER_TOL = 5e-6


def _f32_args(cuda, shape, layout, seed):
    return [z.float() for z in _bf16_args(cuda, shape, layout, seed)]


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("shape", [(8, 32, 1024, 8), (8, 32, 256, 8), (16, 32, 1024, 8),
                                   (2, 4, 101, 8), (2, 32, 1000, 8)])
def test_f32_tensor_core_forward(cuda, shape, layout):
    """Exact f32 at head_dim 8 (the 3xTF32 tensor-core kernel): within TOL of
    the plain version and TF32_ORDER_TOL of its own rounding order, at the
    sampling, training and ragged shapes; the output in q's strides and
    torch.equal with and without the log-sum-exp, which matches its plain
    version."""
    q, k, v, _ = _f32_args(cuda, shape, layout, 21)
    before = attention.LAUNCHES[attention.KERNEL]
    out = attention.fused_attention(q, k, v)
    with_lse, lse = attention.fused_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.KERNEL] == before + 2
    assert out.stride() == q.stride() and torch.equal(out, with_lse)
    want = attention.attention_reference(q, k, v)
    torch.testing.assert_close(out, want, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    order = attention.attention_tf32x3_kernel_order(q, k, v)
    assert (out - order).abs().max().item() <= TF32_ORDER_TOL
    torch.testing.assert_close(lse, attention.attention_lse_reference(q, k), rtol=0, atol=LSE_TOL)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
def test_f32_tensor_core_forward_grouped_is_bit_identical(cuda, layout):
    q, k, v, _ = _f32_args(cuda, (2, 32, 1024, 8), layout, 22)
    out, lse = attention.fused_attention(q, k, v, with_lse=True)
    for group in (2, 4, 8):
        before = attention.LAUNCHES[attention.GROUPED_KERNEL]
        o_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
        torch.cuda.synchronize()
        assert attention.LAUNCHES[attention.GROUPED_KERNEL] == before + 1
        assert torch.equal(o_g, out) and torch.equal(lse_g, lse), group


def test_f32_forward_takes_any_layout(cuda):
    """k and v rows the f32 tensor-core forward, exact or fast math, cannot
    stage by 16-byte copies (a contiguous tensor that starts 4 bytes off,
    channels that are not contiguous) are copied first, and q is read from
    its own strides: the same output, bit for bit, as from dense tensors."""
    q, k, v, _ = _f32_args(cuda, (2, 32, 256, 8), "BHTD", 23)
    storage = torch.empty(k.numel() + 1, device=cuda)
    k_off = storage[1:].view(k.shape)
    k_off.copy_(k)
    v_strided = v.transpose(-1, -2).contiguous().transpose(-1, -2)
    q_strided = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert k_off.is_contiguous() and k_off.data_ptr() % 16 != 0 and v_strided.stride(-1) != 1
    for fast_math in (False, True):
        want = attention.fused_attention(q, k, v, fast_math=fast_math)
        for _ in range(2):      # the second call takes the cached checks
            got = attention.fused_attention(q_strided, k_off, v_strided, fast_math=fast_math)
            assert got.stride() == q_strided.stride()
            assert torch.equal(got, want), fast_math


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_launch_still_refuses(cuda, dtype):
    """After a good call of a shape has been checked and remembered, every
    input the wrapper refuses still raises, forward and backward."""
    q, k, v, do = (z.to(dtype) for z in _bf16_args(cuda, (2, 32, 64, 8), "BTC", 24))
    attention.fused_attention(q, k, v)
    attention.fused_attention_bwd(q, k, v, do)
    with pytest.raises(ValueError):        # another dtype
        attention.fused_attention(q, k.half(), v)
    with pytest.raises(ValueError):        # a G below 1
        attention.fused_attention(q, k, v, heads_per_program=0)
    with pytest.raises(ValueError):        # another device
        attention.fused_attention(q, k.cpu(), v)
    with pytest.raises(ValueError):        # another shape
        attention.fused_attention(q, k[:, :, :32], v)
    with pytest.raises(ValueError):        # the log-sum-exp with fast math
        attention.fused_attention(q, k, v, fast_math=True, with_lse=True)
    with pytest.raises(RuntimeError, match="fused_attention_trainable"):
        attention.fused_attention(q, k.detach().requires_grad_(), v)
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(q, k, v, do.half())
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(q, k, v, do, heads_per_program=0)
    with pytest.raises(ValueError):
        attention.fused_attention_bwd(q, k, v, do[:, :, :32])
    # head_dim 8: the backward reads o and lse in both dtypes
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    with pytest.raises(ValueError):        # a log-sum-exp of another type
        attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse.double())
    with pytest.raises(ValueError):        # an output of another shape
        attention.fused_attention_bwd(q, k, v, do, o=o[:, :, :32], lse=lse)


def test_f32_forward_redoes_a_tile_whose_logits_jump(cuda):
    """Keys after the first tile give logits about 200 (base 2) above the
    first tile's: against the shift taken from the first tile their weights
    would overflow f32, so the kernel takes the tile's max first and does
    the tile again. The output stays finite and within TOL of float64
    attention, and every G gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(25)
    shape = (1, 4, 192, 8)
    q = torch.randn(shape, generator=g, device=cuda) * 6
    k = torch.randn(shape, generator=g, device=cuda)
    k[:, :, :64] *= 0.5
    k[:, :, 64:] *= 10
    v = torch.randn(shape, generator=g, device=cuda)
    out, lse = attention.fused_attention(q, k, v, with_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    want = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8 ** 0.5, -1) @ v.double()
    torch.testing.assert_close(out.double(), want, rtol=TOL[torch.float32], atol=TOL[torch.float32])
    for group in (2, 4):
        o_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
        assert torch.equal(o_g, out) and torch.equal(lse_g, lse), group


# the f32 tensor-core backward against the plain version of its own rounding
# (`attention_bwd_tf32x3_kernel_order`: the same splits and products, per-tile
# partial sums), per gradient as max|diff| / max|g|. They differ where f32
# rounds: ex2.approx (2^-22 relative) and the exponent's one fma against a
# double-rounded shift, the tensor cores' truncated f32 sums (each add loses
# under 2^-23 of a partial sum, in chains of 3 products for S and dP, which
# enter the exponent as an absolute error of a few 2^-23 |q||k|, and of 24
# for a tile's dq, dk, dv) and the order of the f32 sums; each of these is a
# few 2^-23 of the terms of a gradient entry, whose sum of magnitudes is a
# few times max|g| at randn inputs. The order function itself lies about
# 1e-6 max|g| from float64 gradients (CPU, up to T=1024); 1e-5 allows ten
# times that and is a fifth of BWD_TOL, which one TF32 pass misses 10-50x
# (`chip_smoke.py` TF32_BWD_ORDER_TOL)
TF32_BWD_ORDER_TOL = 1e-5


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("shape", [(2, 32, 1024, 8), (8, 32, 256, 8), (1, 2, 101, 8),
                                   (2, 32, 1000, 8)])
def test_f32_bwd_from_saved_statistics(cuda, shape, layout):
    """The 3xTF32 tensor-core backward from the exact f32 forward's output
    and log-sum-exp: within BWD_TOL of the plain version and within
    TF32_BWD_ORDER_TOL of the plain version of its own rounding, at full,
    short and ragged T; two calls torch.equal; the gradients in the strides
    of q, k and v; no statistics launch."""
    q, k, v, do = _f32_args(cuda, shape, layout, 26)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    again = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.BWD_KERNEL] == before[attention.BWD_KERNEL] + 2
    assert attention.LAUNCHES[attention.STATS_KERNEL] == before[attention.STATS_KERNEL]
    want = attention.attention_bwd_reference(q, k, v, do)
    order = attention.attention_bwd_tf32x3_kernel_order(q, k, v, do, o, lse)
    for name, a, w, r, a2, src in zip(("dq", "dk", "dv"), got, want, order, again, (q, k, v)):
        assert torch.equal(a, a2), name
        assert a.dtype == torch.float32 and a.stride() == src.stride(), name
        for ref, tol in ((w, BWD_TOL[torch.float32]), (r, TF32_BWD_ORDER_TOL)):
            torch.testing.assert_close(a, ref, rtol=0, atol=tol * ref.abs().max().item(),
                                       msg=name)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
def test_f32_bwd_from_saved_statistics_grouped_is_bit_identical(cuda, layout):
    q, k, v, do = _f32_args(cuda, (2, 32, 1024, 8), layout, 27)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    base = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    for group in (2, 4, 8):
        before = attention.LAUNCHES[attention.BWD_GROUPED_KERNEL]
        got = attention.fused_attention_bwd(q, k, v, do, group, o=o, lse=lse)
        torch.cuda.synchronize()
        assert attention.LAUNCHES[attention.BWD_GROUPED_KERNEL] == before + 1
        for name, a, w in zip(("dq", "dk", "dv"), got, base):
            assert torch.equal(a, w), (group, name)


def test_f32_bwd_takes_any_layout(cuda):
    """Rows the f32 tensor-core backward cannot stage by 16-byte copies (a
    contiguous tensor that starts 4 bytes off, channels that are not
    contiguous, a broadcast output gradient) are copied into fresh storage
    first: the same gradients, bit for bit, as from dense tensors."""
    q, k, v, do = _f32_args(cuda, (2, 32, 256, 8), "BHTD", 28)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    storage = torch.empty(do.numel() + 1, device=cuda)
    do_off = storage[1:].view(do.shape)
    do_off.copy_(do)
    q_strided = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert do_off.is_contiguous() and do_off.data_ptr() % 16 != 0 and q_strided.stride(-1) != 1
    want = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    for _ in range(2):      # the second call takes the cached checks
        got = attention.fused_attention_bwd(q_strided, k, v, do_off, o=o, lse=lse)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.equal(a, w), name
    ones = torch.ones((), device=cuda).expand(q.shape)
    want = attention.fused_attention_bwd(q, k, v, ones.contiguous(), o=o, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"), attention.fused_attention_bwd(q, k, v, ones, o=o,
                                                                            lse=lse), want):
        assert torch.equal(a, w), name


def test_f32_standalone_bwd_runs_one_statistics_launch(cuda):
    """An f32 backward at head_dim 8 without o and lse runs one exact forward
    launch for them first, counted under STATS_KERNEL only, and gives the
    gradients of the backward from the forward's statistics bit for bit."""
    q, k, v, do = _f32_args(cuda, (2, 32, 1024, 8), "BTC", 29)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    want = attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention_bwd(q, k, v, do)
    torch.cuda.synchronize()
    launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert launched[attention.STATS_KERNEL] == launched[attention.BWD_KERNEL] == 1
    assert launched[attention.KERNEL] == 0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, w), name


def test_f32_exact_trainable_reads_its_saved_statistics(cuda):
    """K4 in f32 at head_dim 8, exact maths: one forward and one backward
    launch, no statistics launch; the same gradients as the backward from
    the forward's statistics."""
    q, k, v, do = _f32_args(cuda, (2, 32, 1024, 8), "BTC", 30)
    leaves = [z.detach().requires_grad_() for z in (q, k, v)]
    before = dict(attention.LAUNCHES)
    got = torch.autograd.grad(attention.fused_attention_trainable(*leaves), leaves, do)
    torch.cuda.synchronize()
    launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert launched[attention.KERNEL] == launched[attention.BWD_KERNEL] == 1
    assert launched[attention.STATS_KERNEL] == 0
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    for a, w in zip(got, attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)):
        assert torch.equal(a, w)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("shape", [(8, 32, 1024, 8), (8, 32, 256, 8), (2, 4, 101, 8),
                                   (2, 32, 1000, 8)])
def test_f32_fast_math_tensor_core_forward(cuda, shape, layout):
    """f32 fast math at head_dim 8 (the 3xTF32 tensor-core kernel) at the
    sampling and ragged shapes: one fast-math launch and no exact one, the
    output in q's strides, within 1e-2 of the plain version, within the JAX
    package's fast-math tolerance of exact attention, and each output within
    FAST_FLIPS flip moves of its rounding order, which the exact kernel
    misses; G = 2/4/8 torch.equal to G = 1."""
    q, k, v, _ = _f32_args(cuda, shape, layout, 26)
    before = dict(attention.LAUNCHES)
    got = attention.fused_attention(q, k, v, fast_math=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.FAST_KERNEL] == before[attention.FAST_KERNEL] + 1
    assert attention.LAUNCHES[attention.KERNEL] == before[attention.KERNEL]
    assert got.dtype == torch.float32 and got.stride() == q.stride()
    assert (got - attention.attention_fast_math_reference(q, k, v)).abs().max().item() <= 1e-2
    torch.testing.assert_close(got, attention.attention_reference(q, k, v), rtol=0.05, atol=0.02)
    order = attention.fast_math_kernel_order(q, k, v)
    limit = _order_limit(q, k, v, order)
    assert ((got - order).abs() <= limit).all()
    assert not ((attention.fused_attention(q, k, v) - order).abs() <= limit).all()
    for group in (2, 4, 8):
        if shape[1] % group == 0:
            assert torch.equal(attention.fused_attention(q, k, v, fast_math=True,
                                                         heads_per_program=group), got), group


def test_f32_fast_math_is_told_from_exact(cuda):
    """At logits 8x wider, the exact f32 kernel lies on average more than
    FAST_SEPARATION times as far from the fast-math rounding order as the
    fast kernel does (the check `chip_smoke.py` makes)."""
    q, k, v, _ = _f32_args(cuda, (2, 32, 1024, 8), "BTC", 27)
    q = q * 8
    order = attention.fast_math_kernel_order(q, k, v)
    fast = (attention.fused_attention(q, k, v, fast_math=True) - order).abs().mean()
    exact = (attention.fused_attention(q, k, v) - order).abs().mean()
    assert exact.item() > FAST_SEPARATION * fast.item()


def _walk_models(cuda, cfg):
    """The same random small UNet with the kernel and with the plain
    attention, on the card."""
    torch.manual_seed(0)
    state = UNet2D(cfg).state_dict()
    models = {}
    for fused in (True, False):
        model = UNet2D(cfg, use_fused_attention=fused)
        model.load_state_dict(state)
        models[fused] = model.to(cuda).eval()
    return models


def _launched(before):
    torch.cuda.synchronize()
    return {key: attention.LAUNCHES[key] - before[key] for key in before}


def test_unipc_walk_runs_the_kernel(cuda, monkeypatch):
    """A UniPC walk launches the forward kernel 6 times per step and agrees
    with the walk through the plain attention (full-f32 convolutions, as in
    `test_unet_runs_the_kernel`; 1e-3 over the walk, the CLI check's
    tolerance in `chip_smoke.py`); its host-streamed trajectory equals the
    on-device one."""
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    models = _walk_models(cuda, cfg)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    steps = 4
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=steps, scheduler="unipc",
                                             timestep_spacing="trailing", image_size=32),
                               device=cuda)
    outs = {}
    for fused, model in models.items():
        before = dict(attention.LAUNCHES)
        outs[fused] = sampler.sample(model, [1, 2], capture_trajectory=2, stream_to_host=True)
        got = _launched(before)
        assert got[attention.KERNEL] == (6 * steps if fused else 0)
        assert got[attention.FAST_KERNEL] == 0
    assert torch.isfinite(outs[True]["images"]).all()
    torch.testing.assert_close(outs[True]["images"], outs[False]["images"],
                               rtol=1e-3, atol=1e-3)
    on_device = sampler.sample(models[True], [1, 2], capture_trajectory=2)
    assert isinstance(outs[True]["trajectory"], np.ndarray)
    np.testing.assert_array_equal(outs[True]["trajectory"],
                                  on_device["trajectory"].cpu().numpy())


def test_inpainting_walk_runs_the_kernel(cuda, monkeypatch):
    """Inpainting launches the kernel 6 times per executed step, keeps the
    known region exactly and agrees with the plain attention's walk."""
    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    models = _walk_models(cuda, cfg)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=10, scheduler="ddpm",
                                             image_size=32), device=cuda)
    rng = np.random.default_rng(3)
    init = np.clip(rng.normal(0, 0.3, (32, 32, 3)), -1, 1).astype(np.float32)
    mask = np.zeros((32, 32), np.float32)
    mask[:, :16] = 1.0
    outs = {}
    for fused, model in models.items():
        before = dict(attention.LAUNCHES)
        outs[fused] = sampler.img2img(model, [5, 6], init, strength=0.5, mask=mask)
        assert _launched(before)[attention.KERNEL] == (6 * 5 if fused else 0)
        assert outs[fused]["start_index"] == 5
    images = outs[True]["images"].cpu().numpy()
    np.testing.assert_array_equal(images[:, :, 16:], np.broadcast_to(init, images.shape)[:, :, 16:])
    torch.testing.assert_close(outs[True]["images"], outs[False]["images"],
                               rtol=1e-3, atol=1e-3)


# -- the XAI engine on the card ----------------------------------------------------------

def _xai_frames(n, size=128, seed=7):
    rng = np.random.default_rng(seed)
    return (0.95 * np.tanh(rng.normal(size=(n, size, size, 3)))).astype(np.float32)


def test_classifier_on_cuda_matches_cpu(cuda, monkeypatch):
    """The ResNet-18 classifier at its 224² input on the card against the
    same weights on the CPU, full-f32 convolutions on the card: logits and
    input gradients within 1e-4 · max|value| (two f32 convolution
    algorithms), Grad-CAM maps within 1e-3."""
    from synt_isic_tpu_torch.models.classifier import LesionClassifier
    from synt_isic_tpu_torch.xai import compute_gradcam

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu = LesionClassifier.random_init(num_classes=8, seed=0, device="cpu")
    card = LesionClassifier.random_init(num_classes=8, seed=0, device=cuda)
    assert all(p.is_cuda for p in card.model.state_dict().values())
    x = _xai_frames(3)
    for got, want in ((card.logits(x), cpu.logits(x)),
                      (card.input_gradient(x, 2), cpu.input_gradient(x, 2))):
        assert got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=1e-4 * want.abs().max().item())
    np.testing.assert_allclose(compute_gradcam(card, x, 2), compute_gradcam(cpu, x, 2),
                               rtol=0, atol=1e-3)


def test_standalone_run_launches_the_kernel(cuda, tmp_path):
    """The standalone XAI run on the card: its walk launches the attention
    kernel 6 times per step (no plain attention), then the pipeline writes
    its results."""
    from synt_isic_tpu_torch.xai.standalone import run_standalone_xai

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), tmp_path / "unet_MEL_best.pth")
    steps = 3
    before = dict(attention.LAUNCHES)
    results = run_standalone_xai(checkpoints_dir=str(tmp_path), model_config=cfg,
                                 inference_steps=steps, save_every=1, ig_n_steps=2,
                                 shap_n_samples=4, n_bootstrap=20, n_permutations=50,
                                 with_sanity=False, results_dir=str(tmp_path / "out"),
                                 device="cuda", save_figures=False, log=lambda *a: None)
    launched = _launched(before)
    assert launched[attention.KERNEL] == 6 * steps
    assert launched[attention.FAST_KERNEL] == 0
    assert results["metadata"]["n_timesteps"] == steps
    assert (tmp_path / "out" / "analysis_results.json").exists()
    assert "error" not in results["time_shap"] and "error" not in results["gradcam"]


def test_xai_path_keeps_its_work_on_the_card(cuda):
    """Attribution, Grad-CAM, interventions and CFI on a classifier on the
    card: every convolution, matrix product, pooling, resize and softmax
    runs on the card (only the seeded draws are made on the host, so the
    card and the CPU draw the same numbers), and the results lie there."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from synt_isic_tpu_torch.models.classifier import LesionClassifier
    from synt_isic_tpu_torch.xai import (XAIAnalyzer, compute_causal_shift_comprehensive,
                                         compute_gradcam, counterfactual_intervention_advanced)

    heavy = ("conv", "mm", "pool", "upsample", "softmax", "bmm", "einsum")

    class HostWork(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.host_ops = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            tensors = [a for a in torch.utils._pytree.tree_leaves((args, kwargs or {}))
                       if isinstance(a, torch.Tensor)]
            if tensors and not any(t.is_cuda for t in tensors):
                self.host_ops.add(str(func))
            return func(*args, **(kwargs or {}))

    clf = LesionClassifier.random_init(num_classes=8, seed=0, device=cuda)
    an = XAIAnalyzer(clf, ig_n_steps=4, shap_n_samples=16, seed=0)
    frames = torch.from_numpy(_xai_frames(2)).to(cuda)
    mask = np.zeros((128, 128), bool)
    mask[32:96, 32:96] = True
    with HostWork() as mode:
        outs = [an.compute_ig_frames(frames, 1), an.compute_shap_frames(frames, 1),
                an.compute_integrated_gradients(frames[:1], 1, baseline_type="blur")]
        an.compute_time_shap(frames, [10.0, 0.0], 1)
        compute_gradcam(clf, frames, 1)
        for itype in ("blur", "noise", "shuffle"):
            res = counterfactual_intervention_advanced(frames[:1], mask, itype)
            outs.append(res["modified_image"])
            compute_causal_shift_comprehensive(clf, frames[:1], res["modified_image"], 1)
    assert all(o.is_cuda for o in outs)
    assert not [op for op in mode.host_ops if any(h in op for h in heavy)], mode.host_ops


# -- the serving path ----------------------------------------------------------------------

_SERVE_CFG = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))


def _serve_gen(tmp_path, batch):
    if not (tmp_path / "unet_MEL_best.pth").exists():
        torch.manual_seed(0)
        torch.save(UNet2D(_SERVE_CFG).state_dict(), tmp_path / "unet_MEL_best.pth")
    gen = ImageGenerator(checkpoints_dir=str(tmp_path), device="cuda",
                         compute_dtype=torch.bfloat16, model_config=_SERVE_CFG)
    gen.scheduler_kind, gen.batch_size = "ddim", batch
    gen.set_inference_steps(2)
    return gen


def test_served_fixed_seed_is_byte_identical_to_generate_images(cuda, tmp_path):
    from synt_isic_tpu_torch.serve import GenerationServer, request

    srv = GenerationServer(_serve_gen(tmp_path, 4), port=0,
                           output_root=str(tmp_path / "served")).start()
    try:
        host, port = srv.address
        w = request(host, port, {"op": "warmup", "class": "MEL", "compile": True})
        assert w["ok"] and w["compiled_batches"] == [1, 4]
        before = dict(attention.LAUNCHES)
        r = request(host, port, {"op": "generate", "class": "MEL", "count": 4, "seed": 11})
        assert r["ok"] and r["coalesced"] == 1
        assert attention.LAUNCHES[attention.KERNEL] - before[attention.KERNEL] == 2 * 6
    finally:
        srv.stop()
    lib = _serve_gen(tmp_path, 4)
    lib.set_generation_seed(11)
    assert lib.generate_images([("MEL", 4)], str(tmp_path / "lib"))["generated"] == 4
    served = [open(f, "rb").read() for f in r["files"]]
    assert served == [p.read_bytes() for p in sorted((tmp_path / "lib" / "MEL").glob("*.png"))]


def test_pipelined_generator_matches_single_block_runs(cuda, tmp_path):
    """Three blocks in flight two at a time write the bytes that each block
    run alone writes (same seeds, same block)."""
    gen = _serve_gen(tmp_path, 2)
    gen.set_generation_seed(3)
    assert gen.generate_images([("MEL", 6)], str(tmp_path / "pipelined"))["generated"] == 6
    piped = sorted((tmp_path / "pipelined" / "MEL").glob("*.png"))
    for k in range(3):
        alone = _serve_gen(tmp_path, 2)
        alone.set_generation_seed(3 + 2 * k)
        out = tmp_path / f"alone{k}"
        assert alone.generate_images([("MEL", 2)], str(out))["generated"] == 2
        assert [p.read_bytes() for p in sorted((out / "MEL").glob("*.png"))] == [
            p.read_bytes() for p in piped[2 * k:2 * k + 2]]


def test_sample_returns_without_a_host_sync(cuda, tmp_path):
    from synt_isic_tpu_torch.diffusion.sampler import noise_hash

    gen = _serve_gen(tmp_path, 4)
    assert gen.model_manager.load_model("MEL")
    sampler, model = gen._sampler(), gen.model_manager.loaded_models["MEL"]
    seeds = np.arange(4, dtype=np.uint32)
    sampler.sample(model, seeds)                       # builds the kernel, warms up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = sampler.sample(model, seeds)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    noise = sampler.initial_noise(seeds).cpu().numpy()
    assert list(out["noise_hashes"]) == [noise_hash(n) for n in noise]


def _launches_since(before):
    return {key: attention.LAUNCHES[key] - before[key] for key in before}


def test_distill_step_runs_the_kernels(cuda):
    """One distillation step at full width (32x32): the teacher's two
    forwards launch K1 without the log-sum-exp (12), the student's forward
    K1 with it (6) and its backward K3 (6), and no statistics launch."""
    from synt_isic_tpu_torch.train import distill
    from synt_isic_tpu_torch.train.train_ddpm import TrainConfig, default_model

    student = default_model(TrainConfig(image_size=32), cuda).to(cuda).train()
    teacher = default_model(TrainConfig(image_size=32, seed=1), cuda).to(cuda)
    teacher.requires_grad_(False)
    cfg = distill.DistillConfig(batch_size=4, steps_per_phase=10)
    state = distill.create_distill_state(student, cfg)
    step = distill.make_distill_step(DiffusionSchedule.create(), cfg, 4)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = torch.rand((4, 32, 32, 3), generator=gen, device=cuda) * 2 - 1
    step(state, teacher, batch, gen)                 # builds the kernels
    before = dict(attention.LAUNCHES)
    loss = step(state, teacher, batch, gen)
    got = _launches_since(before)
    assert torch.isfinite(loss)
    assert (got[attention.KERNEL], got[attention.BWD_KERNEL], got[attention.STATS_KERNEL]) \
        == (18, 6, 0)
    assert all(p.grad is None for p in teacher.parameters())


def test_remat_modes_give_bit_identical_gradients(cuda):
    """The trainer's UNet (bf16 compute, f32 parameters, the kernels) at
    full width (32x32) under deterministic cuDNN: every remat mode's
    gradients torch.equal to no remat's; the recomputing modes with
    attention blocks launch K1 twice per attention call, K3 once, and no
    statistics launch."""
    from synt_isic_tpu_torch.models.unet2d import REMAT_MODES
    from synt_isic_tpu_torch.train.train_ddpm import TrainConfig, default_model

    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 3, 32, 32), generator=gen, device=cuda)
    t = torch.tensor([3, 250, 500, 999], device=cuda)
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    grads, launches = {}, {}
    try:
        for mode in REMAT_MODES:
            model = default_model(TrainConfig(image_size=32), cuda, remat=mode).to(cuda)
            model(x, t).square().mean().backward()     # builds the kernels
            model.zero_grad(set_to_none=True)
            before = dict(attention.LAUNCHES)
            model(x, t).square().mean().backward()
            launches[mode] = _launches_since(before)
            grads[mode] = {k: p.grad for k, p in model.named_parameters()}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    for mode in REMAT_MODES:
        assert all(torch.equal(g, grads["none"][k]) for k, g in grads[mode].items()), mode
        want_fwd = 12 if mode in ("all", "attn", "dots") else 6
        got = launches[mode]
        assert (got[attention.KERNEL], got[attention.BWD_KERNEL],
                got[attention.STATS_KERNEL]) == (want_fwd, 6, 0), mode


def test_inception_extractor_on_cuda_matches_cpu(cuda, tmp_path, monkeypatch):
    """`InceptionFeatureExtractor` on the card against the same seeded
    weights on the CPU, 4 images of 128²: pool3 features within 1e-4 ·
    max|feature| (two f32 convolution algorithms over the network's ~20
    sequential convolutions, as the classifier above). The extractor turns
    TF32 off for its own calls, whatever the process-wide switches, and
    sets them back."""
    from synt_isic_tpu_torch.metrics.fid import InceptionFeatureExtractor, default_extractor
    from synt_isic_tpu_torch.io.pth import save_checkpoint
    from synt_isic_tpu_torch.models.inception_v3 import random_inception_state

    save_checkpoint({k: torch.from_numpy(v) for k, v in random_inception_state(0).items()},
                    str(tmp_path / "inception_v3.pth"))
    card = default_extractor(str(tmp_path), require_standard=True)
    assert isinstance(card, InceptionFeatureExtractor) and card.pretrained
    assert all(p.is_cuda for p in card.model.state_dict().values())
    cpu = InceptionFeatureExtractor(str(tmp_path / "inception_v3.pth"), device="cpu")
    x = _xai_frames(4)
    want = cpu(x)
    for tf32 in (True, False):
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
        got = card(x)
        assert torch.backends.cudnn.allow_tf32 is tf32
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert got.shape == (4, 2048) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_scoring_entry_points_take_cuda_and_raise_without_it(tmp_path):
    """The quality ladders and the family scripts default to CUDA and, on a
    machine without it, raise before they do any work: no run goes on on the
    CPU unless the caller asks for it."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    from synt_isic_tpu_torch.scripts import (augment_eval, distill_ladder, e2e_conditional,
                                             rescore_family_consistency, sampler_ladder,
                                             score_checkpoint, score_family, train_family)

    ckpt, out = str(tmp_path / "checkpoints"), str(tmp_path / "out")
    calls = {
        "score_checkpoint": lambda: score_checkpoint.main(["--checkpoints", ckpt, "--out", out]),
        "sampler_ladder": lambda: sampler_ladder.main(["--checkpoints", ckpt, "--out", out]),
        "augment_eval": lambda: augment_eval.main(["--checkpoints", ckpt, "--out", out]),
        "distill_ladder": lambda: distill_ladder.main(["--checkpoints", ckpt, "--out", out]),
        "train_family": lambda: train_family.main(["--out", out, "--classes", "MEL"]),
        "score_family": lambda: score_family.main(["--checkpoints", ckpt, "--out", out]),
        "rescore_family_consistency": lambda: rescore_family_consistency.main(
            ["--checkpoints", ckpt, "--out", out]),
        "e2e_conditional": lambda: e2e_conditional.main(["--out", out]),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        assert not (tmp_path / "out").exists(), name


def test_window_on_cuda_runs_the_kernel(cuda, tmp_path):
    """The desktop window (stub Qt) with its default devices: every CUDA
    device in the combo, device memory in MB, and a fixed-seed MEL:2 run at
    2 steps in one block of 2 with 6 K1 launches per step and no plain
    attention call."""
    from synt_isic_tpu_torch.app.gui import SyntheticDataGeneratorWindow
    from synt_isic_tpu_torch.models import unet2d as unet2d_module
    from synt_isic_tpu_torch.utils.config import ConfigManager

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), ckpt / "unet_MEL_best.pth")
    (tmp_path / "config.json").write_text(json.dumps({"generation": {"batch_size": 2}}))
    config = ConfigManager(config_file=str(tmp_path / "config.json"),
                           project_root=str(tmp_path))
    gen = ImageGenerator(config=config, checkpoints_dir=str(ckpt), model_config=cfg)
    win = SyntheticDataGeneratorWindow(config=config, generator=gen,
                                       checkpoints_dir=str(ckpt),
                                       output_dir=str(tmp_path / "out"),
                                       xai_results_dir=str(tmp_path / "xai"))
    n = torch.cuda.device_count()
    assert win.device_combo.currentText() == "cuda:0"
    assert win.device_combo.count() == n + (1 if n > 1 else 0)
    for cls, (cb, count) in win.class_rows.items():
        cb.setChecked(cls == "MEL")
    win.class_rows["MEL"][1].setValue(2)
    win.steps_spin.setValue(2)
    win.seed_mode.setCurrentText("fixed")
    win.seed_spin.setValue(0)
    plain = []
    original = unet2d_module.attention_reference

    def spy(*args, **kwargs):
        plain.append(1)
        return original(*args, **kwargs)

    unet2d_module.attention_reference = spy
    before = dict(attention.LAUNCHES)
    try:
        win.start_generation()
    finally:
        unet2d_module.attention_reference = original
    torch.cuda.synchronize()
    assert _launched(before)[attention.KERNEL] == 6 * 2 and not plain
    assert len(list((tmp_path / "out" / "MEL").glob("*.png"))) == 2
    win._update_memory_info()
    assert win.mem_label.text().startswith("mem: ") and win.mem_label.text().endswith(" MB)")


def test_smoke_generate_and_warm_cache_on_cuda(cuda, tmp_path, capsys):
    """smoke_generate on the card: 6 K1 launches per step for the one class;
    warm_cache: both kernels built, then every config's two walks (cold and
    warm) on the bf16 tensor-core kernel, 6 launches per step each."""
    from synt_isic_tpu_torch.scripts import smoke_generate, warm_cache

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    torch.manual_seed(0)
    torch.save(UNet2D(cfg).state_dict(), tmp_path / "unet_MEL_best.pth")
    before = dict(attention.LAUNCHES)
    assert smoke_generate.main(["--checkpoints", str(tmp_path), "--output",
                                str(tmp_path / "out"), "--samples", "2", "--steps", "3"],
                               model_config=cfg) == 0
    assert _launched(before)[attention.KERNEL] == 6 * 3
    assert len(list((tmp_path / "out").glob("MEL_sample*.png"))) == 2
    before = dict(attention.LAUNCHES)
    assert warm_cache.main(["--configs", "ddim:2:4", "ddpm:3:2", "--classifier-batches", "2"],
                           model_config=cfg) == 0
    assert _launched(before)[attention.KERNEL] == 2 * 6 * (2 + 3)
    out = capsys.readouterr().out
    assert "kernels built in" in out and "ddpm:3:2: cold" in out


@pytest.mark.parametrize("axes", [{"data": 1, "model": 2}, {"data": 2, "model": 2}],
                         ids=["1x2", "2x2"])
def test_tp_walk_on_one_card_matches_unsharded(cuda, monkeypatch, axes):
    """A DDIM walk over a ('data', 'model') mesh whose devices repeat the
    card: each data shard walks on its row with the UNet channel-sharded,
    K1 launches 6 times per UNet evaluation per row shard, each at the
    heads of one 'model' slice (8 / 2), and the walk (every frame) is
    within 1e-3 of the unsharded walk under full-f32 convolutions (the
    data-parallel walk's bound in `chip_smoke.py`, MESH_WALK_TOL)."""
    from unittest import mock

    from synt_isic_tpu_torch.parallel import ShardedSampler, create_mesh
    from synt_isic_tpu_torch.parallel import tensor_parallel

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    model = _walk_models(cuda, cfg)[True]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    steps, seeds = 3, [1, 2, 3, 4]
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=steps, scheduler="ddim",
                                             image_size=32), device=cuda)
    mesh = create_mesh(axes, [cuda] * (axes["data"] * axes["model"]))
    sharded = ShardedSampler(sampler, mesh)
    assert sharded.tp_axis == "model"
    heads, original = [], attention._ForwardPlan.__call__

    def call(plan, q, k, v):
        heads.append(q.shape[1])
        return original(plan, q, k, v)

    before, routes = dict(attention.LAUNCHES), dict(tensor_parallel.ROUTES)
    with mock.patch.object(attention._ForwardPlan, "__call__", call):
        got = sharded.sample(model, seeds, capture_trajectory=True)
    launched = _launched(before)
    assert launched[attention.KERNEL] == 6 * 2 * steps * axes["data"] == len(heads)
    assert set(heads) == {4}
    assert (tensor_parallel.ROUTES[tensor_parallel.HEADS] - routes[tensor_parallel.HEADS]
            == 6 * steps * axes["data"])
    want = sampler.sample(model, seeds, capture_trajectory=True)
    assert torch.isfinite(got["images"]).all()
    torch.testing.assert_close(got["trajectory"], want["trajectory"], rtol=1e-3, atol=1e-3)
    assert list(got["noise_hashes"]) == list(want["noise_hashes"])


def test_tp_replica_runs_the_kernels_under_grad(cuda):
    """A tensor-parallel replica on the card keeps every slice there and
    runs the kernels: under grad its attention runs the trainable pair (K1
    and K3 per shard), never the plain version."""
    from synt_isic_tpu_torch.parallel import tensor_parallel

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    model = _walk_models(cuda, cfg)[True]
    twin = tensor_parallel.tp_replica(model, [cuda, cuda])
    assert all(p.is_cuda for p in twin.parameters())
    x = torch.randn(2, 3, 32, 32, device=cuda, requires_grad=True)
    before = dict(attention.LAUNCHES)
    twin(x, torch.tensor([10, 500], device=cuda)).square().mean().backward()
    launched = _launched(before)
    assert launched[attention.KERNEL] == launched[attention.BWD_KERNEL] == 12
    assert torch.isfinite(x.grad).all()


def _just_written(cuda, seed):
    """A 32 MB tensor on the card that a kernel writes after the stream has
    spun for about a fifth of a second (`torch.cuda._sleep`): a copy queued
    behind it lands long after the host's next read."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn(4096, 2048, generator=g, device=cuda)
    torch.cuda._sleep(400_000_000)
    return a * 3 + 1


@pytest.mark.parametrize("where", ["spread", "gather"])
def test_tp_copies_to_the_cpu_land_before_the_host_reads(cuda, where):
    """A tensor-parallel row over the card and the CPU copies activations
    to the host in two places: `_spread` hands a CPU shard's layer its
    input, and `_gather` concatenates the slices on a CPU first device.
    The host reads either at once, so what it reads is the card's tensor
    (`x.cpu()`), never memory a queued copy has yet to fill."""
    from synt_isic_tpu_torch.parallel import tensor_parallel

    cpu, card = torch.device("cpu"), torch.device("cuda", torch.cuda.current_device())
    # as in a walk, every kernel below has run before, so no first launch
    # (a lazy module load) waits for the card; a seed of its own keeps a
    # reused pinned block from holding these values already
    _just_written(cuda, 0)
    torch.cuda.synchronize()
    x = _just_written(cuda, {"spread": 1, "gather": 2}[where])
    if where == "spread":
        # the host's first read of the CPU shard's copy
        seen = tensor_parallel._spread(x, [card, cpu])[1].clone()
    else:
        seen = tensor_parallel._gather([torch.zeros(x.shape[0], 1), x], cpu, 1)[:, 1:]
    assert torch.equal(seen, x.cpu())


@pytest.mark.parametrize("row", ["cuda-cpu", "cpu-cuda"])
def test_tp_walk_over_the_card_and_the_cpu_matches_unsharded(cuda, monkeypatch, row):
    """A 1 x 2 ('data', 'model') mesh over the card and the CPU, in either
    order (activations on the row's first device): the card's shard
    launches K1 6 times per UNet evaluation at its 4 of 8 heads, the CPU's
    shard runs the plain version, and the walk (every frame) is within 1e-3
    of the unsharded walk under full-f32 convolutions (MESH_WALK_TOL in
    `chip_smoke.py`)."""
    from synt_isic_tpu_torch.parallel import ShardedSampler, create_mesh
    from synt_isic_tpu_torch.parallel import tensor_parallel

    cfg = UNet2DConfig(sample_size=32, block_out_channels=(32, 64, 64, 64))
    model = _walk_models(cuda, cfg)[True]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    steps, seeds = 3, [1, 2]
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=steps, scheduler="ddim",
                                             image_size=32), device=cuda)
    devices = {"cuda-cpu": [cuda, "cpu"], "cpu-cuda": ["cpu", cuda]}[row]
    sharded = ShardedSampler(sampler, create_mesh({"data": 1, "model": 2}, devices))
    assert sharded.tp_axis == "model"
    heads, original = [], attention._ForwardPlan.__call__

    def call(plan, q, k, v):
        heads.append(q.shape[1])
        return original(plan, q, k, v)

    from unittest import mock

    before, routes = dict(attention.LAUNCHES), dict(tensor_parallel.ROUTES)
    with mock.patch.object(attention._ForwardPlan, "__call__", call):
        got = sharded.sample(model, seeds, capture_trajectory=True)
    launched = _launched(before)
    assert launched[attention.KERNEL] == 6 * steps == len(heads)
    assert set(heads) == {4}
    assert (tensor_parallel.ROUTES[tensor_parallel.HEADS] - routes[tensor_parallel.HEADS]
            == 6 * steps)
    want = sampler.sample(model, seeds, capture_trajectory=True)
    assert got["images"].device == want["images"].device
    assert torch.isfinite(got["images"]).all()
    torch.testing.assert_close(got["trajectory"].to(want["trajectory"].device),
                               want["trajectory"], rtol=1e-3, atol=1e-3)
    assert list(got["noise_hashes"]) == list(want["noise_hashes"])


# head_dims other than 8: the tensor-core kernels at a staged width of 8
# (head_dim 4), 16, 32, 64, 128 and 256, and the wide kernels above 256 (320,
# not a power of two, and 512), at a ragged T in both layouts and dtypes (bf16
# forward from 16 to 256: the warpgroup-product kernel)
HEAD_DIMS = (4, 16, 32, 64, 128, 256, 320, 512)


def _tf32_order_tol(d, bwd=False):
    """`chip_smoke.py` `tf32_order_tol`: head_dim 8's limit times
    sqrt(W / 8), W = `attention.staged_channels` (the staged width up to 64
    channels, above it the head's 64-channel chunks)."""
    base = TF32_BWD_ORDER_TOL if bwd else TF32_ORDER_TOL
    return base * math.sqrt(attention.staged_channels(d) / 8)


def _head_dim_args(cuda, d, dtype, layout, seed):
    args = _bf16_args(cuda, (2, 8, 101, d), layout, seed)
    return args if dtype == torch.bfloat16 else [z.float() for z in args]


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dim_forward(cuda, d, dtype, layout):
    """The forward at head_dim d and T = 101: within TOL of the plain version
    and (f32) of its own rounding order, its log-sum-exp within LSE_TOL and
    the output torch.equal with and without it, in q's strides; fast math
    near its rounding order (`_order_limit`); every G that divides the 8
    heads torch.equal to G = 1."""
    q, k, v, _ = _head_dim_args(cuda, d, dtype, layout, 40 + d)
    before = dict(attention.LAUNCHES)
    out, lse = attention.fused_attention(q, k, v, with_lse=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.KERNEL] == before[attention.KERNEL] + 1
    assert out.stride() == q.stride() and torch.equal(out, attention.fused_attention(q, k, v))
    want = attention.attention_reference(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=TOL[dtype], atol=TOL[dtype])
    torch.testing.assert_close(lse, attention.attention_lse_reference(q, k), rtol=0, atol=LSE_TOL)
    if dtype == torch.float32:
        order = attention.attention_tf32x3_kernel_order(q, k, v)
        assert (out - order).abs().max().item() <= _tf32_order_tol(d)
    fast = attention.fused_attention(q, k, v, fast_math=True)
    fast_order = attention.fast_math_kernel_order(q, k, v)
    assert ((fast.float() - fast_order.float()).abs()
            <= _order_limit(q, k, v, fast_order.float())).all()
    for group in (2, 4, 8):
        o_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
        assert torch.equal(o_g, out) and torch.equal(lse_g, lse), group
        assert torch.equal(attention.fused_attention(q, k, v, fast_math=True,
                                                     heads_per_program=group), fast), group


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_head_dim_trainable_gradient(cuda, d, dtype, layout):
    """K4 at head_dim d and T = 101: one forward with its statistics and one
    backward, no statistics launch; the gradients within BWD_TOL of the
    plain backward and within the kernel's rounding order's limit of it
    (bf16 BWD_ORDER_TOL, f32 `_tf32_order_tol`), in the strides of q, k, v;
    every G that divides the 8 heads torch.equal to G = 1."""
    q, k, v, do = _head_dim_args(cuda, d, dtype, layout, 50 + d)
    leaves = [z.detach().requires_grad_() for z in (q, k, v)]
    before = dict(attention.LAUNCHES)
    got = torch.autograd.grad(attention.fused_attention_trainable(*leaves), leaves, do)
    torch.cuda.synchronize()
    launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
    assert launched[attention.KERNEL] == launched[attention.BWD_KERNEL] == 1
    assert launched[attention.STATS_KERNEL] == 0
    want = attention.attention_bwd_reference(q, k, v, do)
    o, lse = attention.fused_attention(q, k, v, with_lse=True)
    if dtype == torch.float32:
        order = attention.attention_bwd_tf32x3_kernel_order(q, k, v, do, o, lse)
        order_tol = _tf32_order_tol(d, bwd=True)
    else:
        order = attention.attention_bwd_kernel_order(q, k, v, do, o, lse)
        order_tol = BWD_ORDER_TOL
    for name, a, w, r, src in zip(("dq", "dk", "dv"), got, want, order, (q, k, v)):
        assert a.dtype == dtype and a.stride() == src.stride(), name
        for ref, tol in ((w, BWD_TOL[dtype]), (r, order_tol)):
            ref = ref.float()
            torch.testing.assert_close(a.float(), ref, rtol=0,
                                       atol=tol * ref.abs().max().item(), msg=name)
    for group in (2, 4, 8):
        grouped = attention.fused_attention_bwd(q, k, v, do, heads_per_program=group, o=o,
                                                lse=lse)
        for a, w in zip(grouped, attention.fused_attention_bwd(q, k, v, do, o=o, lse=lse)):
            assert torch.equal(a, w), group


# the wide kernels (`attention.uses_wide`) at T = 1024 (16 key tiles, where
# the running shift moves) and at a ragged T: NC 2, 4 (the f32 forward's S on
# TF32 `wgmma`) and 8
WIDE_ORDER_DIMS = (128, 256, 320, 512)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("d", WIDE_ORDER_DIMS)
def test_wide_kernels_hold_their_rounding_orders(cuda, d, layout):
    """The wide kernels at head_dim d, one head, T = 1024 and 200: the f32
    forward within `_tf32_order_tol` of `attention_tf32x3_kernel_order`, its
    fast math near `fast_math_kernel_order` (`_order_limit`), the bf16
    forward (wide above 256) within one bf16 ulp of
    `attention_fast_math_kernel_order` in fast math; the backward from the
    saved statistics within the f32 and bf16 orders' limits of
    `attention_bwd_tf32x3_kernel_order` and `attention_bwd_kernel_order`;
    every launch counted under WIDE_KERNEL (BWD_WIDE_KERNEL) where
    `uses_wide` says so."""
    for t in (1024, 200):
        for dtype in (torch.float32, torch.bfloat16):
            args = _bf16_args(cuda, (1, 1, t, d), layout, 90 + d + t)
            q, k, v, do = args if dtype == torch.bfloat16 else [z.float() for z in args]
            before = dict(attention.LAUNCHES)
            out, lse = attention.fused_attention(q, k, v, with_lse=True)
            fast = attention.fused_attention(q, k, v, fast_math=True)
            grads = attention.fused_attention_bwd(q, k, v, do, o=out, lse=lse)
            torch.cuda.synchronize()
            launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
            wide = attention.uses_wide(dtype, d)
            assert launched[attention.WIDE_KERNEL] == (2 if wide else 0)
            assert launched[attention.BWD_WIDE_KERNEL] == launched[attention.BWD_KERNEL] == 1
            if dtype == torch.float32:
                order = attention.attention_tf32x3_kernel_order(q, k, v)
                assert (out - order).abs().max().item() <= _tf32_order_tol(d)
                fast_order = attention.fast_math_kernel_order(q, k, v)
                assert ((fast - fast_order).abs() <= _order_limit(q, k, v, fast_order)).all()
                bwd_order = attention.attention_bwd_tf32x3_kernel_order(q, k, v, do, out, lse)
                bwd_tol = _tf32_order_tol(d, bwd=True)
            else:
                fast_order = attention.attention_fast_math_kernel_order(
                    q, k, v, attention.fast_math_step(q))
                assert ((fast.float() - fast_order.float()).abs()
                        <= FAST_ORDER_TOL[torch.bfloat16]).all()
                bwd_order = attention.attention_bwd_kernel_order(q, k, v, do, out, lse)
                bwd_tol = BWD_ORDER_TOL
            torch.testing.assert_close(out.float(), attention.attention_reference(q, k, v).float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
            for name, a, r in zip(("dq", "dk", "dv"), grads, bwd_order):
                r = r.float()
                torch.testing.assert_close(a.float(), r, rtol=0,
                                           atol=bwd_tol * r.abs().max().item(), msg=name)


@pytest.mark.parametrize("d", (128, 512))
def test_wide_kernels_grouped_are_bit_identical(cuda, d):
    """heads_per_program 2 at head_dim 128 and 512 (the wide kernels run one
    head a block, as G / 1 consecutive groups): forward output and lse, fast
    math and K4's gradients torch.equal to G 1, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _bf16_args(cuda, (2, 4, 130, d), "BTC", 95 + d)
        q, k, v, do = args if dtype == torch.bfloat16 else [z.float() for z in args]
        runs = {}
        for group in (1, 2):
            leaves = [z.detach().requires_grad_() for z in (q, k, v)]
            out, lse = attention.fused_attention(q, k, v, heads_per_program=group, with_lse=True)
            fast = attention.fused_attention(q, k, v, fast_math=True, heads_per_program=group)
            grads = torch.autograd.grad(
                attention.fused_attention_trainable(*leaves, heads_per_program=group), leaves, do)
            runs[group] = (out, lse, fast, *grads)
        for name, a, b in zip(("out", "lse", "fast", "dq", "dk", "dv"), runs[1], runs[2]):
            assert torch.equal(a, b), (dtype, name)


@pytest.mark.parametrize("d", (640, 1090))
def test_wide_kernels_past_their_staged_rows(cuda, d):
    """Heads wider than the own rows a wide block stages (f32 512 channels
    forward and 256 a tensor backward, bf16 twice that): at head_dim 640
    (f32 forward, both backwards) and 1090 (every wide kernel; in bf16 a
    (B, T, C) row of 4360 bytes, staged by `cp.async`) the further channels
    come from device memory. Two heads at T = 150 in the (B, T, C) layout: forward,
    log-sum-exp and K3 from the saved statistics within TOL, LSE_TOL and
    BWD_TOL of the plain versions, every launch on the wide kernels."""
    for dtype in (torch.float32, torch.bfloat16):
        args = _bf16_args(cuda, (1, 2, 150, d), "BTC", 97 + d)
        q, k, v, do = args if dtype == torch.bfloat16 else [z.float() for z in args]
        before = dict(attention.LAUNCHES)
        out, lse = attention.fused_attention(q, k, v, with_lse=True)
        grads = attention.fused_attention_bwd(q, k, v, do, o=out, lse=lse)
        torch.cuda.synchronize()
        launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
        assert launched[attention.WIDE_KERNEL] == 1, dtype
        assert launched[attention.BWD_WIDE_KERNEL] == 1, dtype
        torch.testing.assert_close(out.float(), attention.attention_reference(q, k, v).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
        torch.testing.assert_close(lse, attention.attention_lse_reference(q, k), rtol=0,
                                   atol=LSE_TOL)
        for name, a, w in zip(("dq", "dk", "dv"), grads,
                              attention.attention_bwd_reference(q, k, v, do)):
            w = w.float()
            torch.testing.assert_close(a.float(), w, rtol=0,
                                       atol=BWD_TOL[dtype] * w.abs().max().item(), msg=name)


def test_bf16_head_dim_4_takes_an_unaligned_contiguous_tensor(cuda):
    """bf16 rows of head_dim 4 are 8 bytes; a contiguous tensor that starts 2
    bytes off is staged an element at a time: the same output, log-sum-exp
    and gradients, bit for bit, as from aligned storage; a G asked of such a
    call runs as G = 1 and is not counted grouped."""
    q, k, v, do = _bf16_args(cuda, (2, 8, 77, 4), "BHTD", 60)
    storage = torch.empty(k.numel() + 1, device=cuda, dtype=torch.bfloat16)
    k_off = storage[1:].view(k.shape)
    k_off.copy_(k)
    assert k_off.is_contiguous() and k_off.data_ptr() % 4 != 0
    out, lse = attention.fused_attention(q, k, v, with_lse=True)
    before = dict(attention.LAUNCHES)
    got, got_lse = attention.fused_attention(q, k_off, v, heads_per_program=8, with_lse=True)
    torch.cuda.synchronize()
    assert attention.LAUNCHES[attention.KERNEL] == before[attention.KERNEL] + 1
    assert attention.LAUNCHES[attention.GROUPED_KERNEL] == before[attention.GROUPED_KERNEL]
    assert torch.equal(got, out) and torch.equal(got_lse, lse)
    want = attention.fused_attention_bwd(q, k, v, do, o=out, lse=lse)
    for name, a, w in zip(("dq", "dk", "dv"),
                          attention.fused_attention_bwd(q, k_off, v, do, o=out, lse=lse), want):
        assert torch.equal(a, w), name


WGMMA_DIMS = (16, 32, 64, 128, 256)


@pytest.mark.parametrize("layout", ["BHTD", "BTC"])
@pytest.mark.parametrize("d", WGMMA_DIMS)
def test_wgmma_forward(cuda, d, layout):
    """The bf16 forward's warpgroup-product kernel at staged width d, at
    T = 101 and 1024: each call one launch, counted under WGMMA_KERNEL beside
    KERNEL or FAST_KERNEL; within one bf16 ulp (TOL) of the plain version,
    its log-sum-exp within LSE_TOL, fast math within FAST_ORDER_TOL of
    `attention_fast_math_kernel_order` at the kernel's keys per max update;
    an unaligned contiguous k (staged an element at a time) and G = 2
    torch.equal to the aligned G = 1 call."""
    for t in (101, 1024):
        q, k, v, _ = _bf16_args(cuda, (2, 4, t, d), layout, 70 + d + t)
        before = dict(attention.LAUNCHES)
        out, lse = attention.fused_attention(q, k, v, with_lse=True)
        fast = attention.fused_attention(q, k, v, fast_math=True)
        torch.cuda.synchronize()
        launched = {key: attention.LAUNCHES[key] - before[key] for key in before}
        assert launched[attention.WGMMA_KERNEL] == 2
        assert launched[attention.KERNEL] == launched[attention.FAST_KERNEL] == 1
        want = attention.attention_reference(q, k, v).float()
        tol = TOL[torch.bfloat16]
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)
        torch.testing.assert_close(lse, attention.attention_lse_reference(q, k), rtol=0,
                                   atol=LSE_TOL)
        order = attention.attention_fast_math_kernel_order(q, k, v, attention.fast_math_step(q))
        assert ((fast.float() - order.float()).abs() <= FAST_ORDER_TOL[torch.bfloat16]).all()
        storage = torch.empty(k.numel() + 1, device=cuda, dtype=torch.bfloat16)
        k_off = storage[1:].view(k.shape)
        k_off.copy_(k)
        assert k_off.is_contiguous() and k_off.data_ptr() % 4 != 0
        got, got_lse = attention.fused_attention(q, k_off, v, with_lse=True)
        assert torch.equal(got, out) and torch.equal(got_lse, lse)
        o_g, lse_g = attention.fused_attention(q, k, v, heads_per_program=2, with_lse=True)
        assert torch.equal(o_g, out) and torch.equal(lse_g, lse)
        assert torch.equal(attention.fused_attention(q, k, v, fast_math=True,
                                                     heads_per_program=2), fast)
