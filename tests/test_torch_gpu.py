"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test is marked `gpu` and skips without CUDA.

This file imports neither JAX nor the JAX package, so on a machine without
JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: f32 as the Pallas kernel is held to its einsum reference
(`tests/test_pallas_ops.py`); bf16 one bf16 ulp of the output, 2^-6 at
|x| < 4, since the kernel and the plain version round at different points.
"""
import pytest
import torch

from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.ops import attention

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


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
    q = torch.zeros(1, 2, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q, q)                 # head_dim 16
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
