"""`UNet2D(remat=...)`, the port of the JAX model's `jax.checkpoint` modes,
on the CPU.

Every mode gives the outputs and the gradients of `remat=False` exactly:
the recompute runs the same operations on the same inputs (the fused
attention route on the CPU is the autograd Function over the plain forward
and backward), and the backward graph, so the order in which gradients
add up, is the same. Each mode holds fewer bytes for the backward than
`none`: the tensors the autograd graph saves (counted once per storage by
`saved_tensors_hooks`; checkpointed blocks save only their inputs there)
plus, for "dots", the matrix products its selective-checkpoint policy
keeps aside.
"""
import pytest
import torch

from synt_isic_tpu_torch.models import unet2d
from synt_isic_tpu_torch.models.unet2d import UNet2D

from tests.torch_port_fixtures import TINY

MODES = ("all", "hires", "attn", "dots")
SAVE_MATMULS = unet2d.save_matmuls


def _run(mode, monkeypatch, dtype=torch.float32):
    """(output, gradients by name, bytes held for the backward) of one
    forward and backward of the tiny UNet."""
    torch.manual_seed(0)
    model = UNet2D(TINY, dtype=dtype, param_dtype=torch.float32,
                   use_fused_attention=True, remat=mode)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 3, 16, 16, generator=g)
    t = torch.tensor([10, 700])
    held = {}
    kept = []

    def pack(z):
        held[z.untyped_storage().data_ptr()] = z.untyped_storage().nbytes()
        return z

    def counting_policy(ctx, op, *args, **kwargs):
        policy = SAVE_MATMULS(ctx, op, *args, **kwargs)
        if policy == unet2d.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]
            kept.append(a.shape[0] * b.shape[1] * a.element_size())
        return policy

    monkeypatch.setattr(unet2d, "save_matmuls", counting_policy)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda z: z):
        out = model(x, t)
    out.square().mean().backward()
    return (out.detach(), {k: p.grad for k, p in model.named_parameters()},
            sum(held.values()) + sum(kept))


@pytest.fixture(scope="module")
def plain():
    with pytest.MonkeyPatch.context() as mp:
        return _run(False, mp)


@pytest.mark.parametrize("mode", MODES)
def test_remat_gives_the_same_outputs_and_gradients_with_less_saved(plain, mode,
                                                                     monkeypatch):
    out, grads, held = _run(mode, monkeypatch)
    assert torch.equal(out, plain[0])
    assert grads.keys() == plain[1].keys()
    for name, g in grads.items():
        assert torch.equal(g, plain[1][name]), name
    assert held < plain[2], (mode, held, plain[2])


def test_remat_bf16_compute_matches_and_modes_are_named(monkeypatch):
    """bf16 compute on f32 parameters, as the trainer runs: "all" and
    "dots" equal to no remat; a bool names "all" or "none"; an unknown mode
    raises, as the JAX model does."""
    want = _run("none", monkeypatch, torch.bfloat16)
    for mode in ("all", "dots"):
        out, grads, _ = _run(mode, monkeypatch, torch.bfloat16)
        assert torch.equal(out, want[0])
        assert all(torch.equal(g, want[1][k]) for k, g in grads.items())
    assert UNet2D(TINY, remat=True).remat == "all"
    assert UNet2D(TINY, remat=False).remat == "none"
    # the JAX want_block: hires = first down and last up block; attn = the
    # attention-bearing ones
    hires, attn = UNet2D(TINY, remat="hires"), UNet2D(TINY, remat="attn")
    assert hires.remat_blocks == {"down": [True, False, False], "mid": False,
                                  "up": [False, False, True]}
    assert attn.remat_blocks == {"down": [False, True, False], "mid": True,
                                 "up": [False, True, False]}
    with pytest.raises(ValueError, match="unknown remat mode 'some'"):
        UNet2D(TINY, remat="some")
