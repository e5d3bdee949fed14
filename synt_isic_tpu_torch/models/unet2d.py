"""UNet2D: the per-class DDPM epsilon-predictor, in PyTorch.

The port of `synt_isic_tpu/models/unet2d.py`. The architecture is the
reference's diffusers `UNet2DModel(sample_size=128, in/out=3,
layers_per_block=2, block_out_channels=(64,128,256,256),
down=(Down,Down,AttnDown,Down), up=(Up,AttnUp,Up,Up))`; the parameter names
are the diffusers state-dict keys, so `load_state_dict(strict=True)` takes a
reference `.pth` unchanged.

Tensors are NCHW, PyTorch's habit. The numerics follow the JAX model:
  * `dtype` is the compute dtype of every conv, linear and class-embedding
    layer: inputs and weights are cast to it inside `forward`, as Flax's
    `dtype` does. `param_dtype` is the dtype the weights are stored in
    (Flax's `param_dtype`; default `dtype`, so a bf16 sampling model keeps
    bf16 weights and the casts are no-ops, while the trainer keeps f32
    weights under bf16 compute). GroupNorm statistics are always f32, and
    the final `conv_norm_out`/`conv_out` run in f32;
  * `fast_norm` (sub-f32 sampling) keeps the GroupNorm statistics in f32
    but the normalisation arithmetic in `dtype` (`ops/norms.py`);
  * `use_fused_attention` routes the attention core through the
    hand-written CUDA kernels on a CUDA device: `fused_attention` (forward
    only) when no gradient is taken, `fused_attention_trainable` (forward
    and backward kernels) when one is; otherwise it runs the plain einsum
    path. `fused_heads_per_program` and `fused_fast_math` are the kernel's
    knobs (JAX `unet2d.py:185-186`): heads per block (identical results)
    and bf16 exponentials (bf16-level deviation); the einsum path ignores
    them, as in the JAX model;
  * `remat` trades compute for training memory as `jax.checkpoint` does in
    the JAX model (`unet2d.py:420-449`): the chosen blocks keep only their
    inputs and run their forward again in the backward
    (`torch.utils.checkpoint`, non-reentrant, so the recompute runs with
    grad on and the attention blocks take the trainable kernel and save
    its log-sum-exp again). "dots" keeps the 2-D matrix products (the
    Linear layers) and recomputes the rest, as JAX's
    `dots_with_no_batch_dims_saveable` does. Outputs and gradients are
    those of `remat=False`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops.attention import (attention_reference, fused_attention,
                             fused_attention_trainable)
from ..ops.norms import group_norm_silu_fast


@dataclasses.dataclass(frozen=True)
class UNet2DConfig:
    sample_size: int = 128
    in_channels: int = 3
    out_channels: int = 3
    layers_per_block: int = 2
    block_out_channels: Tuple[int, ...] = (64, 128, 256, 256)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D", "DownBlock2D", "AttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "AttnUpBlock2D", "UpBlock2D", "UpBlock2D")
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: int = 0
    add_mid_attention: bool = True
    # class-conditional variant (diffusers `num_class_embeds`): an embedding
    # row added to the timestep embedding; the last index is the null class.
    # None = unconditional (the reference's per-class checkpoints).
    num_class_embeds: Optional[int] = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def _cast(w: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if w is None else w.to(dtype)


class Conv2d(nn.Conv2d):
    """Conv2d computing in `dtype` on weights stored in `param_dtype`
    (Flax `dtype`/`param_dtype`; the default stores them in `dtype`)."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, dtype=param_dtype or dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        return self._conv_forward(x.to(d), self.weight.to(d), _cast(self.bias, d))


class Linear(nn.Linear):
    """Linear computing in `dtype` on weights stored in `param_dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, dtype=param_dtype or dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        x, w, b = x.to(d), self.weight.to(d), _cast(self.bias, d)
        if b is not None and x.dim() > 2 and not x.is_contiguous():
            # F.linear's own route for such an input (the product, then the
            # bias), with the bias added out of place: the product stays as
            # it was computed, which "dots" remat keeps
            return torch.matmul(x, w.t()) + b
        return F.linear(x, w, b)


class Embedding(nn.Embedding):
    """Embedding table stored in `param_dtype`, rows returned in `dtype`."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None, **kwargs):
        super().__init__(*args, dtype=param_dtype or dtype, **kwargs)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def get_timestep_embedding(timesteps: torch.Tensor, embedding_dim: int,
                           flip_sin_to_cos: bool = True,
                           downscale_freq_shift: float = 0.0,
                           max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (Transformer-style positional), f32."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """MLP on the sinusoidal features: linear_1 -> silu -> linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.linear_1 = Linear(in_dim, time_embed_dim, **kw)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, **kw)

    def forward(self, t_emb: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class ResnetBlock2D(nn.Module):
    """norm1 -> silu -> conv1 -> (+ FiLM temb) -> norm2 -> silu -> conv2, residual."""

    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 groups: int = 32, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, fast_norm: bool = False,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.groups, self.eps, self.dtype, self.fast_norm = groups, eps, dtype, fast_norm
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.time_emb_proj = Linear(temb_channels, out_channels, **kw)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def _norm_silu(self, norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        if self.fast_norm:
            return group_norm_silu_fast(x.to(self.dtype), norm.weight, norm.bias,
                                        self.groups, self.eps)
        return F.silu(norm(x.float())).to(self.dtype)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        t = self.time_emb_proj(F.silu(temb))
        h = self.conv1(self._norm_silu(self.norm1, x))
        h = h + t[:, :, None, None]
        h = self.conv2(self._norm_silu(self.norm2, h))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over HW tokens with residual connection.

    diffusers' deprecated-attn-block semantics: GroupNorm, per-head q/k/v
    projections (heads = channels // head_dim), f32 softmax, output
    projection, additive residual. The (B, T, C) projections go to the
    attention core as (B, H, T, D) views and come back the same way, with
    no copy for the head split on either side.
    """

    def __init__(self, channels: int, head_dim: int = 8, groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 use_fused: bool = False, fast_norm: bool = False,
                 param_dtype: Optional[torch.dtype] = None,
                 fused_heads_per_program: int = 1, fused_fast_math: bool = False):
        super().__init__()
        self.head_dim, self.groups, self.eps = head_dim, groups, eps
        self.dtype, self.use_fused, self.fast_norm = dtype, use_fused, fast_norm
        self.fused_heads_per_program = fused_heads_per_program
        self.fused_fast_math = fused_fast_math
        kw = dict(dtype=dtype, param_dtype=param_dtype)
        self.group_norm = nn.GroupNorm(groups, channels, eps=eps)
        self.to_q = Linear(channels, channels, **kw)
        self.to_k = Linear(channels, channels, **kw)
        self.to_v = Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([Linear(channels, channels, **kw)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.tokens(x)
        q, k, v = (self.heads(z) for z in (self.to_q(y), self.to_k(y), self.to_v(y)))
        out = self.to_out[0](self.merge(self.attend(q, k, v)))
        return x + out.transpose(1, 2).reshape(b, c, h, w)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """The normalised input as (B, T, C) tokens in the compute dtype."""
        b, c, h, w = x.shape
        if self.fast_norm:
            y = group_norm_silu_fast(x.to(self.dtype), self.group_norm.weight,
                                     self.group_norm.bias, self.groups, self.eps,
                                     silu=False)
        else:
            y = self.group_norm(x.float())
        return y.to(self.dtype).reshape(b, c, h * w).transpose(1, 2)

    def heads(self, z: torch.Tensor) -> torch.Tensor:
        """A (B, T, C) projection as a (B, C / head_dim, T, head_dim) view."""
        b, t, c = z.shape
        return z.view(b, t, c // self.head_dim, self.head_dim).transpose(1, 2)

    @staticmethod
    def merge(out: torch.Tensor) -> torch.Tensor:
        """(B, H, T, D) heads back to (B, T, H * D) tokens."""
        b, h, t, d = out.shape
        return out.transpose(1, 2).reshape(b, t, h * d)

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The attention core over (B, H, T, D) heads, in the compute dtype:
        the kernels where `use_fused` (the trainable pair when a gradient is
        taken), else the einsum path."""
        if not self.use_fused:
            out = attention_reference(q, k, v)
        else:
            trainable = torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad)
            attention = fused_attention_trainable if trainable else fused_attention
            out = attention(q, k, v, self.fused_fast_math, self.fused_heads_per_program)
        return out.to(self.dtype)


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=1, dtype=dtype,
                           param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype,
                           param_dtype=param_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


@dataclasses.dataclass(frozen=True)
class _Layers:
    """Builds the blocks' resnets and attentions with the model-wide
    settings."""
    temb_channels: int
    groups: int
    eps: float
    dtype: torch.dtype
    fast_norm: bool
    head_dim: int
    use_fused_attention: bool
    param_dtype: torch.dtype
    fused_heads_per_program: int
    fused_fast_math: bool

    def resnet(self, in_channels: int, out_channels: int) -> ResnetBlock2D:
        return ResnetBlock2D(in_channels, out_channels, self.temb_channels,
                             self.groups, self.eps, self.dtype, self.fast_norm,
                             self.param_dtype)

    def downsample(self, channels: int) -> Downsample2D:
        return Downsample2D(channels, self.dtype, self.param_dtype)

    def upsample(self, channels: int) -> Upsample2D:
        return Upsample2D(channels, self.dtype, self.param_dtype)

    def attention(self, channels: int) -> AttentionBlock:
        return AttentionBlock(channels, self.head_dim, self.groups, self.eps,
                              self.dtype, self.use_fused_attention, self.fast_norm,
                              self.param_dtype, self.fused_heads_per_program,
                              self.fused_fast_math)


class DownBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool, with_attention: bool, layers: _Layers):
        super().__init__()
        self.resnets = nn.ModuleList([
            layers.resnet(in_channels if i == 0 else out_channels, out_channels)
            for i in range(num_layers)])
        self.attentions = (nn.ModuleList([layers.attention(out_channels)
                                          for _ in range(num_layers)])
                           if with_attention else None)
        self.downsamplers = (nn.ModuleList([layers.downsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor):
        states = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[i](x)
            states.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            states.append(x)
        return x, states


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, add_attention: bool, layers: _Layers):
        super().__init__()
        self.resnets = nn.ModuleList([layers.resnet(channels, channels)
                                      for _ in range(2)])
        self.attentions = (nn.ModuleList([layers.attention(channels)])
                           if add_attention else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x, temb)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x, temb)


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, prev_output_channel: int,
                 out_channels: int, num_layers: int, add_upsample: bool,
                 with_attention: bool, layers: _Layers):
        super().__init__()
        resnets = []
        for i in range(num_layers):
            res_skip = in_channels if i == num_layers - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            resnets.append(layers.resnet(res_in + res_skip, out_channels))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = (nn.ModuleList([layers.attention(out_channels)
                                          for _ in range(num_layers)])
                           if with_attention else None)
        self.upsamplers = (nn.ModuleList([layers.upsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x: torch.Tensor, skips: List[torch.Tensor],
                temb: torch.Tensor) -> torch.Tensor:
        for i, resnet in enumerate(self.resnets):
            skip = skips.pop()
            x = resnet(torch.cat([x, skip.to(x.dtype)], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[i](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


REMAT_MODES = ("none", "all", "hires", "attn", "dots")
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def remat_mode(remat) -> str:
    """The mode a `remat` argument names: a bool (True is "all") or one of
    REMAT_MODES."""
    mode = remat if isinstance(remat, str) else ("all" if remat else "none")
    if mode not in REMAT_MODES:
        raise ValueError(f"unknown remat mode {mode!r} "
                         "(expected bool or all/hires/attn/dots)")
    return mode


def save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """"dots": keep the 2-D matrix products, recompute everything else
    (convolutions, norms, elementwise ops, the attention kernel)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _block_remat(mode: str, is_hires: bool, has_attn: bool) -> bool:
    """Whether a block recomputes its forward (the JAX `want_block`)."""
    return (mode in ("all", "dots") or (mode == "hires" and is_hires)
            or (mode == "attn" and has_attn))


class UNet2D(nn.Module):
    """Top-level epsilon-prediction UNet. Input and output NCHW; the output
    is f32. `param_dtype` (default `dtype`) is the storage dtype of the conv,
    linear and embedding weights; GroupNorm weights and `conv_out` are
    always f32. `remat` (a bool or a mode of REMAT_MODES) picks the blocks
    whose forward the backward runs again."""

    def __init__(self, config: UNet2DConfig = UNet2DConfig(),
                 dtype: torch.dtype = torch.float32,
                 use_fused_attention: bool = False, fast_norm: bool = False,
                 param_dtype: Optional[torch.dtype] = None,
                 fused_heads_per_program: int = 1, fused_fast_math: bool = False,
                 remat=False):
        super().__init__()
        cfg = self.config = config
        self.remat = mode = remat_mode(remat)
        last_block = len(cfg.block_out_channels) - 1
        self.remat_blocks = {
            "down": [_block_remat(mode, i == 0, t == "AttnDownBlock2D")
                     for i, t in enumerate(cfg.down_block_types)],
            "mid": _block_remat(mode, False, cfg.add_mid_attention),
            "up": [_block_remat(mode, i == last_block, t == "AttnUpBlock2D")
                   for i, t in enumerate(cfg.up_block_types)]}
        self.dtype = dtype
        self.param_dtype = param_dtype = param_dtype or dtype
        # the kernel switches, which a replica on another device takes again
        self.use_fused_attention, self.fast_norm = use_fused_attention, fast_norm
        self.fused_heads_per_program = fused_heads_per_program
        self.fused_fast_math = fused_fast_math
        temb = cfg.time_embed_dim
        last = len(cfg.block_out_channels) - 1
        layers = _Layers(temb, cfg.norm_num_groups, cfg.norm_eps, dtype, fast_norm,
                         cfg.attention_head_dim, use_fused_attention, param_dtype,
                         fused_heads_per_program, fused_fast_math)
        kw = dict(dtype=dtype, param_dtype=param_dtype)

        self.conv_in = Conv2d(cfg.in_channels, cfg.block_out_channels[0], 3,
                              padding=1, **kw)
        self.time_embedding = TimestepEmbedding(cfg.block_out_channels[0], temb, **kw)
        self.class_embedding = (Embedding(cfg.num_class_embeds, temb, **kw)
                                if cfg.num_class_embeds else None)

        self.down_blocks = nn.ModuleList()
        out_ch = cfg.block_out_channels[0]
        for i, block_type in enumerate(cfg.down_block_types):
            in_ch, out_ch = out_ch, cfg.block_out_channels[i]
            self.down_blocks.append(DownBlock2D(
                in_ch, out_ch, cfg.layers_per_block, add_downsample=i != last,
                with_attention=block_type == "AttnDownBlock2D", layers=layers))

        self.mid_block = UNetMidBlock2D(cfg.block_out_channels[-1],
                                        cfg.add_mid_attention, layers)

        self.up_blocks = nn.ModuleList()
        reversed_ch = tuple(reversed(cfg.block_out_channels))
        out_ch = reversed_ch[0]
        for i, block_type in enumerate(cfg.up_block_types):
            prev_out, out_ch = out_ch, reversed_ch[i]
            self.up_blocks.append(UpBlock2D(
                reversed_ch[min(i + 1, last)], prev_out, out_ch,
                cfg.layers_per_block + 1, add_upsample=i != last,
                with_attention=block_type == "AttnUpBlock2D", layers=layers))

        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups,
                                          cfg.block_out_channels[0], eps=cfg.norm_eps)
        self.conv_out = Conv2d(cfg.block_out_channels[0], cfg.out_channels, 3,
                               padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                class_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample: (B, C, H, W); timesteps: scalar or (B,) ints; class_labels:
        (B,) class ids, required iff the config is conditional."""
        cfg = self.config
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        t_emb = get_timestep_embedding(timesteps, cfg.block_out_channels[0],
                                       flip_sin_to_cos=cfg.flip_sin_to_cos,
                                       downscale_freq_shift=float(cfg.freq_shift))
        emb = self.time_embedding(t_emb)
        if self.class_embedding is not None:
            if class_labels is None:
                raise ValueError("conditional UNet2D (num_class_embeds set) "
                                 "requires class_labels")
            emb = emb + self.class_embedding(class_labels.long())
        elif class_labels is not None:
            raise ValueError("class_labels passed to an unconditional UNet2D "
                             "(num_class_embeds is None)")

        x = self.conv_in(sample)
        skips = [x]
        for block, remat in zip(self.down_blocks, self.remat_blocks["down"]):
            x, states = self._run(remat, block, x, emb)
            skips.extend(states)

        x = self._run(self.remat_blocks["mid"], self.mid_block, x, emb)

        for block, remat in zip(self.up_blocks, self.remat_blocks["up"]):
            n = len(block.resnets)
            block_skips, skips = skips[-n:], skips[:-n]
            # the skips go in as tensors: the block pops from its list, and a
            # recompute must find them all again
            x = self._run(remat, _up_block, block, x, emb, *block_skips)

        return self.conv_out(F.silu(self.conv_norm_out(x.float())))

    def _run(self, remat: bool, fn, *args):
        """fn(*args), its forward run again in the backward where `remat`
        says so and a gradient is being taken."""
        if not (remat and torch.is_grad_enabled()):
            return fn(*args)
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 save_matmuls)
        # the blocks draw no random numbers, so no generator state is stashed
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _up_block(block: UpBlock2D, x: torch.Tensor, temb: torch.Tensor,
              *skips: torch.Tensor) -> torch.Tensor:
    return block(x, list(skips), temb)
