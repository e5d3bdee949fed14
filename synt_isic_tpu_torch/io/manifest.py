"""Expected checkpoint key/shape manifest for diffusers UNet2DModel weights.

The reference's checkpoints are raw `state_dict()` dumps of diffusers
`UNet2DModel` (config at reference `core/generator/model_manager.py:173-194`,
pin `requirements.txt:6` diffusers>=0.21). diffusers is not importable in
this framework, so `expected_unet2d_state_shapes` re-derives the exact key
set and shapes from diffusers' construction rules:

  * UNet2DModel (src/diffusers/models/unet_2d.py): conv_in 3x3,
    Timesteps (no params), TimestepEmbedding(ch0 -> 4*ch0) linear_1/linear_2,
    conv_norm_out, conv_out 3x3; down block i consumes prev out ->
    block_out_channels[i] with add_downsample on all but the last; up block i
    walks reversed channels with num_layers=layers_per_block+1 resnets whose
    input is prev_output (j=0) else out, concatenated with the skip
    (out for j<last, reversed[min(i+1,last)] for j=last), add_upsample on
    all but the last; mid block = resnet + attention + resnet.
  * ResnetBlock2D (src/diffusers/models/resnet.py): norm1/conv1/
    time_emb_proj/norm2/conv2 (+ conv_shortcut 1x1 iff in != out).
  * Attention with `_from_deprecated_attn_block=True`
    (src/diffusers/models/attention_processor.py): group_norm +
    to_q/to_k/to_v (bias=True) + to_out.0.
  * Downsample2D(name="op") / Upsample2D(name="conv") both register the
    conv as `conv` -> `downsamplers.0.conv.*` / `upsamplers.0.conv.*`.

`validate_state_dict` checks a loaded state dict against this manifest and
reports every missing/unexpected key and shape mismatch, so a checkpoint
that doesn't match the architecture can never load silently.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

Shape = Tuple[int, ...]

# legacy (<0.18 diffusers) attention spellings, normalized before comparison
_LEGACY_ATTN_SEGMENTS = {
    "query": "to_q",
    "key": "to_k",
    "value": "to_v",
    "proj_attn": "to_out.0",
}


def _resnet(prefix: str, in_ch: int, out_ch: int, temb: int) -> Dict[str, Shape]:
    keys = {
        f"{prefix}.norm1.weight": (in_ch,),
        f"{prefix}.norm1.bias": (in_ch,),
        f"{prefix}.conv1.weight": (out_ch, in_ch, 3, 3),
        f"{prefix}.conv1.bias": (out_ch,),
        f"{prefix}.time_emb_proj.weight": (out_ch, temb),
        f"{prefix}.time_emb_proj.bias": (out_ch,),
        f"{prefix}.norm2.weight": (out_ch,),
        f"{prefix}.norm2.bias": (out_ch,),
        f"{prefix}.conv2.weight": (out_ch, out_ch, 3, 3),
        f"{prefix}.conv2.bias": (out_ch,),
    }
    if in_ch != out_ch:
        keys[f"{prefix}.conv_shortcut.weight"] = (out_ch, in_ch, 1, 1)
        keys[f"{prefix}.conv_shortcut.bias"] = (out_ch,)
    return keys


def _attention(prefix: str, ch: int) -> Dict[str, Shape]:
    keys: Dict[str, Shape] = {
        f"{prefix}.group_norm.weight": (ch,),
        f"{prefix}.group_norm.bias": (ch,),
    }
    for proj in ("to_q", "to_k", "to_v"):
        keys[f"{prefix}.{proj}.weight"] = (ch, ch)
        keys[f"{prefix}.{proj}.bias"] = (ch,)
    keys[f"{prefix}.to_out.0.weight"] = (ch, ch)
    keys[f"{prefix}.to_out.0.bias"] = (ch,)
    return keys


def expected_unet2d_state_shapes(
        in_channels: int = 3, out_channels: int = 3, layers_per_block: int = 2,
        block_out_channels: Sequence[int] = (64, 128, 256, 256),
        down_block_types: Sequence[str] = ("DownBlock2D", "DownBlock2D",
                                           "AttnDownBlock2D", "DownBlock2D"),
        up_block_types: Sequence[str] = ("UpBlock2D", "AttnUpBlock2D",
                                         "UpBlock2D", "UpBlock2D"),
        add_mid_attention: bool = True,
        num_class_embeds=None,
        **_ignored) -> Dict[str, Shape]:
    """The exact diffusers UNet2DModel state-dict manifest (see module doc).

    Defaults are the reference architecture; keyword names match both
    `UNet2DConfig` fields and diffusers kwargs (extra config fields such as
    sample_size carry no parameters and are ignored).
    """
    ch0 = block_out_channels[0]
    temb = ch0 * 4
    last = len(block_out_channels) - 1
    keys: Dict[str, Shape] = {
        "conv_in.weight": (ch0, in_channels, 3, 3),
        "conv_in.bias": (ch0,),
        "time_embedding.linear_1.weight": (temb, ch0),
        "time_embedding.linear_1.bias": (temb,),
        "time_embedding.linear_2.weight": (temb, temb),
        "time_embedding.linear_2.bias": (temb,),
        "conv_norm_out.weight": (ch0,),
        "conv_norm_out.bias": (ch0,),
        "conv_out.weight": (out_channels, ch0, 3, 3),
        "conv_out.bias": (out_channels,),
    }
    if num_class_embeds:
        # conditional variant: nn.Embedding(num_class_embeds, time_embed_dim)
        # added to the timestep embedding (diffusers `num_class_embeds`)
        keys["class_embedding.weight"] = (int(num_class_embeds), temb)

    out_ch = ch0
    for i, btype in enumerate(down_block_types):
        in_ch, out_ch = out_ch, block_out_channels[i]
        for j in range(layers_per_block):
            keys.update(_resnet(f"down_blocks.{i}.resnets.{j}",
                                in_ch if j == 0 else out_ch, out_ch, temb))
            if btype == "AttnDownBlock2D":
                keys.update(_attention(f"down_blocks.{i}.attentions.{j}", out_ch))
        if i != last:
            keys[f"down_blocks.{i}.downsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            keys[f"down_blocks.{i}.downsamplers.0.conv.bias"] = (out_ch,)

    mid_ch = block_out_channels[-1]
    keys.update(_resnet("mid_block.resnets.0", mid_ch, mid_ch, temb))
    if add_mid_attention:
        keys.update(_attention("mid_block.attentions.0", mid_ch))
    keys.update(_resnet("mid_block.resnets.1", mid_ch, mid_ch, temb))

    reversed_ch = tuple(reversed(block_out_channels))
    out_ch = reversed_ch[0]
    for i, btype in enumerate(up_block_types):
        prev_out, out_ch = out_ch, reversed_ch[i]
        skip_in = reversed_ch[min(i + 1, last)]
        for j in range(layers_per_block + 1):
            res_skip = skip_in if j == layers_per_block else out_ch
            res_in = prev_out if j == 0 else out_ch
            keys.update(_resnet(f"up_blocks.{i}.resnets.{j}",
                                res_in + res_skip, out_ch, temb))
            if btype == "AttnUpBlock2D":
                keys.update(_attention(f"up_blocks.{i}.attentions.{j}", out_ch))
        if i != last:
            keys[f"up_blocks.{i}.upsamplers.0.conv.weight"] = (out_ch, out_ch, 3, 3)
            keys[f"up_blocks.{i}.upsamplers.0.conv.bias"] = (out_ch,)
    return keys


def normalize_key(key: str) -> str:
    """Map legacy attention spellings onto the modern manifest names."""
    parts = key.split(".")
    out: List[str] = []
    for p in parts:
        out.extend(_LEGACY_ATTN_SEGMENTS.get(p, p).split("."))
    return ".".join(out)


def validate_state_dict(state: Mapping[str, np.ndarray],
                        manifest: Mapping[str, Shape]) -> List[str]:
    """Return a list of human-readable problems (empty == valid).

    Checks every manifest key is present with the right shape and flags
    unexpected keys. `num_batches_tracked` bookkeeping entries are ignored;
    legacy attention spellings are normalized first.
    """
    seen: Dict[str, Shape] = {}
    for k, v in state.items():
        if k.endswith("num_batches_tracked"):
            continue
        seen[normalize_key(k)] = tuple(np.asarray(v).shape)

    problems: List[str] = []
    for k, shape in manifest.items():
        if k not in seen:
            problems.append(f"missing key: {k} {shape}")
        elif seen[k] != tuple(shape):
            problems.append(f"shape mismatch: {k} checkpoint={seen[k]} "
                            f"expected={tuple(shape)}")
    for k in seen:
        if k not in manifest:
            problems.append(f"unexpected key: {k} {seen[k]}")
    return sorted(problems)
