"""Torch state dict <-> Flax parameter tree, both directions.

`torch_to_flax` and `flax_to_torch` are the JAX package's checkpoint
conversion (numpy only; `synt_isic_tpu/io/convert.py`): merged index
segments (`resnets.1` <-> `resnets_1`), conv kernels OIHW <-> HWIO, Dense
kernels (O, I) <-> (I, O), GroupNorm and BatchNorm `weight` <-> `scale`, the
frozen BatchNorm statistics `running_mean`/`running_var` <-> `mean`/`var`,
`nn.Embed` tables in their own layout, and the legacy diffusers attention
names (`query/key/value/proj_attn`) read as `to_q/to_k/to_v/to_out.0`.
`flatten_tree` / `unflatten_tree` give a tree the `/`-joined keys of the
`.npz` archives the JAX package writes.

`state_dict_from_jax` carries the JAX package's parameters into the port:
its result loads into the port's `UNet2D`, `ResNet18` (torchvision's names:
`layer2_0/downsample_0` -> `layer2.0.downsample.0`) and `InceptionV3`
(torchvision's names, whose numbered branches keep their `_<digit>`:
`Mixed_5b/branch5x5_1` -> `Mixed_5b.branch5x5_1`) with
`load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

_LEGACY_ATTN = {
    "query": "to_q",
    "key": "to_k",
    "value": "to_v",
    "proj_attn": "to_out_0",
}
# module names whose trailing _<digit> is part of the torch name, not an
# index: the UNet's time-embedding layers and Inception-v3's numbered
# branch convolutions (torchvision's `branch5x5_1`, ..., `branch7x7x3_4`)
_LITERAL_NAMES = {"linear_1", "linear_2"} | {
    f"{branch}_{i}" for branch, n in (("branch5x5", 2), ("branch3x3", 2),
                                      ("branch3x3dbl", 3), ("branch7x7", 3),
                                      ("branch7x7dbl", 5), ("branch7x7x3", 4))
    for i in range(1, n + 1)}
_LEAF_NAMES = {"embedding": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _flax_path(torch_key: str) -> Tuple[List[str], str]:
    """Split a torch key into (module path, leaf name) in Flax naming."""
    parts = torch_key.split(".")
    merged: List[str] = []
    for part in parts:
        if part.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{part}"
        else:
            merged.append(part)
    leaf = merged.pop()
    merged = [_LEGACY_ATTN.get(p, p) for p in merged]
    return merged, leaf


def _leaf_name_and_value(leaf: str, value: np.ndarray,
                         parent: str = "") -> Tuple[str, np.ndarray]:
    if leaf == "weight":
        # nn.Embedding tables ((N, dim) lookup, e.g. the conditional UNet's
        # `class_embedding.weight`) are row-indexed, not multiplied: flax
        # nn.Embed stores them untransposed under 'embedding'
        if parent.endswith("embedding") and value.ndim == 2:
            return "embedding", value
        if value.ndim == 4:
            return "kernel", np.transpose(value, (2, 3, 1, 0))  # OIHW -> HWIO
        if value.ndim == 2:
            return "kernel", np.transpose(value, (1, 0))
        return "scale", value  # norm affine
    if leaf == "bias":
        return "bias", value
    if leaf == "running_mean":
        return "mean", value
    if leaf == "running_var":
        return "var", value
    return leaf, value


def torch_to_flax(state: Mapping[str, Any],
                  strip_prefixes: Iterable[str] = ("module.", "model.")) -> Dict[str, Any]:
    """Flat torch state dict (tensors or arrays) -> nested Flax tree of
    numpy arrays. BatchNorm running statistics land next to scale/bias
    under the same module node; `num_batches_tracked` is dropped."""
    tree: Dict[str, Any] = {}
    for key, value in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        for prefix in strip_prefixes:
            if key.startswith(prefix):
                key = key[len(prefix):]
                break
        path, leaf = _flax_path(key)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        leaf, value = _leaf_name_and_value(leaf, np.asarray(value),
                                           parent=path[-1] if path else "")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def flax_to_torch(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested Flax tree -> flat torch state dict of numpy arrays (the
    inverse of `torch_to_flax`)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node: Mapping[str, Any], path: List[str]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + [name])
                continue
            value = np.asarray(value)
            parts: List[str] = []
            for p in path:
                head, _, tail = p.rpartition("_")
                if tail.isdigit() and head and p not in _LITERAL_NAMES:
                    parts.extend([head, tail])
                else:
                    parts.append(p)
            if name == "kernel":
                if value.ndim == 4:
                    value = np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
                elif value.ndim == 2:
                    value = np.transpose(value, (1, 0))
                leaf = "weight"
            else:
                leaf = _LEAF_NAMES.get(name, name)
            flat[".".join(parts + [leaf])] = value

    walk(tree, [])
    return flat


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested Flax parameter tree of numpy arrays -> flat torch state dict."""
    return {key: torch.tensor(value) for key, value in flax_to_torch(tree).items()}


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested tree -> {'a/b/leaf': array}, the `.npz` layout."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{'a/b/leaf': array} -> nested tree (the inverse of `flatten_tree`)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
