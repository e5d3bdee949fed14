"""Carry weights over from the JAX package's Flax parameter tree.

`state_dict_from_jax` is the inverse of the checkpoint conversion the JAX
package applies at load time: merged index segments expand
(`resnets_1` -> `resnets.1`), conv kernels go HWIO -> OIHW, Dense kernels
(I, O) -> (O, I), GroupNorm and BatchNorm `scale` -> `weight`, the frozen
BatchNorm statistics `mean`/`var` -> `running_mean`/`running_var`,
`nn.Embed` tables keep their layout. The result loads into the port's
`UNet2D`, `ResNet18` (torchvision's names: `layer2_0/downsample_0` ->
`layer2.0.downsample.0`) and `InceptionV3` (torchvision's names, whose
numbered branches keep their `_<digit>`: `Mixed_5b/branch5x5_1` ->
`Mixed_5b.branch5x5_1`) with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

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


def state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested Flax parameter tree of numpy arrays -> flat torch state dict."""
    flat: Dict[str, torch.Tensor] = {}

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
                    value = np.transpose(value, (3, 2, 0, 1))
                elif value.ndim == 2:
                    value = np.transpose(value, (1, 0))
                leaf = "weight"
            else:
                leaf = _LEAF_NAMES.get(name, name)
            flat[".".join(parts + [leaf])] = torch.tensor(value)

    walk(tree, [])
    return flat
