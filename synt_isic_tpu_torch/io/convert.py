"""Carry weights over from the JAX package's Flax parameter tree.

`state_dict_from_jax` is the inverse of the checkpoint conversion the JAX
package applies at load time: merged index segments expand
(`resnets_1` -> `resnets.1`), conv kernels go HWIO -> OIHW, Dense kernels
(I, O) -> (O, I), GroupNorm and BatchNorm `scale` -> `weight`, the frozen
BatchNorm statistics `mean`/`var` -> `running_mean`/`running_var`,
`nn.Embed` tables keep their layout. The result loads into the port's
`UNet2D` and `ResNet18` (torchvision's names: `layer2_0/downsample_0` ->
`layer2.0.downsample.0`) with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping

import numpy as np
import torch

# module names whose trailing _<digit> is part of the torch name, not an index
_LITERAL_NAMES = {"linear_1", "linear_2"}
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
