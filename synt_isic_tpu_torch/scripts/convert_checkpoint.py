"""Checkpoint conversion: torch `.pth` <-> the JAX package's Flax `.npz`.

The port of `scripts/convert_checkpoint.py`, with its three modes. An
`.npz` it writes is the one the JAX script writes (the Flax tree under
`/`-joined keys, the same arrays), so the JAX package loads it as its own;
`to-pth` writes the diffusers-keyed state dict every loader of both
packages reads. Reads and writes `.pth` files through `io/pth.py`. Host
only: no tensor reaches a device.

    python -m synt_isic_tpu_torch.scripts.convert_checkpoint to-npz checkpoints/unet_NV_best.pth
    python -m synt_isic_tpu_torch.scripts.convert_checkpoint to-pth unet_NV_best.npz out.pth
    python -m synt_isic_tpu_torch.scripts.convert_checkpoint inspect checkpoints/unet_NV_best.pth
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..io.convert import flatten_tree, flax_to_torch, torch_to_flax, unflatten_tree
from ..io.pth import load_checkpoint, save_checkpoint


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` is unused (no model is built); it is taken so that
    every script of the port has the same signature."""
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["to-npz", "to-pth", "inspect"])
    p.add_argument("src")
    p.add_argument("dst", nargs="?")
    args = p.parse_args(argv)
    src = Path(args.src)

    if args.mode == "inspect":
        state = load_checkpoint(str(src))
        total = 0
        for key, tensor in state.items():
            dtype = str(tensor.dtype).removeprefix("torch.")
            print(f"  {key:60s} {str(tuple(tensor.shape)):>20s} {dtype}")
            total += tensor.numel()
        print(f"{len(state)} tensors, {total / 1e6:.2f} M parameters")
        return 0

    if args.mode == "to-npz":
        dst = Path(args.dst) if args.dst else src.with_suffix(".npz")
        tree = torch_to_flax(load_checkpoint(str(src)))
        np.savez(dst, **flatten_tree(tree))
        print(f"wrote {dst}")
        return 0

    dst = Path(args.dst) if args.dst else src.with_suffix(".pth")
    with np.load(src) as data:
        tree = unflatten_tree({k: data[k] for k in data.files})
    save_checkpoint({k: torch.from_numpy(np.ascontiguousarray(v))
                     for k, v in flax_to_torch(tree).items()}, str(dst))
    print(f"wrote {dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
