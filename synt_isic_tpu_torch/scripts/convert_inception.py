"""Produce `checkpoints/inception_v3.pth` for standard Inception FID.

The port of `scripts/convert_inception.py`. Run it where torchvision is
installed and its ImageNet weights can be fetched, then copy the file into
`checkpoints/`: `metrics/fid.py` then picks it up and computes pool3 FID in
place of the classifier-feature fallback.

    python -m synt_isic_tpu_torch.scripts.convert_inception [--out checkpoints/inception_v3.pth]

The file is torchvision's `inception_v3` state dict. It is read back with
`models/inception_v3.load_inception_params`, which checks every key and
shape against the port's manifest, so a wrong file fails here and never
loads silently. Exits 1 without torchvision or when that check fails.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import torch

from ..models.inception_v3 import load_inception_params


def main(argv: Optional[List[str]] = None, model_config=None) -> int:
    """`model_config` is unused (the network is torchvision's); it is taken
    so that every script of the port has the same signature."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="checkpoints/inception_v3.pth")
    args = ap.parse_args(argv)

    try:
        import torchvision
    except ImportError as exc:
        print(f"needs torch + torchvision ({exc}); run where they are "
              f"installed and copy the output here")
        return 1

    model = torchvision.models.inception_v3(
        weights=torchvision.models.Inception_V3_Weights.IMAGENET1K_V1)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(model.state_dict(), out)
    print(f"wrote {out} ({out.stat().st_size / 1e6:.1f} MB)")

    try:
        load_inception_params(str(out))
    except (ValueError, RuntimeError) as exc:
        print(f"manifest validation FAILED: {exc}")
        return 1
    print("manifest validation: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
