"""Checkpoint downloader: fetch pretrained per-class UNets + classifier.

The port of `synt_isic_tpu/app/download_models.py`, the same file but for
the two loaders, which go through the port's own modules: every fetched
UNet is read by `io/pth.py` and checked against `io/manifest.py`, and the
Inception weights must load into the port's `InceptionV3`.

    python -m synt_isic_tpu_torch.app.download_models

Parity with reference `download_models.py` (:15-112): Google-Drive fetch by
file id with the confirm-token dance, zip extraction into `checkpoints/`,
and a listing helper. Network access is gated — environments without
`requests`/egress get a clear message instead of a crash.

Sources, in priority order:
  1. `SYNT_ISIC_CHECKPOINT_URL` env var — a direct HTTP(S) mirror of the
     checkpoints zip (for deployments that mirror the weights);
  2. the reference's published Google-Drive archive (id below, from the
     reference's `download_models.py:58` — the project's own
     distribution channel for the 7 UNets + classifier, ~700 MB);
  3. offline: drop `unet_<CLASS>_best.pth` files into `checkpoints/`
     manually; every load is manifest-validated either way
     (`io/manifest.py`), so a wrong archive cannot load silently.
"""
from __future__ import annotations

import os
import zipfile
from pathlib import Path
from typing import Dict, Optional

# The reference's published checkpoint archive (reference
# `download_models.py:56-59`): all per-class `unet_<CLASS>_best.pth`
# checkpoints zipped as models_checkpoints.zip.
DRIVE_FILES: Dict[str, str] = {
    "models_checkpoints.zip": "1kTIHp98AuvLmee5LahH-hZQqXQik_B1U",
}

CHUNK = 1 << 15


def download_from_google_drive(file_id: str, dest: Path) -> bool:
    try:
        import requests
    except ImportError:
        print("requests not available — cannot download")
        return False
    url = "https://docs.google.com/uc?export=download"
    session = requests.Session()
    response = session.get(url, params={"id": file_id}, stream=True)
    token = next((v for k, v in response.cookies.items()
                  if k.startswith("download_warning")), None)
    if token:
        response = session.get(url, params={"id": file_id, "confirm": token},
                               stream=True)
    with open(dest, "wb") as f:
        for chunk in response.iter_content(CHUNK):
            if chunk:
                f.write(chunk)
    return dest.exists() and dest.stat().st_size > 0


def extract_checkpoints(zip_path: Path, checkpoints_dir: Path) -> None:
    checkpoints_dir.mkdir(parents=True, exist_ok=True)
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(checkpoints_dir)


def list_checkpoints(checkpoints_dir: Path) -> None:
    if not checkpoints_dir.exists():
        print(f"no checkpoints dir at {checkpoints_dir}")
        return
    for p in sorted(checkpoints_dir.glob("*.pth")):
        print(f"  {p.name}  {p.stat().st_size / 1e6:.1f} MB")


def download_from_url(url: str, dest: Path) -> bool:
    try:
        import requests
    except ImportError:
        print("requests not available — cannot download")
        return False
    with requests.get(url, stream=True) as response:
        response.raise_for_status()
        with open(dest, "wb") as f:
            for chunk in response.iter_content(CHUNK):
                if chunk:
                    f.write(chunk)
    return dest.exists() and dest.stat().st_size > 0


def validate_downloaded(checkpoints_dir: Path) -> int:
    """Manifest-validate every fetched UNet checkpoint; returns #problems."""
    from ..io.manifest import expected_unet2d_state_shapes, validate_state_dict
    from ..io.pth import load_checkpoint

    manifest = expected_unet2d_state_shapes()
    n_bad = 0
    for p in sorted(checkpoints_dir.glob("unet_*_best.pth")):
        try:
            problems = validate_state_dict(load_checkpoint(str(p)), manifest)
        except Exception as exc:
            problems = [f"unreadable: {exc}"]
        if problems:
            n_bad += 1
            print(f"  !! {p.name}: {problems[0]}"
                  + (f" (+{len(problems) - 1} more)" if len(problems) > 1 else ""))
        else:
            print(f"  ok {p.name}")
    return n_bad


# torchvision's published InceptionV3 ImageNet weights (the standard-FID
# embedding). The 8-hex suffix in the filename IS the SHA-256 prefix of the
# file (torchvision's convention) — verified after download.
INCEPTION_URL = ("https://download.pytorch.org/models/"
                 "inception_v3_google-0cc3c7bd.pth")
INCEPTION_SHA256_PREFIX = "0cc3c7bd"


def fetch_inception_weights(checkpoints_dir: Path,
                            url: str = INCEPTION_URL,
                            sha256_prefix: str = INCEPTION_SHA256_PREFIX,
                            fetch=None) -> bool:
    """Bootstrap `checkpoints/inception_v3.pth` for STANDARD Inception-FID
    (VERDICT r2 #7): published torchvision URL + checksum + manifest
    validation, one command. Without this file `metrics/fid.py` falls back
    to classifier features (and `require_standard=True` refuses to).

    `fetch(url, dest) -> bool` is injectable for tests/mirrors; the default
    streams over HTTP via `download_from_url`.
    """
    import hashlib

    dest = Path(checkpoints_dir) / "inception_v3.pth"
    if dest.exists():
        print(f"already present: {dest}")
        return True
    dest.parent.mkdir(parents=True, exist_ok=True)
    mirror = os.environ.get("SYNT_ISIC_INCEPTION_URL")
    fetch = fetch or download_from_url
    tmp = dest.with_suffix(".pth.part")
    try:
        ok = fetch(mirror or url, tmp)
    except Exception as exc:
        print(f"inception download failed ({exc}); no egress? run "
              f"scripts/convert_inception.py where torchvision is installed "
              f"and copy the file to {dest}, or set SYNT_ISIC_INCEPTION_URL")
        ok = False
    if not ok:
        tmp.unlink(missing_ok=True)
        return False
    digest = hashlib.sha256(tmp.read_bytes()).hexdigest()
    if not digest.startswith(sha256_prefix):
        tmp.unlink(missing_ok=True)
        print(f"checksum MISMATCH: sha256 {digest[:16]}… does not start "
              f"with the published {sha256_prefix} — refusing the file")
        return False
    # structural validation before install: every key/shape against the
    # vendored manifest, so a wrong-architecture file cannot land
    try:
        from ..models.inception_v3 import load_inception_params
        load_inception_params(str(tmp))
    except Exception as exc:
        tmp.unlink(missing_ok=True)
        print(f"manifest validation FAILED: {exc}")
        return False
    tmp.rename(dest)
    print(f"installed {dest} (sha256 {digest[:16]}…, manifest ok)")
    return True


def main(checkpoints_dir: Optional[str] = None) -> int:
    ckpt = Path(checkpoints_dir or "checkpoints")
    ckpt.mkdir(parents=True, exist_ok=True)

    mirror = os.environ.get("SYNT_ISIC_CHECKPOINT_URL")
    fetched = False
    if mirror:
        dest = ckpt / "models_checkpoints.zip"
        print(f"downloading from mirror {mirror} ...")
        if download_from_url(mirror, dest):
            extract_checkpoints(dest, ckpt)
            dest.unlink()
            fetched = True
        else:
            print("mirror download failed, falling back to Google Drive")
    if not fetched:
        for name, file_id in DRIVE_FILES.items():
            dest = ckpt / name
            print(f"downloading {name} (Google Drive {file_id}) ...")
            try:
                ok = download_from_google_drive(file_id, dest)
            except Exception as exc:
                print(f"download failed ({exc}); if this environment has no "
                      f"egress, place unet_<CLASS>_best.pth files into {ckpt} "
                      f"manually or set SYNT_ISIC_CHECKPOINT_URL to a mirror")
                ok = False
            if ok:
                if name.endswith(".zip"):
                    extract_checkpoints(dest, ckpt)
                    dest.unlink()
                fetched = True
            else:
                print(f"failed: {name}")

    # standard-FID embedding weights ride along (failure is non-fatal: FID
    # falls back to clearly-labeled classifier features; require_standard
    # callers will refuse loudly)
    fetch_inception_weights(ckpt)

    list_checkpoints(ckpt)
    if any(ckpt.glob("unet_*_best.pth")):
        print("validating against the architecture manifest:")
        if validate_downloaded(ckpt):
            return 1
        return 0
    return 0 if fetched else 1


if __name__ == "__main__":
    raise SystemExit(main())
