"""The port's `e2e_loop` entry point (`synt_isic_tpu_torch/scripts/
e2e_loop.py`) at a tiny size on the CPU: `--skip-train` refusing without a
checkpoint (also through `python -m`), and the whole loop (train, DDIM and
DPM-Solver++ sampling, the integrated XAI, the pixel and classifier
Fréchet batteries) with the report keys of the JAX script
(`scripts/e2e_loop.py`, whose own run is marked slow in
`tests/test_e2e_loop.py`), without the classifier training, which at 224²
is too heavy for the CPU (the card runs it: `chip_smoke.py --eval`).
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from synt_isic_tpu_torch.scripts import e2e_loop

from tests.torch_port_fixtures import one_thread, small_classifiers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# the report keys `scripts/e2e_loop.py` writes (:108-109, 186-191, 311-315,
# 346, 392-420, 439), without the trained classifier's block
E2E_KEYS = {"class", "size", "width", "train_images", "epochs", "train_fused", "train",
            "timestep_spacing", "fast_scheduler", "sample_ddim", "sample_dpm", "xai",
            "fid_pixel", "fid_proxy", "fid_extractor", "quality_bar", "model_converged",
            "sampler_within_bar", "converged", "preview"}
E2E_PAIRS = {"train_vs_heldout_floor", "train_smalln_vs_heldout_floor",
             "noise_vs_heldout_ceiling", "ddim_vs_heldout", "dpm_vs_heldout", "ddim_vs_dpm",
             "ddim_post_vs_heldout", "dpm_post_vs_heldout"}


def test_skip_train_refuses_without_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="skip-train"):
        e2e_loop.run_loop(str(tmp_path / "loop"), class_name="MEL", size=32, train_images=4,
                          heldout=4, epochs=1, skip_train=True, with_classifier=False,
                          log=lambda *_: None, device="cpu")
    out = subprocess.run([sys.executable, "-m", "synt_isic_tpu_torch.scripts.e2e_loop",
                          "--out", str(tmp_path / "loop2"), "--size", "32", "--skip-train",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode != 0 and "--skip-train: no checkpoint" in out.stderr


def test_full_loop_closes(tmp_path):
    with small_classifiers():
        report = e2e_loop.run_loop(str(tmp_path / "loop"), class_name="MEL", size=32,
                                   train_images=16, heldout=16, epochs=2, batch_size=8,
                                   sample_count=4, ddim_steps=4, dpm_steps=2, xai_ig=4,
                                   xai_shap=8, with_gradcam=False, with_classifier=False,
                                   seed=0, log=lambda *_: None, device="cpu")
    assert set(report) == E2E_KEYS
    assert report["train"]["steps"] == 4            # 2 epochs x 2 batches
    assert np.isfinite(report["train"]["best_loss"])
    assert not report["train_fused"]                # no kernel on the CPU
    assert report["sample_ddim"]["count"] == report["sample_dpm"]["count"] == 4
    assert report["xai"]["artifacts"] > 0
    for battery in ("fid_pixel", "fid_proxy"):
        assert set(report[battery]) == E2E_PAIRS
        assert all(np.isfinite(v) for v in report[battery].values()), battery
    assert set(report["sampler_within_bar"]) == {"ddim4", "dpm2"}
    assert report["converged"] == all(report["sampler_within_bar"].values())
    loop = tmp_path / "loop"
    assert (loop / "checkpoints" / "color_statistics.json").exists()
    assert json.loads((loop / "report.json").read_text())["fid_pixel"] == report["fid_pixel"]
    sidecar = json.loads(next((loop / "samples_dpm2" / "MEL").glob("*.json")).read_text())
    assert sidecar["scheduler"]["kind"] == "dpm_solver"
    assert sidecar["scheduler"]["dtype"] == "bfloat16"


def test_resume_with_every_epoch_done_trains_none(tmp_path, monkeypatch):
    """`--resume` from a snapshot of a finished run: the trainer runs no epoch
    (the port's `--epochs` is the run's total), and the report says so with
    no epoch loss instead of failing on an empty history. The loop is
    stopped where sampling starts."""
    from synt_isic_tpu_torch import generator

    class Sampling(Exception):
        pass

    def stop(*args, **kwargs):
        raise Sampling

    monkeypatch.setattr(generator, "ImageGenerator", stop)
    logs = []
    kw = dict(class_name="MEL", size=32, train_images=16, heldout=4, epochs=1, batch_size=8,
              with_classifier=False, seed=0, device="cpu")
    for resume in (False, True):
        with pytest.raises(Sampling):
            e2e_loop.run_loop(str(tmp_path / "loop"), resume=resume,
                              log=lambda *a: logs.append(" ".join(map(str, a))), **kw)
    assert any("all epochs already done" in line for line in logs)
    assert any("trained 2 steps" in line and "loss None -> None" in line for line in logs)
