"""The port's conditional-family loop (`synt_isic_tpu_torch/scripts/
e2e_conditional.py`) at a tiny size on the CPU: train one conditional
model on the mixed MEL/NV/VASC procedural stream, train the independent
classifier judge, sample every class through the conditional
`ImageGenerator` at guidance 1 and 2, and write the JAX script's report
(`scripts/e2e_conditional.py`, whose own run is marked slow in
`tests/test_e2e_conditional.py`), key for key; `--skip-train` refusing
without a checkpoint, in process and through `python -m`; and `--resume`
(as `tests/test_e2e_conditional.py:45-62`), which in the port continues at
the epoch after the snapshot's, `--epochs` being the run's total, and
trains no epoch from a snapshot that has them all.

The judge takes 64² inputs (`small_classifiers`). Every run passes
`device="cpu"`.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from synt_isic_tpu_torch.scripts import e2e_conditional

from tests.torch_port_fixtures import one_thread, small_classifiers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# e2e_conditional.py:65-68, 86, 104-109, 143-145, 165, 212, 228-229, 234,
# 245, 249 (the report)
COND_KEYS = {"classes", "size", "width", "clf_hard", "epochs", "train_images_per_class",
             "guidance_scales", "train_fused", "train", "classifier", "anchors", "results",
             "best_guidance", "conditional_ok", "per_class_best_guidance",
             "consistent_absolute_all", "probe_competent_all"}
# :104-109 (a training run), :190-200 and :203-207 (a guidance scale)
TRAIN_KEYS = {"best_loss", "steps", "best_val", "first_epoch_loss", "last_epoch_loss",
              "seconds"}
RESULT_KEYS = {"per_class", "img_per_s", "unet_evals_per_step"}
PER_CLASS_KEYS = {"frechet_vs_heldout", "class_consistency", "consistency_vs_judge_skill",
                  "consistency_absolute_ok"}
TINY = dict(size=16, train_images=8, heldout=8, batch_size=6, sample_count=4, ddim_steps=2,
            clf_per_class=8, clf_epochs=1, seed=0, device="cpu")


class Log(list):
    def __call__(self, *args, **kwargs):
        self.append(" ".join(str(a) for a in args))


def test_tiny_loop_writes_the_jax_report(tmp_path, capsys):
    with small_classifiers():
        report = e2e_conditional.run(str(tmp_path), epochs=2, guidance_scales=(1.0, 2.0),
                                     log=Log(), **TINY)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["best_guidance"] == report["best_guidance"]
    on_disk = json.loads((tmp_path / "report.json").read_text())
    assert on_disk == json.loads(json.dumps(report))
    assert set(report) == COND_KEYS
    assert report["classes"] == ["MEL", "NV", "VASC"]
    assert set(report["train"]) == TRAIN_KEYS
    assert report["train"]["steps"] == 2 * (3 * 8 // 6)        # 2 epochs of 4 batches
    assert not report["train_fused"]                            # no kernel on the CPU
    assert set(report["results"]) == {"g1", "g2"}
    for g, res in report["results"].items():
        assert set(res) == RESULT_KEYS
        assert res["unet_evals_per_step"] == (2 if g == "g2" else 1)
        for c, m in res["per_class"].items():
            assert set(m) == PER_CLASS_KEYS
            assert np.isfinite(m["frechet_vs_heldout"]) and 0.0 <= m["class_consistency"] <= 1.0
    assert set(report["per_class_best_guidance"]) == {"MEL", "NV", "VASC"}
    meta = json.loads((tmp_path / "checkpoints" / "unet_conditional_best.json").read_text())
    assert meta["classes"] == ["MEL", "NV", "VASC"] and meta["num_class_embeds"] == 4
    assert (tmp_path / "samples_g2" / "VASC" / "ISIC_0000004.png").exists()
    sidecar = json.loads((tmp_path / "samples_g2" / "MEL" / "ISIC_0000001.json").read_text())
    assert sidecar["scheduler"]["dtype"] == "bfloat16"


def test_skip_train_refuses_without_a_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError, match="--skip-train: no checkpoint"):
        e2e_conditional.run(str(tmp_path / "a"), epochs=1, skip_train=True, log=Log(), **TINY)
    run = subprocess.run([sys.executable, "-m", "synt_isic_tpu_torch.scripts.e2e_conditional",
                          "--out", str(tmp_path / "b"), "--size", "16", "--skip-train",
                          "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode != 0 and "--skip-train: no checkpoint" in run.stderr


def test_resume_continues_from_the_snapshot(tmp_path):
    kw = dict(TINY, guidance_scales=(1.0,), classes=("MEL", "NV"), sample_count=2)
    with small_classifiers():
        first = e2e_conditional.run(str(tmp_path), epochs=1, log=Log(), **kw)
        assert (tmp_path / "checkpoints" / "train_state_conditional.pt").exists()
        log = Log()
        resumed = e2e_conditional.run(str(tmp_path), epochs=2, resume=True, log=log, **kw)
        # the snapshot now has every epoch done: no epoch runs, no epoch loss
        done = e2e_conditional.run(str(tmp_path), epochs=2, resume=True, log=Log(), **kw)
    assert any("resumed from" in line and "continuing at epoch 2/2" in line for line in log)
    steps_per_epoch = 2 * 8 // 6
    assert first["train"]["steps"] == steps_per_epoch
    assert resumed["train"]["steps"] == 2 * steps_per_epoch
    assert done["train"]["steps"] == 2 * steps_per_epoch
    assert done["train"]["first_epoch_loss"] is None is done["train"]["last_epoch_loss"]
