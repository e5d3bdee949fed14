"""The port's per-class family scripts (`synt_isic_tpu_torch/scripts/`
`train_family`, `score_family`, `rescore_family_consistency`) at 32²,
quarter width, on the CPU:

  * `train_family` trains, skips a finished class (byte for byte) and
    backfills its colour statistics; it treats a class whose resume
    snapshot remains (the port's trainer names it `train_state_<C>.pt`,
    `train_ddpm.resume_snapshot_path`) as interrupted and trains it again,
    continues it with `--resume`, and deletes the snapshot after a clean
    finish, as the JAX script does with its own snapshot name
    (`scripts/train_family.py:81-90, 132-134`);
  * `score_family` refuses an incomplete family, and trains its probe over
    every class on disk when it scores a subset
    (`tests/test_score_family.py:76-95`);
  * `rescore_family_consistency --skip-probe` on the subset run's saved
    PNGs, per-class report and `classifier.pth`, beside the JAX script run
    in process on the same files: equal `class_consistency`,
    `probe_heldout_acc` and verdicts; and the port's run reproduces
    `score_family`'s own consistency and probe accuracy;
  * `train_family` also through `python -m`.

The classifiers take 64² inputs in both packages (`small_classifiers`),
and the JAX classifier's random init, which `from_checkpoint` overwrites
whole, is built from numpy (`jax_resnet_params`) instead of a 224² trace.
Every port run passes `device="cpu"`.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import synt_isic_tpu.utils.compute as jax_compute
from synt_isic_tpu.models.classifier import LesionClassifier as JaxLesionClassifier
from synt_isic_tpu_torch.models.classifier import LesionClassifier
from synt_isic_tpu_torch.scripts import rescore_family_consistency, score_family, train_family
from synt_isic_tpu_torch.train.procedural import ProceduralDataset
from synt_isic_tpu_torch.train.train_ddpm import resume_snapshot_path, train_class

from tests.torch_port_fixtures import jax_resnet_params, one_thread, small_classifiers  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import rescore_family_consistency as jax_rescore  # noqa: E402

SIZE, IMAGES, EPOCHS, BATCH = 32, 8, 2, 4
KW = dict(size=SIZE, train_images=IMAGES, epochs=EPOCHS, batch_size=BATCH, width="quarter",
          seed=0, device="cpu")
STEPS_PER_EPOCH = IMAGES // BATCH


class Log(list):
    def __call__(self, *args, **kwargs):
        self.append(" ".join(str(a) for a in args))


@pytest.fixture(scope="module")
def family(tmp_path_factory):
    """MEL and NV trained by `train_family` (2 epochs of 2 steps each)."""
    out = tmp_path_factory.mktemp("family")
    report = train_family.train_family(str(out), ["MEL", "NV"], log=Log(), **KW)
    return out, report


@pytest.fixture(scope="module")
def scored(family, tmp_path_factory):
    """`score_family` on MEL alone: the probe still trains over MEL and NV."""
    ckpt = family[0] / "checkpoints"
    work = tmp_path_factory.mktemp("scored")
    with small_classifiers():
        report = score_family.score_family(
            str(ckpt), str(work / "family_score_MEL.json"), classes=["MEL"], size=SIZE,
            width="quarter", count=4, heldout=8, steps=4, clf_per_class=8, clf_epochs=2,
            hard=0.6, work_dir=str(work / "samples"), log=Log(), device="cpu")
    return ckpt, work, report


def test_family_trains_then_skips_and_backfills_colour_statistics(family):
    out, report = family
    ckpt = out / "checkpoints"
    assert report["family_complete"]
    for cls in ("MEL", "NV"):
        entry = report["classes"][cls]
        assert entry["steps"] == EPOCHS * STEPS_PER_EPOCH and np.isfinite(entry["best_loss"])
        # a clean finish leaves no resume snapshot behind
        assert not resume_snapshot_path(ckpt, cls).exists()
    assert json.loads((out / "family_train.json").read_text()) == report
    stats_path = ckpt / "color_statistics.json"
    stats = json.loads(stats_path.read_text())
    saved = stats.pop("NV")
    stats_path.write_text(json.dumps(stats))
    before = {c: (ckpt / f"unet_{c}_best.pth").read_bytes() for c in ("MEL", "NV")}
    log = Log()
    again = train_family.train_family(str(out), ["MEL", "NV"], log=log, **KW)
    assert sum("skipping train" in line for line in log) == 2
    assert again["classes"]["MEL"]["best_loss"] == report["classes"]["MEL"]["best_loss"]
    assert {c: (ckpt / f"unet_{c}_best.pth").read_bytes() for c in ("MEL", "NV")} == before
    assert json.loads(stats_path.read_text())["NV"] == saved


def test_a_remaining_snapshot_marks_the_class_interrupted(tmp_path):
    out = tmp_path / "fam"
    train_family.train_family(str(out), ["MEL"], log=Log(), **KW)
    ckpt = out / "checkpoints"
    snapshot = ckpt / "train_state_MEL.pt"
    assert snapshot == resume_snapshot_path(ckpt, "MEL") and not snapshot.exists()
    # what the trainer leaves behind a run that was stopped (resume=False
    # ignores its contents)
    snapshot.write_bytes(b"not a real snapshot")
    log = Log()
    report = train_family.train_family(str(out), ["MEL"], log=log, **KW)
    assert not any("skipping train" in line for line in log)
    assert "skipped_existing" not in report["classes"]["MEL"]
    assert report["classes"]["MEL"]["steps"] == EPOCHS * STEPS_PER_EPOCH
    assert not snapshot.exists()


def test_resume_continues_an_interrupted_class(tmp_path):
    out = tmp_path / "fam"
    ckpt = out / "checkpoints"
    # a class stopped after its first epoch: the best file and the snapshot
    first = train_class("MEL", ProceduralDataset("MEL", IMAGES, SIZE, seed=0), str(ckpt),
                        train_family.family_train_config(SIZE, IMAGES, 1, BATCH, 0),
                        model=train_family.family_model(SIZE, "quarter", 0, fused=False),
                        log=Log(), device="cpu")
    assert first["steps"] == STEPS_PER_EPOCH and resume_snapshot_path(ckpt, "MEL").exists()
    log = Log()
    report = train_family.train_family(str(out), ["MEL"], resume=True, log=log, **KW)
    assert any("resumed from" in line and "continuing at epoch 2/2" in line for line in log)
    assert report["classes"]["MEL"]["steps"] == EPOCHS * STEPS_PER_EPOCH
    assert not resume_snapshot_path(ckpt, "MEL").exists()


def test_train_family_through_python_m(tmp_path):
    run = subprocess.run([sys.executable, "-m", "synt_isic_tpu_torch.scripts.train_family",
                          "--out", str(tmp_path / "fam"), "--classes", "MEL", "--size", "32",
                          "--train-images", "8", "--epochs", "1", "--batch", "4", "--width",
                          "quarter", "--device", "cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    report = json.loads((tmp_path / "fam" / "family_train.json").read_text())
    assert report["family_complete"] and report["classes"]["MEL"]["steps"] == 2


def test_score_family_refuses_an_incomplete_family(family, tmp_path):
    with pytest.raises(FileNotFoundError, match=r"family incomplete: .*\['BCC'\]"):
        score_family.score_family(str(family[0] / "checkpoints"), str(tmp_path / "s.json"),
                                  classes=["MEL", "BCC"], size=SIZE, width="quarter",
                                  log=Log(), device="cpu")


def test_probe_trains_on_every_class_on_disk_when_scoring_a_subset(scored):
    ckpt, work, report = scored
    assert set(report["probe"]["heldout_acc"]) == {"MEL", "NV"}
    assert set(report["per_class"]) == {"MEL"}
    row = report["per_class"]["MEL"]
    # score_family.py:183-202
    assert set(row) == {"frechet_vs_heldout", "floor_train_vs_heldout",
                        "ceiling_noise_vs_heldout", "quality_bar", "model_converged",
                        "class_consistency", "consistency_absolute_ok",
                        "consistency_vs_judge_skill", "probe_heldout_acc", "img_per_s", "seconds"}
    assert row["ceiling_noise_vs_heldout"] > row["floor_train_vs_heldout"]
    assert (ckpt / "classifier.pth").exists()
    assert len(list((work / "samples" / "MEL" / "MEL").glob("ISIC_*.png"))) == 4


def test_rescore_matches_jax_and_score_family(scored, monkeypatch, capsys):
    ckpt, work, report = scored
    args = ["--checkpoints", str(ckpt), "--samples", str(work / "samples"),
            "--reports", str(work / "family_score_{C}.json"), "--classes", "MEL",
            "--clf-hard", "0.6", "--skip-probe"]
    # the JAX script's cache switch would write outside the checkout; its
    # classifier's random init is overwritten whole by the file
    monkeypatch.setattr(jax_compute, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(JaxLesionClassifier, "random_init", classmethod(
        lambda cls, num_classes=7, seed=0, **kw: cls(jax_resnet_params(num_classes, seed),
                                                     num_classes=num_classes)))
    monkeypatch.setattr(sys, "argv", ["rescore_family_consistency.py", *args, "--cpu",
                                      "--out", str(work / "jax.json")])
    with small_classifiers():
        assert LesionClassifier.from_checkpoint(str(ckpt / "classifier.pth"),
                                                device="cpu")[1]["skipped"] == 0
        assert jax_rescore.main() == 0
        assert rescore_family_consistency.main(
            [*args, "--device", "cpu", "--out", str(work / "port.json")]) == 0
    capsys.readouterr()
    jax_report = json.loads((work / "jax.json").read_text())
    port_report = json.loads((work / "port.json").read_text())
    assert set(port_report) == set(jax_report)
    for key in ("family_converged", "family_consistent_absolute", "probe_competent"):
        assert port_report[key] == jax_report[key], key
    assert port_report["probe"]["heldout_acc"] == jax_report["probe"]["heldout_acc"]
    port_row, jax_row = port_report["per_class"]["MEL"], jax_report["per_class"]["MEL"]
    assert port_row == jax_row
    # the saved samples and the probe's own held-out set give back what
    # score_family measured
    for key in ("class_consistency", "probe_heldout_acc", "consistency_absolute_ok",
                "consistency_vs_judge_skill", "frechet_vs_heldout"):
        assert port_row[key] == report["per_class"]["MEL"][key], key
