"""The port's quality ladders (`synt_isic_tpu_torch/scripts/`
`ladder_common`, `score_checkpoint`, `sampler_ladder`, `distill_ladder`,
`augment_eval`) at tiny sizes on the CPU, against the JAX package's scripts
of the same names (`scripts/`):

  * the host parts held to the JAX functions themselves: `warm_images`
    over a grid of (count, batch), `make_stats_fn(PixelFeatureExtractor())`
    on the same images, `parse_configs` with its error; and the floor and
    ceiling anchors each script reports, against the same anchors built from
    the JAX package's `procedural_images`, `PixelFeatureExtractor` and
    `frechet_distance` within 1e-9 relative (both sides are the same numpy
    and scipy arithmetic on the same numpy inputs);
  * each script run end to end at 32² on a random quarter-width
    checkpoint: `score_checkpoint --ab-fast-math` (its rows, the Fréchet
    delta, `attention_fast_math` in the fast rows' sidecars only, and a
    byte-identical `--reproduce` of a fast sidecar), `sampler_ladder` over
    all five schedulers with its headline, `distill_ladder` 8 -> 4, and
    `augment_eval` with its border preserved; `sampler_ladder` also through
    `python -m`;
  * report keys equal to the JAX scripts', written out below with the JAX
    lines that set them (the JAX scripts' own runs compile every sampler and
    are marked slow in `tests/test_score_checkpoint.py`,
    `test_distill_ladder.py` and `test_augment_eval.py`).

Every run passes `device="cpu"`; without it each entry point takes CUDA and
raises where there is none.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from synt_isic_tpu.metrics.fid import PixelFeatureExtractor as JaxPixelFeatureExtractor
from synt_isic_tpu.metrics.fid import frechet_distance as jax_frechet_distance
from synt_isic_tpu.train.procedural import procedural_images as jax_procedural_images
from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.io.pth import save_checkpoint
from synt_isic_tpu_torch.metrics.fid import PixelFeatureExtractor
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.scripts import (augment_eval, distill_ladder, ladder_common,
                                         sampler_ladder, score_checkpoint)
from synt_isic_tpu_torch.scripts.e2e_loop import small_unet_config

from tests.torch_port_fixtures import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import ladder_common as jax_ladder_common  # noqa: E402
import score_checkpoint as jax_score_checkpoint  # noqa: E402

SIZE, COUNT, HELDOUT = 32, 4, 16
REL = 1e-9
QUIET = dict(log=lambda *a, **k: None, device="cpu")

# sampler_ladder.py:95-105, 138-139 (report), 126-130 (a rung)
LADDER_KEYS = {"class", "size", "count", "checkpoints", "floor_train_vs_heldout",
               "floor_train_n_vs_heldout", "ceiling_noise_vs_heldout", "rungs", "headline",
               "headline_rule"}
RUNG_KEYS = {"scheduler", "steps", "timestep_spacing", "frechet_vs_heldout", "img_per_s",
             "wall_s"}
# score_checkpoint.py:75-84 (report); ladder_common.py:79-81 plus
# score_checkpoint.py:104-105, 113 (a row)
SCORE_KEYS = {"checkpoints", "class", "size", "count", "variant", "floor_train_vs_heldout",
              "ceiling_noise_vs_heldout", "rows"}
ROW_KEYS = {"tag", "frechet_vs_heldout", "img_per_s", "wall_s", "scheduler", "steps",
            "spacing", "fast_math"}
# distill_ladder.py:118-134 (report); ladder_common.py:79-81 plus
# distill_ladder.py:115, 152 (a rung)
DISTILL_KEYS = {"class", "size", "count", "teacher", "timestep_spacing", "steps_per_phase",
                "distill_wall_s", "floor_train_vs_heldout", "floor_train_n_vs_heldout",
                "ceiling_noise_vs_heldout", "rungs"}
DISTILL_RUNG_KEYS = {"tag", "frechet_vs_heldout", "img_per_s", "wall_s", "steps"}
# augment_eval.py:83-89, 109, 123-127, 140-144
AUGMENT_KEYS = {"class", "size", "count", "steps", "timestep_spacing", "anchors",
                "strength_sweep", "plain_generation_frechet", "diversity",
                "inpaint_center_box"}


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-300)


def _jax_stats():
    return jax_ladder_common.make_stats_fn(JaxPixelFeatureExtractor())


def _jax_ladder_anchors(seed: int, count: int):
    """The sampler and distillation ladders' anchors (sampler_ladder.py:84-104),
    from the JAX package."""
    stats = _jax_stats()
    held = jax_procedural_images("MEL", HELDOUT, SIZE, seed=0, start_index=10_000_000)
    train_like = jax_procedural_images("MEL", min(HELDOUT, 128), SIZE, seed=0, start_index=0)
    noise = np.random.default_rng(seed).uniform(-1, 1, held.shape).astype(np.float32)
    s_held = stats(held)
    return {"floor_train_vs_heldout": jax_frechet_distance(*stats(train_like), *s_held),
            "floor_train_n_vs_heldout": jax_frechet_distance(*stats(train_like[:count]),
                                                             *s_held),
            "ceiling_noise_vs_heldout": jax_frechet_distance(*stats(noise), *s_held)}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A random quarter-width 32² MEL checkpoint (`small_unet_config(32)`,
    the config the scripts build at --size 32)."""
    d = tmp_path_factory.mktemp("ckpt")
    torch.manual_seed(0)
    save_checkpoint(UNet2D(small_unet_config(SIZE)).state_dict(), str(d / "unet_MEL_best.pth"))
    return d


@pytest.fixture(scope="module")
def scored(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("score") / "report.json"
    report = score_checkpoint.score_checkpoint(
        str(ckpt), str(out), score_checkpoint.parse_configs("ddim:4:trailing"),
        size=SIZE, count=2, heldout=HELDOUT, seed=0, batch=2, ab_fast_math=True, **QUIET)
    return report, out


@pytest.fixture(scope="module")
def ladder(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("ladder") / "ladder.json"
    grid = (("ddim", 3), ("dpm_solver", 3, "trailing"), ("unipc", 3, "trailing"),
            ("dpm_solver_sde", 3, "trailing"), ("ddpm", 3))
    report = sampler_ladder.run_ladder(str(ckpt), str(out), size=SIZE, count=COUNT,
                                       heldout=HELDOUT, seed=3, grid=grid, **QUIET)
    return report, out


@pytest.fixture(scope="module")
def augmented(ckpt, tmp_path_factory):
    out = tmp_path_factory.mktemp("augment") / "report.json"
    report = augment_eval.run_eval(str(ckpt), str(out), size=SIZE, count=COUNT,
                                   heldout=HELDOUT, steps=2, diversity_seeds=3,
                                   strengths=(0.5, 1.0), **QUIET)
    return report, out


# -- the host parts against the JAX functions --------------------------------------------

def test_warm_images_matches_jax():
    for total in range(1, 70):
        for batch in (1, 2, 3, 8, 16, 64):
            assert (ladder_common.warm_images(total, batch)
                    == jax_ladder_common.warm_images(total, batch)), (total, batch)
    assert ladder_common.WARM_SEED_OFFSET == jax_ladder_common.WARM_SEED_OFFSET


def test_stats_fn_matches_jax():
    imgs = np.random.default_rng(0).uniform(-1, 1, (12, 20, 20, 3)).astype(np.float32)
    mean, cov = ladder_common.make_stats_fn(PixelFeatureExtractor())(imgs)
    jmean, jcov = _jax_stats()(imgs)
    np.testing.assert_allclose(mean, jmean, rtol=REL, atol=0)
    np.testing.assert_allclose(cov, jcov, rtol=REL, atol=1e-15)


def test_parse_configs_matches_jax():
    for spec in ("ddim:50:trailing,dpm_solver:20", "unipc:8:trailing",
                 " ddpm:250 , dpm_solver_sde:20:trailing"):
        assert (score_checkpoint.parse_configs(spec)
                == jax_score_checkpoint.parse_configs(spec))
    assert sampler_ladder.parse_grid("ddim:50:trailing,unipc:8") == [
        ("ddim", 50, "trailing"), ("unipc", 8)]
    for bad in ("ddim", "ddim:50,unipc"):
        with pytest.raises(ValueError, match="scheduler:steps"):
            score_checkpoint.parse_configs(bad)
        with pytest.raises(ValueError, match="scheduler:steps"):
            jax_score_checkpoint.parse_configs(bad)


def test_anchors_match_jax(scored, ladder, augmented):
    want = _jax_ladder_anchors(seed=3, count=COUNT)
    report = ladder[0]
    for key, value in want.items():
        assert _close(report[key], value), (key, report[key], value)
    # score_checkpoint.py:69-82: the same sets at its own seed, rounded
    want = _jax_ladder_anchors(seed=0, count=2)
    report = scored[0]
    for key in ("floor_train_vs_heldout", "ceiling_noise_vs_heldout"):
        assert _close(report[key], round(float(want[key]), 3)), key
    # augment_eval.py:69-77: a split of its own held-out set, normal noise
    stats = _jax_stats()
    held = jax_procedural_images("MEL", HELDOUT, SIZE, start_index=10_000)
    half = HELDOUT // 2
    floor = jax_frechet_distance(*stats(held[:half]), *stats(held[half:]))
    noise = np.clip(np.random.default_rng(1).normal(0, 1, held.shape), -1, 1)
    ceiling = jax_frechet_distance(*stats(noise), *stats(held))
    assert augmented[0]["anchors"] == {"heldout_split_floor": round(float(floor), 3),
                                       "noise_ceiling": round(float(ceiling), 3)}


# -- the entry points end to end ---------------------------------------------------------

def test_score_checkpoint_ab_fast_math(scored, ckpt, tmp_path):
    report, out = scored
    assert set(report) == SCORE_KEYS
    rows = report["rows"]
    assert [r["fast_math"] for r in rows] == [False, True]
    assert [r["tag"] for r in rows] == ["ddim4_trailing", "ddim4_trailing_fastmath"]
    for r in rows:
        assert set(r) - {"frechet_delta_vs_exact"} == ROW_KEYS
        assert np.isfinite(r["frechet_vs_heldout"]) and r["img_per_s"] > 0
    assert rows[1]["frechet_delta_vs_exact"] == round(
        rows[1]["frechet_vs_heldout"] - rows[0]["frechet_vs_heldout"], 3)
    assert json.loads(out.read_text()) == report
    runs = out.with_name("report_runs")
    exact = json.loads((runs / "ddim4_trailing" / "MEL" / "ISIC_0000001.json").read_text())
    fast_png = runs / "ddim4_trailing_fastmath" / "MEL" / "ISIC_0000002.png"
    fast = json.loads(fast_png.with_suffix(".json").read_text())
    assert "attention_fast_math" not in exact["scheduler"]
    assert fast["scheduler"]["attention_fast_math"] is True
    assert fast["scheduler"]["dtype"] == "bfloat16"
    redo = tmp_path / "redo.png"
    assert cli.reproduce_from_sidecar(str(fast_png.with_suffix(".json")), str(ckpt),
                                      output=str(redo), postprocess=False,
                                      model_config=small_unet_config(SIZE),
                                      device="cpu") == 0
    assert redo.read_bytes() == fast_png.read_bytes()


def test_sampler_ladder_every_scheduler(ladder):
    report, out = ladder
    assert set(report) == LADDER_KEYS
    assert [r["scheduler"] for r in report["rungs"]] == [
        "ddim", "dpm_solver", "unipc", "dpm_solver_sde", "ddpm"]
    for r in report["rungs"]:
        assert set(r) == RUNG_KEYS
        assert np.isfinite(r["frechet_vs_heldout"]) and r["img_per_s"] > 0
    best = min(r["frechet_vs_heldout"] for r in report["rungs"])
    within = [r for r in report["rungs"] if r["frechet_vs_heldout"] <= 1.15 * best]
    assert report["headline"] == max(within, key=lambda r: r["img_per_s"])
    assert json.loads(out.read_text())["headline"] == report["headline"]
    assert (out.parent / "sampler_ladder_runs" / "unipc_3_trailing" / "MEL"
            / "ISIC_0000004.png").exists()


def test_sampler_ladder_through_python_m(ckpt, tmp_path):
    out = tmp_path / "ladder.json"
    run = subprocess.run([sys.executable, "-m", "synt_isic_tpu_torch.scripts.sampler_ladder",
                          "--checkpoints", str(ckpt), "--size", str(SIZE), "--count", "2",
                          "--heldout", "8", "--configs", "ddim:2:trailing", "--device", "cpu",
                          "--out", str(out)], cwd=ROOT, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stderr[-2000:]
    report = json.loads(out.read_text())
    assert [(r["scheduler"], r["steps"], r["timestep_spacing"]) for r in report["rungs"]] == [
        ("ddim", 2, "trailing")]


def test_distill_ladder_closes(ckpt, tmp_path):
    out = tmp_path / "distill"
    report = distill_ladder.run_distill_ladder(
        str(ckpt), str(out), size=SIZE, start_steps=8, end_steps=4, steps_per_phase=2,
        batch_size=4, train_images=8, count=2, heldout=HELDOUT, seed=0, **QUIET)
    assert set(report) == DISTILL_KEYS
    # the teacher at the start count, then the phase's (teacher, student) pair
    assert [r["tag"] for r in report["rungs"]] == ["teacher_ddim8", "teacher_ddim4", "distill4"]
    assert [r["steps"] for r in report["rungs"]] == [8, 4, 4]
    for r in report["rungs"]:
        assert set(r) - {"phase_final_loss"} == DISTILL_RUNG_KEYS
        assert np.isfinite(r["frechet_vs_heldout"]) and r["img_per_s"] > 0
    assert np.isfinite(report["rungs"][2]["phase_final_loss"])
    want = _jax_ladder_anchors(seed=0, count=2)
    for key, value in want.items():
        assert _close(report[key], value), key
    assert (out / "checkpoints" / "unet_MEL_distill4.pth").exists()
    assert json.loads((out / "report.json").read_text())["rungs"] == report["rungs"]


def test_augment_eval_preserves_the_border(augmented):
    report, out = augmented
    assert set(report) == AUGMENT_KEYS
    assert json.loads(out.read_text()) == report
    sweep = {r["strength"]: r for r in report["strength_sweep"]}
    assert sorted(sweep) == [0.5, 1.0]
    # a lower strength walks fewer steps from the source and stays nearer it
    assert sweep[0.5]["mean_rms_to_source"] < sweep[1.0]["mean_rms_to_source"]
    assert report["inpaint_center_box"]["border_preserved"]
    assert report["inpaint_center_box"]["border_max_abs_err"] < 1e-4
    assert report["diversity"]["seeds"] == 3
    assert report["diversity"]["mean_pairwise_feature_dist_variants"] > 0
    assert np.isfinite(report["plain_generation_frechet"])
