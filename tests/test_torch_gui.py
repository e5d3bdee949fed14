"""The port's desktop window (`synt_isic_tpu_torch/app/gui.py`) on the
qt_compat stub backend, at the tiny config on the CPU.

Every test of `tests/test_gui.py` has its counterpart here on the port's
`SyntheticDataGeneratorWindow`, built with `devices=["cpu", "cpu"]` (the
counterpart of the JAX tests' virtual CPU devices) so the "all devices
(dp)" entry runs: class discovery, generation through the worker, the
preview and its XAI overlay, the results browser, the memory labels (n/a
off CUDA), the device combo and its data-parallel mesh, the variant and
family selectors, guidance and the sampler selector. Beside them:

  * parity with the JAX window, both built over the same tiny `.pth`
    files: the same class availability, the same sampler, spacing,
    seed-mode, variant and family combo items, and the same files and CSV
    rows for MEL:2 at 2 fixed-seed steps (pixels differ by design: the two
    packages' noise streams are their own);
  * `qt_compat`'s stub exports the same names in both packages;
  * the standalone XAI worker's command and environment (the port's module,
    the window's device, checkpoints and results folders), the integrated
    analyzer on the window's device, `main()` without PyQt5, and the refusal
    to build without CUDA unless devices are named.
"""
import csv
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from synt_isic_tpu.app import gui as jax_gui
from synt_isic_tpu.app import qt_compat as jax_qt_compat
from synt_isic_tpu_torch.app import gui, qt_compat
from synt_isic_tpu_torch.app.gui import SyntheticDataGeneratorWindow
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.io.convert import state_dict_from_jax
from synt_isic_tpu_torch.io.pth import save_checkpoint
from synt_isic_tpu_torch.utils.config import ConfigManager

from tests.torch_port_fixtures import (COND_CLASSES, TINY, TINY_COND_JAX, TINY_JAX,  # noqa: F401
                                       jax_params, one_thread)

DEVICES = ["cpu", "cpu"]

needs_stub = pytest.mark.skipif(
    qt_compat.QT_BACKEND != "stub",
    reason="synchronous-QThread assertions are stub-backend specific")


def _save_unet(path: Path, seed: int, config=TINY_JAX) -> None:
    save_checkpoint(state_dict_from_jax(jax_params(config, seed)), str(path))


def _write_conditional_checkpoint(ckpt_dir: Path, variant: str = "best", seed: int = 0):
    _save_unet(ckpt_dir / f"unet_conditional_{variant}.pth", seed, TINY_COND_JAX)
    (ckpt_dir / f"unet_conditional_{variant}.json").write_text(json.dumps({
        "classes": list(COND_CLASSES),
        "num_class_embeds": len(COND_CLASSES) + 1,
        "null_label": len(COND_CLASSES)}))


def _config(base: Path) -> ConfigManager:
    return ConfigManager(config_file=str(base / "config.json"), project_root=str(base))


def _port_window(base: Path, ckpt: Path) -> SyntheticDataGeneratorWindow:
    cfg = _config(base)
    gen = ImageGenerator(config=cfg, checkpoints_dir=str(ckpt), model_config=TINY, device="cpu")
    return SyntheticDataGeneratorWindow(
        config=cfg, generator=gen, checkpoints_dir=str(ckpt),
        output_dir=str(base / "generated"), xai_results_dir=str(base / "xai_results"),
        devices=DEVICES)


def _combo_items(combo):
    if qt_compat.QT_BACKEND == "stub":
        return list(combo._items)
    return [combo.itemText(i) for i in range(combo.count())]


@pytest.fixture(scope="module")
def window(tmp_path_factory):
    base = tmp_path_factory.mktemp("gui")
    ckpt = base / "checkpoints"
    ckpt.mkdir()
    _save_unet(ckpt / "unet_MEL_best.pth", 0)
    _save_unet(ckpt / "unet_NV_best.pth", 1)
    return _port_window(base, ckpt), base


def test_class_discovery_enables_only_available(window):
    win, _ = window
    assert win.class_rows["MEL"][0].isEnabled()
    assert win.class_rows["NV"][0].isEnabled()
    assert not win.class_rows["BCC"][0].isEnabled()
    assert win.class_rows["BCC"][0].toolTip() == "no checkpoint found"


def test_config_panel_reports_models_and_paths(window):
    win, base = window
    assert "Available models: 2" in win.available_models_label.text()
    assert str(base / "checkpoints") in win.model_path_label.text()
    assert win.device_info_label.text() == "Device: cpu"


def test_start_without_selection_warns(window):
    win, _ = window
    win.start_generation()
    assert "[warning] select at least one class" in win.logs.toPlainText()


@needs_stub
def test_generation_flow_end_to_end(window):
    """Start button -> worker -> images on disk -> progress + browser."""
    win, base = window
    win.class_rows["MEL"][0].setChecked(True)
    win.class_rows["MEL"][1].setValue(2)
    win.steps_spin.setValue(2)
    win.seed_mode.setCurrentText("fixed")
    win.seed_spin.setValue(7)
    win.start_btn.click()
    # stub QThread runs synchronously: generation is done on return
    pngs = sorted((base / "generated").rglob("*.png"))
    assert len(pngs) == 2
    assert win.progress.value() == win.progress.maximum() > 0
    assert win.start_btn.isEnabled() and not win.stop_btn.isEnabled()
    assert win.files_list.count() == 2
    assert win.status_label.text().startswith("done:")
    sidecar = json.loads((base / "generated" / "MEL" / "ISIC_0000001.json").read_text())
    assert sidecar["seed"] is not None and sidecar["inference_steps"] == 2


@needs_stub
def test_preview_and_xai_overlay_path(window):
    win, base = window
    img = str(sorted((base / "generated").rglob("*.png"))[0])
    # no XAI mode: preview shows the clicked file
    win.xai_check.setChecked(False)
    win.display_image(img)
    assert win._preview_path == img
    assert win.preview.pixmap_set is not None
    # XAI mode + a fabricated artifact for this image -> overlay is shown
    stem = Path(img).stem
    cls = Path(img).parent.name
    run_dir = Path(img).parents[2] / "xai_results" / cls / f"{stem}_7"
    run_dir.mkdir(parents=True)
    art = run_dir / "xai_step_t_000.png"
    Image.new("RGB", (16, 16), (255, 0, 0)).save(art)
    win.xai_check.setChecked(True)
    win.display_image(img)
    assert win._preview_path == str(art)
    assert "XAI overlay:" in win.logs.toPlainText()
    win.xai_check.setChecked(False)


@needs_stub
def test_xai_results_browser_runs_files_and_viewers(window):
    win, base = window
    xai = base / "xai_results"
    run = xai / "MEL" / "demo_run_42"
    run.mkdir(parents=True, exist_ok=True)
    Image.new("RGB", (8, 8)).save(run / "time_shap_analysis.png")
    (run / "analysis_results.json").write_text(
        json.dumps({"metadata": {"class": "MEL", "seed": 42}}))
    with open(run / "full_results.pkl", "wb") as f:
        pickle.dump({"frames": [1, 2], "stats": {}}, f)

    win.refresh_results()
    runs = [win.xai_runs_list.item(i).text() for i in range(win.xai_runs_list.count())]
    assert any(r.endswith("demo_run_42") for r in runs)
    files = [win.xai_files_list.item(i).text() for i in range(win.xai_files_list.count())]
    assert {"analysis_results.json", "full_results.pkl",
            "time_shap_analysis.png"} <= set(files)
    win.xai_files_list.click_row(files.index("analysis_results.json"))
    assert '"seed": 42' in win._last_dialog._layout.items[0].toPlainText()
    win.xai_files_list.click_row(files.index("full_results.pkl"))
    text = win._last_dialog._layout.items[0].toPlainText()
    assert "Type: dict" in text and "frames" in text
    win.xai_files_list.click_row(files.index("time_shap_analysis.png"))
    assert win._preview_path.endswith("time_shap_analysis.png")


@needs_stub
def test_memory_timer_updates_labels(window):
    """The labels read `utils/profiling.device_memory_stats`, which has no
    figures off CUDA: n/a on the CPU devices."""
    win, _ = window
    win._mem_timer.fire()
    assert win.mem_label.text() == "mem: n/a"
    assert win.memory_info_label.text() == "Memory: n/a"


def test_stop_button_requests_cooperative_stop(window):
    win, _ = window
    win.stop_generation()  # no worker running: must not raise
    assert win.generator.stop_requested in (True, False)


def test_device_combo_dp_mesh_entry(window):
    """With two devices the combo grows an 'all 2 devices (dp)' entry that
    sets a data-parallel mesh over the window's devices on the generator;
    selecting a single device clears it."""
    win, _ = window
    assert _combo_items(win.device_combo) == ["cpu", "cpu", "all 2 devices (dp)"]
    win.device_combo.setCurrentIndex(2)      # the dp entry
    win._on_device_changed(2)
    assert win.generator.mesh is not None
    assert win.generator.mesh.shape["data"] == 2
    win._update_memory_info()                # must not raise on the dp entry
    win._on_device_changed(0)
    assert win.generator.mesh is None
    assert win.generator.model_manager.device == torch.device("cpu")


def test_variant_combo_lists_and_switches(window):
    win, base = window
    ckpt = base / "checkpoints"
    _save_unet(ckpt / "unet_MEL_distill4.pth", 3)
    _save_unet(ckpt / "unet_MEL_epoch5.pth", 3)
    win._refresh_classes()
    items = _combo_items(win.variant_combo)
    assert items[0] == "best"
    assert "distill4" in items
    assert not any(v.startswith("epoch") for v in items)

    win.variant_combo.setCurrentText("distill4")
    win._on_variant_changed(items.index("distill4"))
    mm = win.generator.model_manager
    assert mm.variant == "distill4"
    assert mm.checkpoint_path("MEL").name == "unet_MEL_distill4.pth"
    assert not mm.loaded_models  # stale weights dropped
    win.variant_combo.setCurrentText("best")
    win._on_variant_changed(0)
    assert mm.checkpoint_path("MEL").name == "unet_MEL_best.pth"


def test_variant_availability_follows_active_variant(window):
    win, base = window
    ckpt = base / "checkpoints"
    if not (ckpt / "unet_MEL_distill4.pth").exists():
        _save_unet(ckpt / "unet_MEL_distill4.pth", 3)
    win._refresh_classes()
    win.variant_combo.setCurrentText("distill4")
    win._on_variant_changed(0)
    assert win.generator.model_manager.variant == "distill4"
    assert win.class_rows["MEL"][0].isEnabled()
    assert not win.class_rows["NV"][0].isEnabled()
    assert "distill4" in win.class_rows["NV"][0].toolTip()
    win.variant_combo.setCurrentText("best")
    win._on_variant_changed(0)
    assert win.class_rows["NV"][0].isEnabled()
    assert win.class_rows["MEL"][0].isEnabled()


def test_variant_reset_when_checkpoints_vanish(window):
    win, base = window
    path = base / "checkpoints" / "unet_MEL_distill4.pth"
    if not path.exists():
        _save_unet(path, 3)
    win._refresh_classes()
    win.variant_combo.setCurrentText("distill4")
    win._on_variant_changed(0)
    mm = win.generator.model_manager
    assert mm.variant == "distill4"
    path.unlink()
    win._refresh_classes()
    assert mm.variant == "best"
    assert mm.checkpoint_path("MEL").name == "unet_MEL_best.pth"
    assert win.class_rows["NV"][0].isEnabled()


# -- model-family selector (conditional family) ------------------------------------

@pytest.fixture(scope="module")
def cond_window(tmp_path_factory):
    """Window over a checkpoints dir holding both families: per-class
    MEL/NV checkpoints and the single conditional checkpoint."""
    base = tmp_path_factory.mktemp("gui_cond")
    ckpt = base / "checkpoints"
    ckpt.mkdir()
    _save_unet(ckpt / "unet_MEL_best.pth", 0)
    _save_unet(ckpt / "unet_NV_best.pth", 1)
    _write_conditional_checkpoint(ckpt)
    return _port_window(base, ckpt), base


def _switch_family(win, family: str):
    win.family_combo.setCurrentText(family)
    win._on_family_changed(_combo_items(win.family_combo).index(family))


def test_family_combo_offers_conditional_when_present(cond_window, window):
    win, _ = cond_window
    assert _combo_items(win.family_combo) == ["per-class", "conditional"]
    assert win.family_combo.currentText() == "per-class"
    assert not win.guidance_spin.isEnabled()
    assert "conditional" not in win.generator.get_available_classes()
    plain_win, _ = window
    assert _combo_items(plain_win.family_combo) == ["per-class"]


def test_family_switch_to_conditional(cond_window):
    win, _ = cond_window
    win.guidance_spin.setValue(2.0)
    _switch_family(win, "conditional")
    mm = win.generator.model_manager
    assert mm.conditional
    # the rebuilt generator stays on the window's device and architecture
    assert mm.device == torch.device("cpu")
    assert mm.config.block_out_channels == TINY.block_out_channels
    assert win.generator.guidance_scale == 2.0
    assert win.guidance_spin.isEnabled()
    for cls in COND_CLASSES:
        assert win.class_rows[cls][0].isEnabled()
    assert not win.class_rows["BCC"][0].isEnabled()
    assert "Available models: 3" in win.available_models_label.text()


@needs_stub
def test_conditional_generation_mixed_classes(cond_window):
    """One conditional model, two classes in one run through the worker."""
    win, base = cond_window
    if not win.generator.model_manager.conditional:
        _switch_family(win, "conditional")
    win.class_rows["MEL"][0].setChecked(True)
    win.class_rows["MEL"][1].setValue(1)
    win.class_rows["VASC"][0].setChecked(True)
    win.class_rows["VASC"][1].setValue(1)
    win.steps_spin.setValue(2)
    win.seed_mode.setCurrentText("fixed")
    win.seed_spin.setValue(3)
    win.start_btn.click()
    assert (base / "generated" / "MEL" / "ISIC_0000001.png").exists()
    assert (base / "generated" / "VASC" / "ISIC_0000001.png").exists()
    assert win.status_label.text().startswith("done:")


def test_guidance_spin_live_updates_generator(cond_window):
    win, _ = cond_window
    if not win.generator.model_manager.conditional:
        _switch_family(win, "conditional")
    win.guidance_spin.setValue(3.5)
    assert win.generator.guidance_scale == 3.5


def test_family_switch_back_to_per_class(cond_window):
    win, _ = cond_window
    if not win.generator.model_manager.conditional:
        _switch_family(win, "conditional")
    _switch_family(win, "per-class")
    mm = win.generator.model_manager
    assert not mm.conditional
    assert not win.guidance_spin.isEnabled()
    assert win.class_rows["MEL"][0].isEnabled()
    assert win.class_rows["NV"][0].isEnabled()
    assert not win.class_rows["VASC"][0].isEnabled()


def test_sampler_selector_live_and_survives_family_switch(cond_window):
    win, base = cond_window
    win.sampler_combo.setCurrentText("unipc")
    win.spacing_combo.setCurrentText("trailing")
    win._on_sampler_changed(0)
    assert win.generator.scheduler_kind == "unipc"
    assert win.generator.timestep_spacing == "trailing"

    want = "per-class" if win.generator.model_manager.conditional else "conditional"
    _switch_family(win, want)
    assert win.generator.scheduler_kind == "unipc"
    assert win.generator.timestep_spacing == "trailing"

    win.class_rows["MEL"][0].setChecked(True)
    win.class_rows["MEL"][1].setValue(1)
    for other in ("NV", "VASC"):
        win.class_rows[other][0].setChecked(False)
    win.out_edit.setText(str(base / "gen_unipc"))
    win.steps_spin.setValue(3)
    win.seed_mode.setCurrentText("fixed")
    win.seed_spin.setValue(9)
    win.start_btn.click()
    assert (base / "gen_unipc" / "MEL" / "ISIC_0000001.png").exists()
    sidecar = json.loads((base / "gen_unipc" / "MEL" / "ISIC_0000001.json").read_text())
    assert sidecar["scheduler"]["kind"] == "unipc"
    assert sidecar["scheduler"]["timestep_spacing"] == "trailing"


# -- the port's own surface -----------------------------------------------------------

def test_window_without_cuda_refuses_to_pick_the_cpu(window):
    """With no device named, the window takes every CUDA device and, where
    there is none, raises before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    win, base = window
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticDataGeneratorWindow(config=win.config, generator=win.generator,
                                     checkpoints_dir=str(base / "checkpoints"))


def test_default_generator_runs_on_the_first_named_device(window, monkeypatch):
    """Built without a generator, the window's own runs on the first device
    it lists, also where CUDA is present."""
    win, base = window
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    own = SyntheticDataGeneratorWindow(config=win.config,
                                       checkpoints_dir=str(base / "checkpoints"),
                                       devices=["cpu"])
    assert own.generator.model_manager.device == torch.device("cpu")
    assert _combo_items(own.device_combo)[0] == "cpu"


class _FakePopen:
    """Records the command and environment; its output is two lines."""
    calls = []

    def __init__(self, argv, env=None, **kwargs):
        _FakePopen.calls.append((argv, env))
        self.stdout = iter(["[xai-standalone] class=MEL\n", "done\n"])

    def wait(self):
        return 0

    def poll(self):
        return 0


@needs_stub
def test_standalone_xai_worker_runs_the_port_on_the_window_device(window, monkeypatch):
    """The worker spawns the port's standalone module on the window's
    device, over the window's checkpoints folder, writing where the results
    browser reads (ROADMAP C12: the JAX window passes neither folder, so its
    child reads ./checkpoints whatever the window shows)."""
    import subprocess

    win, base = window
    monkeypatch.setattr(subprocess, "Popen", _FakePopen)
    _FakePopen.calls.clear()
    for cls, (cb, _) in win.class_rows.items():
        cb.setChecked(cls == "MEL")
    win.steps_spin.setValue(10)
    win.seed_spin.setValue(5)
    win.run_standalone_xai()
    (argv, env), = _FakePopen.calls
    assert argv[-2:] == ["-m", "synt_isic_tpu_torch.xai.standalone"]
    assert {k: env[k] for k in ("XAI_TARGET_CLASS", "XAI_GENERATION_SEED",
                                "XAI_INFERENCE_STEPS", "XAI_DEVICE", "XAI_CHECKPOINTS_DIR",
                                "XAI_RESULTS_DIR")} == {
        "XAI_TARGET_CLASS": "MEL", "XAI_GENERATION_SEED": "5", "XAI_INFERENCE_STEPS": "10",
        "XAI_DEVICE": "cpu", "XAI_CHECKPOINTS_DIR": str(base / "checkpoints"),
        "XAI_RESULTS_DIR": str(base / "xai_results")}
    logs = win.logs.toPlainText()
    assert "[info] done" in logs and "standalone XAI exited (0)" in logs
    # the JAX window's worker: the same protocol without the folders
    jax_worker = jax_gui.XAIWorker("MEL", 5, 10)
    assert "XAI_CHECKPOINTS_DIR" not in jax_worker.env_vars
    assert "XAI_RESULTS_DIR" not in jax_worker.env_vars


@needs_stub
def test_integrated_xai_analyzer_on_the_window_device(window, monkeypatch):
    """With "Integrated XAI" on, Start builds the analyzer on the window's
    device from the checkpoints folder's classifier.pth and hands every
    xai_frequency-th trajectory to it."""
    from synt_isic_tpu_torch.xai import integration

    win, base = window
    seen, analysed = {}, []

    class _Analyzer:
        def analyze_trajectory(self, trajectory, class_name, seed, inference_steps,
                               filename, file_path, timesteps=None):
            analysed.append((class_name, filename, tuple(trajectory.shape)))
            return {"metadata": {"device": "cpu"}}

    def factory(**kwargs):
        seen.update(kwargs)
        return _Analyzer()

    monkeypatch.setattr(integration, "create_integrated_xai_analyzer", factory)
    for cls, (cb, count) in win.class_rows.items():
        cb.setChecked(cls == "MEL")
    win.class_rows["MEL"][1].setValue(2)
    win.out_edit.setText(str(base / "gen_xai"))
    win.steps_spin.setValue(2)
    win.seed_mode.setCurrentText("fixed")
    win.xai_freq.setValue(2)
    win.xai_check.setChecked(True)
    try:
        win.start_btn.click()
    finally:
        win.xai_check.setChecked(False)
        win.out_edit.setText(str(base / "generated"))
    assert seen["device"] == torch.device("cpu")
    assert seen["classifier_path"] == str(base / "checkpoints" / "classifier.pth")
    assert [(c, f) for c, f, _ in analysed] == [("MEL", "ISIC_0000002.png")]
    assert analysed[0][2][0] == 2   # every step of the walk
    assert len(list((base / "gen_xai" / "xai_results" / "MEL").glob("xai_*.json"))) == 1


def test_main_without_pyqt_points_to_the_port(capsys):
    if qt_compat.QT_BACKEND != "stub":
        pytest.skip("PyQt5 is installed: main() would open a window")
    assert gui.main() == 1
    out = capsys.readouterr().out
    assert "python -m synt_isic_tpu_torch.cli" in out
    assert "python -m synt_isic_tpu_torch.xai.standalone" in out
    assert "synt_isic_tpu.cli" not in out


# -- parity with the JAX window -------------------------------------------------------

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX window and the port's over one checkpoints folder: per-class
    MEL and NV, a MEL distill4 variant, and the conditional checkpoint."""
    from synt_isic_tpu.generator import ImageGenerator as JaxImageGenerator
    from synt_isic_tpu.utils.config import ConfigManager as JaxConfigManager

    base = tmp_path_factory.mktemp("gui_pair")
    ckpt = base / "checkpoints"
    ckpt.mkdir()
    _save_unet(ckpt / "unet_MEL_best.pth", 0)
    _save_unet(ckpt / "unet_NV_best.pth", 1)
    _save_unet(ckpt / "unet_MEL_distill4.pth", 2)
    _write_conditional_checkpoint(ckpt)
    jbase, pbase = base / "jax", base / "port"
    jbase.mkdir()
    pbase.mkdir()
    jcfg = JaxConfigManager(config_file=str(jbase / "config.json"), project_root=str(jbase))
    jgen = JaxImageGenerator(config=jcfg, checkpoints_dir=str(ckpt), model_config=TINY_JAX)
    jwin = jax_gui.SyntheticDataGeneratorWindow(
        config=jcfg, generator=jgen, checkpoints_dir=str(ckpt),
        output_dir=str(jbase / "generated"), xai_results_dir=str(jbase / "xai_results"))
    return jwin, _port_window(pbase, ckpt), base


def test_parity_class_availability(pair):
    jwin, pwin, _ = pair
    for cls, (cb, _) in jwin.class_rows.items():
        pcb = pwin.class_rows[cls][0]
        assert (pcb.isEnabled(), pcb.toolTip()) == (cb.isEnabled(), cb.toolTip()), cls
    assert pwin.available_models_label.text() == jwin.available_models_label.text()
    assert pwin.model_path_label.text() == jwin.model_path_label.text()


def test_parity_combo_items(pair):
    jwin, pwin, _ = pair
    for name in ("sampler_combo", "spacing_combo", "seed_mode", "variant_combo",
                 "family_combo"):
        jcombo, pcombo = getattr(jwin, name), getattr(pwin, name)
        assert _combo_items(pcombo) == _combo_items(jcombo), name
        assert pcombo.currentText() == jcombo.currentText(), name
    assert _combo_items(pwin.variant_combo) == ["best", "distill4"]
    assert _combo_items(pwin.family_combo) == ["per-class", "conditional"]
    assert (pwin.steps_spin.value(), pwin.seed_spin.value(), pwin.xai_freq.value()) == (
        jwin.steps_spin.value(), jwin.seed_spin.value(), jwin.xai_freq.value())


def _rows(csv_path: Path):
    with open(csv_path, newline="", encoding="utf-8") as f:
        return [{k: v for k, v in row.items() if k != "generated_at"}
                for row in csv.DictReader(f)]


@needs_stub
def test_parity_generation_files_and_csv_rows(pair):
    """MEL:2 at 2 fixed-seed steps through each window: the same files and
    the same CSV rows; the sidecars record the same seeds and sampler."""
    jwin, pwin, base = pair
    outs = {}
    for name, win in (("jax", jwin), ("port", pwin)):
        for cls, (cb, count) in win.class_rows.items():
            cb.setChecked(cls == "MEL")
        win.class_rows["MEL"][1].setValue(2)
        win.steps_spin.setValue(2)
        win.seed_mode.setCurrentText("fixed")
        win.seed_spin.setValue(7)
        win.start_btn.click()
        assert win.status_label.text().startswith("done:"), name
        outs[name] = base / name / "generated"
    jfiles, pfiles = (sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
                      for out in (outs["jax"], outs["port"]))
    assert pfiles == jfiles
    assert "MEL/ISIC_0000002.png" in pfiles and "synthetic_dataset.csv" in pfiles
    assert _rows(outs["port"] / "synthetic_dataset.csv") == \
        _rows(outs["jax"] / "synthetic_dataset.csv")
    for stem in ("ISIC_0000001", "ISIC_0000002"):
        jside, pside = (json.loads((out / "MEL" / f"{stem}.json").read_text())
                        for out in (outs["jax"], outs["port"]))
        assert pside["seed"] == jside["seed"]
        assert pside["scheduler"]["kind"] == jside["scheduler"]["kind"] == "ddpm"
        assert pside["inference_steps"] == jside["inference_steps"] == 2
    for out in outs.values():
        for path in sorted((out / "MEL").glob("*.png")):
            assert np.asarray(Image.open(path)).shape == (TINY.sample_size, TINY.sample_size, 3)


def test_qt_compat_stub_exports_the_same_names():
    def public(module):
        return {name for name in vars(module) if not name.startswith("_")} - {"annotations"}

    assert public(qt_compat) == public(jax_qt_compat)
    assert qt_compat.QT_BACKEND == jax_qt_compat.QT_BACKEND
    for name in public(qt_compat):
        port, ref = getattr(qt_compat, name), getattr(jax_qt_compat, name)
        if isinstance(port, type):
            assert set(vars(port)) - {"__module__", "__qualname__"} == \
                set(vars(ref)) - {"__module__", "__qualname__"}, name
