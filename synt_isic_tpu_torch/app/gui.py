"""PyQt5 GUI client over the port's generation engine, on a CUDA device.

The port of `synt_isic_tpu/app/gui.py`, a rebuild of the reference desktop
app (`main.py`, 1779 LoC): the same 4-panel layout — top controls
(model/output dirs, device, XAI mode, inference steps 1-1000, seed
mode/value, XAI frequency; `main.py:437-535`), left class checkboxes with
counts (:555-634), center preview + progress (:636-675), right results
browser: output files plus the XAI runs/files two-list with JSON/PKL
viewers (:677-743, :1624-1714), bottom logs + system-configuration panel
(:745-799) — wired to `ImageGenerator` through a QThread worker
(GenerationWorker, `main.py:31-61`). The preview applies
the XAI attribution overlay when XAI mode is on (display_image path,
`main.py:890-966`).

Differences by design (north star: "GUI becomes a thin client"):
  * the XAI path runs in-process through `IntegratedXAIAnalyzer`, on the
    window's device (the reference's subprocess+env-var XAIWorker protocol
    is preserved in `xai/standalone.py` for headless use — no Qt dependency
    there);
  * device selection toggles between the window's devices: every CUDA
    device unless the caller names others (`devices=`, e.g. ["cpu", "cpu"]
    in the CPU tests); with no CUDA device and none named, construction
    raises — the window never shows a CPU it was not given;
  * the standalone XAI subprocess runs on the window's device
    (`XAI_DEVICE`) over the window's checkpoints folder, and writes where
    the results browser looks (`XAI_CHECKPOINTS_DIR`, `XAI_RESULTS_DIR`);
  * Qt comes through `qt_compat`: PyQt5 when installed, a headless stub
    otherwise — the window logic is constructible and tested either way
    (tests/test_torch_gui.py); `main()` only launches a real app on PyQt5.
"""
from __future__ import annotations

import json
import pickle
import sys
from pathlib import Path

import torch

from .qt_compat import (QT_BACKEND, QApplication, QCheckBox, QComboBox,
                        QDialog, QDoubleSpinBox, QFileDialog, QGridLayout,
                        QGroupBox, QHBoxLayout, QLabel, QLineEdit,
                        QListWidget, QMainWindow, QPixmap, QProgressBar,
                        QPushButton, QSpinBox, QSplitter, Qt, QTextEdit,
                        QThread, QTimer, QVBoxLayout, QWidget, pyqtSignal)

PYQT_AVAILABLE = QT_BACKEND == "pyqt5"


class GenerationWorker(QThread):
    """Runs `generator.generate_images` off the GUI thread
    (reference `main.py:31-61`)."""
    progress = pyqtSignal(int, int, str)
    log = pyqtSignal(str, str)
    finished_ok = pyqtSignal(dict)

    def __init__(self, generator, class_configs, output_dir, postprocess):
        super().__init__()
        self.generator = generator
        self.class_configs = class_configs
        self.output_dir = output_dir
        self.postprocess = postprocess

    def run(self):
        self.generator.set_progress_callback(
            lambda done, total, msg: self.progress.emit(done, total, msg))
        self.generator.set_log_callback(
            lambda msg, level: self.log.emit(msg, level))
        result = self.generator.generate_images(
            self.class_configs, self.output_dir, self.postprocess)
        self.finished_ok.emit(result or {})


class XAIWorker(QThread):
    """Runs the standalone XAI analysis as a subprocess with the
    reference's env-var protocol (`main.py:62-127`, `main.py:1552-1563`),
    streaming stdout lines into the GUI log."""
    log = pyqtSignal(str, str)
    finished_ok = pyqtSignal(int)

    def __init__(self, target_class: str, seed: int, steps: int,
                 save_every: int = 5, extra_env: dict = None):
        super().__init__()
        self.env_vars = {
            "XAI_TARGET_CLASS": target_class,
            "XAI_GENERATION_SEED": str(seed),
            "XAI_INFERENCE_STEPS": str(steps),
            "XAI_SAVE_EVERY_N": str(save_every),
            **(extra_env or {}),
        }
        self._proc = None

    def run(self):
        import os
        import subprocess
        import sys as _sys

        env = dict(os.environ, **self.env_vars,
                   PYTHONUNBUFFERED="1", MPLBACKEND="Agg")
        self._proc = subprocess.Popen(
            [_sys.executable, "-u", "-m", "synt_isic_tpu_torch.xai.standalone"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for line in self._proc.stdout:
            self.log.emit(line.rstrip(), "info")
        self.finished_ok.emit(self._proc.wait())

    def stop(self):
        if self._proc and self._proc.poll() is None:
            self._proc.kill()


class SyntheticDataGeneratorWindow(QMainWindow):
    def __init__(self, config=None, generator=None,
                 checkpoints_dir: str = None, output_dir: str = None,
                 xai_results_dir: str = None, devices=None):
        super().__init__()
        from ..generator import ImageGenerator
        from ..utils.config import CLASS_NAMES, ConfigManager

        # the devices the combo offers: every CUDA device unless named
        if devices is None:
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            if not devices:
                raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                                   "the window on the CPU")
        self._devices = [torch.device(d) for d in devices]
        self.config = config or ConfigManager()
        # the default generator runs on the device the combo shows first
        self.generator = generator or ImageGenerator(
            config=self.config, checkpoints_dir=checkpoints_dir, device=self._devices[0])
        # the UNCONDITIONAL architecture config + compute dtype, kept for
        # family switches (the conditional ModelManager derives its
        # embedding-table size from the checkpoint metadata on top of this)
        import dataclasses as _dc
        self._base_model_config = _dc.replace(
            self.generator.model_manager.config, num_class_embeds=None)
        self._compute_dtype = self.generator.model_manager.dtype
        self.class_names = CLASS_NAMES
        self.worker = None
        self._checkpoints_dir = checkpoints_dir or str(Path("checkpoints").resolve())
        self._output_dir = output_dir or str(Path("generated_images").resolve())
        self._xai_results_dir = xai_results_dir or str(Path("xai_results").resolve())
        self.setWindowTitle("SYNT-ISIC (PyTorch/CUDA) — synthetic dermatology generator")
        self.resize(1280, 840)
        self._build_ui()
        self._refresh_classes()
        self._update_config_info()
        # device-memory telemetry (reference polls CUDA memory every 2s,
        # `main.py:213-253`)
        self._mem_timer = QTimer(self)
        self._mem_timer.timeout.connect(self._update_memory_info)
        self._mem_timer.start(2000)

    # -- layout -------------------------------------------------------------
    def _build_ui(self):
        central = QWidget()
        root = QVBoxLayout(central)

        # top controls
        top = QGroupBox("Generation settings")
        grid = QGridLayout(top)
        self.ckpt_edit = QLineEdit(self._checkpoints_dir)
        ckpt_btn = QPushButton("…")
        ckpt_btn.clicked.connect(lambda: self._pick_dir(self.ckpt_edit))
        self.out_edit = QLineEdit(self._output_dir)
        out_btn = QPushButton("…")
        out_btn.clicked.connect(lambda: self._pick_dir(self.out_edit))
        self.device_combo = QComboBox()
        for d in self._devices:
            self.device_combo.addItem(str(d))
        # beyond-reference: with >1 device, an "all devices (dp)" entry
        # shards sampling batches over a data-parallel mesh (per-seed RNG
        # streams keep images identical to the single-device run)
        if len(self._devices) > 1:
            self.device_combo.addItem(f"all {len(self._devices)} devices (dp)")
        self.device_combo.currentIndexChanged.connect(self._on_device_changed)
        self.mem_label = QLabel("mem: n/a")
        self.steps_spin = QSpinBox()
        self.steps_spin.setRange(1, 1000)
        self.steps_spin.setValue(int(self.config.get_generation_param(
            "inference_timesteps")))
        self.seed_mode = QComboBox()
        self.seed_mode.addItems(["random", "fixed"])
        self.seed_mode.setCurrentText(
            self.config.get_generation_param("seed_mode"))
        self.seed_spin = QSpinBox()
        self.seed_spin.setRange(0, 2**31 - 1)
        self.seed_spin.setValue(int(self.config.get_generation_param("seed_value")))
        self.xai_check = QCheckBox("Integrated XAI")
        self.xai_freq = QSpinBox()
        self.xai_freq.setRange(1, 1000)
        self.xai_freq.setValue(int(self.config.get_generation_param("xai_frequency")))
        # beyond-reference: checkpoint-variant selector — progressive-
        # distillation students (unet_<CLASS>_distillN.pth) sample through
        # the unchanged pipeline at their own step count
        self.variant_combo = QComboBox()
        self.variant_combo.currentIndexChanged.connect(self._on_variant_changed)
        # beyond-reference: model-family selector — 'per-class' (reference
        # semantics: one checkpoint per class) vs 'conditional' (one
        # class-conditional checkpoint serving every class, with a
        # classifier-free-guidance weight). The conditional entry appears
        # only when unet_conditional_<variant>.pth (+ .json metadata) exists
        # in the checkpoints dir.
        self.family_combo = QComboBox()
        self.family_combo.currentIndexChanged.connect(self._on_family_changed)
        self.guidance_spin = QDoubleSpinBox()
        self.guidance_spin.setRange(0.0, 10.0)
        self.guidance_spin.setSingleStep(0.5)
        self.guidance_spin.setValue(float(self.generator.guidance_scale))
        self.guidance_spin.setEnabled(False)
        self.guidance_spin.valueChanged.connect(self._on_guidance_changed)
        # beyond-reference: sampler selector (the reference is DDPM-only) —
        # measured recommendations per rung in BENCHMARKS.md; pair the
        # multistep solvers' few-step configs with trailing spacing
        self.sampler_combo = QComboBox()
        self.sampler_combo.addItems(["ddpm", "ddim", "dpm_solver",
                                     "dpm_solver_sde", "unipc"])
        self.sampler_combo.setCurrentText(self.generator.scheduler_kind)
        self.sampler_combo.currentIndexChanged.connect(self._on_sampler_changed)
        self.spacing_combo = QComboBox()
        self.spacing_combo.addItems(["leading", "trailing"])
        self.spacing_combo.setCurrentText(self.generator.timestep_spacing)
        self.spacing_combo.currentIndexChanged.connect(self._on_sampler_changed)
        grid.addWidget(QLabel("Checkpoints:"), 0, 0)
        grid.addWidget(self.ckpt_edit, 0, 1)
        grid.addWidget(ckpt_btn, 0, 2)
        grid.addWidget(QLabel("Output:"), 0, 3)
        grid.addWidget(self.out_edit, 0, 4)
        grid.addWidget(out_btn, 0, 5)
        grid.addWidget(QLabel("Device:"), 1, 0)
        grid.addWidget(self.device_combo, 1, 1)
        grid.addWidget(QLabel("Steps:"), 1, 2)
        grid.addWidget(self.steps_spin, 1, 3)
        grid.addWidget(QLabel("Seed:"), 1, 4)
        seed_row = QHBoxLayout()
        seed_row.addWidget(self.seed_mode)
        seed_row.addWidget(self.seed_spin)
        seed_holder = QWidget()
        seed_holder.setLayout(seed_row)
        grid.addWidget(seed_holder, 1, 5)
        grid.addWidget(self.xai_check, 2, 0)
        grid.addWidget(QLabel("XAI every N:"), 2, 1)
        grid.addWidget(self.xai_freq, 2, 2)
        grid.addWidget(QLabel("Variant:"), 2, 3)
        grid.addWidget(self.variant_combo, 2, 4)
        grid.addWidget(self.mem_label, 2, 5)
        grid.addWidget(QLabel("Family:"), 3, 0)
        grid.addWidget(self.family_combo, 3, 1)
        grid.addWidget(QLabel("CFG scale:"), 3, 2)
        grid.addWidget(self.guidance_spin, 3, 3)
        grid.addWidget(QLabel("Sampler:"), 3, 4)
        sampler_row = QHBoxLayout()
        sampler_row.addWidget(self.sampler_combo)
        sampler_row.addWidget(self.spacing_combo)
        sampler_holder = QWidget()
        sampler_holder.setLayout(sampler_row)
        grid.addWidget(sampler_holder, 3, 5)
        root.addWidget(top)

        split = QSplitter(Qt.Horizontal)

        # left: class selection
        left = QGroupBox("Classes")
        lv = QVBoxLayout(left)
        self.class_rows = {}
        for cls in self.class_names:
            row = QHBoxLayout()
            cb = QCheckBox(cls)
            count = QSpinBox()
            count.setRange(1, 100000)
            count.setValue(10)
            row.addWidget(cb)
            row.addWidget(count)
            holder = QWidget()
            holder.setLayout(row)
            lv.addWidget(holder)
            self.class_rows[cls] = (cb, count)
        lv.addStretch(1)
        split.addWidget(left)

        # center: preview + progress + buttons
        center = QWidget()
        cv = QVBoxLayout(center)
        self.preview = QLabel("preview")
        self.preview.setAlignment(Qt.AlignCenter)
        self.preview.setMinimumSize(420, 420)
        self.progress = QProgressBar()
        self.status_label = QLabel("idle")
        btns = QHBoxLayout()
        self.start_btn = QPushButton("Start generation")
        self.start_btn.clicked.connect(self.start_generation)
        self.stop_btn = QPushButton("Stop")
        self.stop_btn.clicked.connect(self.stop_generation)
        self.stop_btn.setEnabled(False)
        self.xai_btn = QPushButton("Standalone XAI")
        self.xai_btn.setToolTip("re-denoise the first checked class from "
                                "the fixed seed in a subprocess and run "
                                "the full analysis")
        self.xai_btn.clicked.connect(self.run_standalone_xai)
        btns.addWidget(self.start_btn)
        btns.addWidget(self.stop_btn)
        btns.addWidget(self.xai_btn)
        cv.addWidget(self.preview, 1)
        cv.addWidget(self.progress)
        cv.addWidget(self.status_label)
        cv.addLayout(btns)
        split.addWidget(center)

        # right: results browser — generated files + the XAI runs/files
        # two-list browser (reference `main.py:1624-1714`)
        right = QGroupBox("Results")
        rv = QVBoxLayout(right)
        rv.addWidget(QLabel("Generated images:"))
        self.files_list = QListWidget()
        self.files_list.itemClicked.connect(self._on_file_clicked)
        rv.addWidget(self.files_list, 1)
        rv.addWidget(QLabel("XAI runs:"))
        self.xai_runs_list = QListWidget()
        self.xai_runs_list.itemClicked.connect(self._on_xai_run_clicked)
        rv.addWidget(self.xai_runs_list, 1)
        rv.addWidget(QLabel("Run files:"))
        self.xai_files_list = QListWidget()
        self.xai_files_list.itemClicked.connect(self._on_xai_file_clicked)
        rv.addWidget(self.xai_files_list, 1)
        refresh_btn = QPushButton("Refresh")
        refresh_btn.clicked.connect(self.refresh_results)
        rv.addWidget(refresh_btn)
        split.addWidget(right)
        split.setSizes([220, 600, 320])
        root.addWidget(split, 1)

        # bottom: logs + system-configuration panel (reference :745-799)
        bottom = QHBoxLayout()
        logs_group = QGroupBox("System logs")
        lg = QVBoxLayout(logs_group)
        self.logs = QTextEdit()
        self.logs.setReadOnly(True)
        self.logs.setMaximumHeight(160)
        lg.addWidget(self.logs)
        bottom.addWidget(logs_group, 3)
        config_group = QGroupBox("System configuration")
        cg = QVBoxLayout(config_group)
        self.device_info_label = QLabel("Device: -")
        self.model_path_label = QLabel("Model path: -")
        self.available_models_label = QLabel("Available models: 0")
        self.color_config_label = QLabel("Color configuration: -")
        self.memory_info_label = QLabel("Memory: n/a")
        for lab in (self.device_info_label, self.model_path_label,
                    self.available_models_label, self.color_config_label,
                    self.memory_info_label):
            cg.addWidget(lab)
        bottom.addWidget(config_group, 2)
        root.addLayout(bottom)

        self.setCentralWidget(central)
        self.logs.append("interface initialized")

    # -- helpers ---------------------------------------------------------------
    def _pick_dir(self, edit: "QLineEdit"):
        path = QFileDialog.getExistingDirectory(self, "Select directory",
                                                edit.text())
        if path:
            edit.setText(path)

    def _refresh_classes(self):
        mm = self.generator.model_manager
        available = set(self.generator.get_available_classes())
        # class availability follows the ACTIVE variant: with 'distill8'
        # selected, a class that only has a 'best' checkpoint cannot
        # generate (load_model would fail) and must not look checkable
        if mm.conditional:
            # one shared checkpoint: its variant either exists for every
            # class in its metadata or for none
            usable = (available
                      if mm.variant in mm.available_variants("conditional")
                      else set())
        elif mm.variant != "best":
            usable = {c for c in available
                      if mm.variant in mm.available_variants(c)}
        else:
            usable = available
        for cls, (cb, _) in self.class_rows.items():
            cb.setEnabled(cls in usable)
            if cls not in usable:
                cb.setChecked(False)
                cb.setToolTip("no checkpoint found" if cls not in available
                              else f"no '{mm.variant}' checkpoint for this "
                                   f"class (variant set in the settings "
                                   f"panel)")
            else:
                # clear any stale unavailability message from a previous
                # variant selection
                cb.setToolTip("")
        self._refresh_variants(available)
        self._refresh_family()

    def _refresh_variants(self, available_classes):
        """Populate the variant combo with the union of checkpoint variants
        on disk ('best' always first; e.g. 'distill8' from progressive
        distillation). Guarded: real Qt fires currentIndexChanged during
        clear()/addItem(), which must not thrash mm.variant/unload."""
        mm = self.generator.model_manager
        variants = {"best"}
        if mm.conditional:
            # variants of the one shared checkpoint (unet_conditional_*.pth)
            variants.update(mm.available_variants("conditional"))
        else:
            for cls in available_classes:
                variants.update(mm.available_variants(cls))
        # epoch snapshots are training artifacts, not serving variants
        ordered = ["best"] + sorted(v for v in variants
                                    if v != "best"
                                    and not v.startswith("epoch"))
        current = mm.variant if mm.variant in ordered else "best"
        if current != mm.variant:
            # the active variant vanished from disk (e.g. the checkpoints
            # dir changed): reset the GENERATOR too, not just the display —
            # otherwise the UI shows 'best' while load_model keeps failing
            # on the stale variant
            if self.worker and self.worker.isRunning():
                # can't switch under a running generation; keep displaying
                # the variant that is actually active
                ordered.append(mm.variant)
                current = mm.variant
            else:
                self._append_log(f"model variant '{mm.variant}' not found "
                                 f"in the current checkpoints dir; reset "
                                 f"to 'best'", "warning")
                if mm.conditional:
                    # conditional metadata is per-variant — rebuild so the
                    # class mapping matches the checkpoint actually served
                    self._rebuild_generator(conditional=True)
                    return
                mm.variant = "best"
                mm.unload_all_models()
                # class availability was computed against the stale
                # variant — redo the whole refresh (terminates: 'best' is
                # always in `ordered` on the second pass)
                self._refresh_classes()
                return
        self._refreshing_variants = True
        try:
            self.variant_combo.clear()
            for v in ordered:
                self.variant_combo.addItem(v)
            self.variant_combo.setCurrentText(current)
        finally:
            self._refreshing_variants = False

    def _on_variant_changed(self, idx: int):
        if getattr(self, "_refreshing_variants", False):
            return
        mm = self.generator.model_manager
        if self.worker and self.worker.isRunning():
            # resync the combo so it never displays a variant that is not
            # actually active (the switch is refused mid-generation)
            self._refreshing_variants = True
            try:
                self.variant_combo.setCurrentText(mm.variant)
            finally:
                self._refreshing_variants = False
            self._append_log("cannot switch model variant while a "
                             "generation is running", "warning")
            return
        variant = self.variant_combo.currentText() or "best"
        if variant != mm.variant:
            if mm.conditional:
                # the conditional checkpoint's class metadata is read per
                # variant — rebuild the generator so the embedding-table
                # mapping always matches the active checkpoint
                self._rebuild_generator(conditional=True, variant=variant)
                return
            mm.variant = variant
            mm.unload_all_models()
            self._append_log(f"model variant set to {variant} "
                             f"(weights reload on next generation)")
            # class availability depends on the active variant
            self._refresh_classes()

    # -- model family (per-class vs conditional; beyond-reference) --------------
    def _conditional_available(self) -> bool:
        """A conditional checkpoint (+ its class metadata) is on disk."""
        ckpt = Path(self.ckpt_edit.text())
        return any(p.with_suffix(".json").exists()
                   for p in ckpt.glob("unet_conditional_*.pth"))

    def _refresh_family(self):
        """Populate the family combo: 'per-class' always; 'conditional'
        when the single class-conditional checkpoint exists. Guarded like
        the variant combo (real Qt fires currentIndexChanged on clear)."""
        current = ("conditional" if self.generator.model_manager.conditional
                   else "per-class")
        entries = ["per-class"]
        if self._conditional_available() or current == "conditional":
            entries.append("conditional")
        self._refreshing_family = True
        try:
            self.family_combo.clear()
            for e in entries:
                self.family_combo.addItem(e)
            self.family_combo.setCurrentText(current)
        finally:
            self._refreshing_family = False
        self.guidance_spin.setEnabled(current == "conditional")

    def _on_family_changed(self, idx: int):
        if getattr(self, "_refreshing_family", False):
            return
        mm = self.generator.model_manager
        want = self.family_combo.currentText() == "conditional"
        if want == mm.conditional:
            return
        if self.worker and self.worker.isRunning():
            self._refreshing_family = True
            try:
                self.family_combo.setCurrentText(
                    "conditional" if mm.conditional else "per-class")
            finally:
                self._refreshing_family = False
            self._append_log("cannot switch model family while a "
                             "generation is running", "warning")
            return
        self._rebuild_generator(conditional=want)

    def _on_guidance_changed(self, value):
        # the CFG weight is read per sampling call (create_sampler caches
        # per-(steps, ..., guidance) executables), so a live update is safe
        if self.generator.model_manager.conditional:
            self.generator.guidance_scale = float(value)

    def _on_sampler_changed(self, idx: int):
        # scheduler kind + spacing are read per sampling call (cached
        # per-key executables), so live updates are safe mid-session
        self.generator.scheduler_kind = self.sampler_combo.currentText() or "ddpm"
        self.generator.timestep_spacing = (self.spacing_combo.currentText()
                                           or "leading")

    def _rebuild_generator(self, conditional: bool, variant: str = "best"):
        """Swap the backing ImageGenerator (family or conditional-variant
        switch). Settings that live on the window (steps, seed, XAI) are
        re-applied at Start; the device/mesh selection is re-applied here."""
        from ..generator import ImageGenerator

        old = self.generator
        try:
            self.generator = ImageGenerator(
                config=self.config, checkpoints_dir=self.ckpt_edit.text(),
                device=old.model_manager.device, compute_dtype=self._compute_dtype,
                model_config=self._base_model_config,
                model_variant=variant, conditional=conditional,
                guidance_scale=(self.guidance_spin.value()
                                if conditional else 0.0))
        except Exception as exc:
            self.generator = old
            self._append_log(f"family switch failed: {exc}", "error")
            self._refresh_family()
            return
        old.model_manager.unload_all_models()
        self._append_log(
            f"model family -> {'conditional' if conditional else 'per-class'}"
            + (f" (CFG scale {self.guidance_spin.value():g})"
               if conditional else ""))
        # re-apply the device/mesh selection and the window's sampler
        # choice to the fresh generator (it booted on the config default)
        self._on_device_changed(self.device_combo.currentIndex())
        self._on_sampler_changed(0)
        self._refresh_classes()
        self._update_config_info()

    def _update_config_info(self):
        """System-configuration panel (reference `main.py:773-793`)."""
        idx = self.device_combo.currentIndex()
        dev = str(self._devices[idx]) if 0 <= idx < len(self._devices) else "-"
        self.device_info_label.setText(f"Device: {dev}")
        self.model_path_label.setText(f"Model path: {self.ckpt_edit.text()}")
        n = len(self.generator.get_available_classes())
        self.available_models_label.setText(f"Available models: {n}")
        has_stats = bool(getattr(self.generator, "color_statistics", None))
        self.color_config_label.setText(
            "Color configuration: loaded" if has_stats
            else "Color configuration: not found")

    def refresh_results(self):
        """Refresh both the generated-images list and the XAI browser."""
        self._refresh_files()
        self.update_xai_lists()
        self._update_config_info()

    def _refresh_files(self):
        self.files_list.clear()
        out = Path(self.out_edit.text())
        if out.exists():
            for p in sorted(out.rglob("*.png"))[:400]:
                self.files_list.addItem(str(p))

    # -- XAI results browser (reference `main.py:1624-1714`) --------------------
    def update_xai_lists(self):
        self.xai_runs_list.clear()
        self.xai_files_list.clear()
        base = Path(self._xai_results_dir)
        if not base.exists():
            return
        # runs = class/run directory leaves, newest first (the adapter writes
        # xai_results/<class>/<stem>_<seed>/)
        runs = [p for p in base.rglob("*") if p.is_dir()
                and not any(c.is_dir() for c in p.iterdir())]
        runs.sort(key=lambda p: p.stat().st_mtime, reverse=True)
        for run in runs[:200]:
            self.xai_runs_list.addItem(str(run.relative_to(base)))
        if runs:
            self.xai_runs_list.setCurrentRow(0)
            self._populate_run_files(runs[0])
        self.logs.append(f"XAI: {len(runs)} analysis runs found")

    def _populate_run_files(self, run_dir: Path):
        self.xai_files_list.clear()
        for f in sorted(run_dir.iterdir()):
            if f.is_file():
                self.xai_files_list.addItem(f.name)

    def _on_xai_run_clicked(self, item):
        self._populate_run_files(Path(self._xai_results_dir) / item.text())

    def _on_xai_file_clicked(self, item):
        run_item = self.xai_runs_list.currentItem()
        if run_item is None:
            return
        path = Path(self._xai_results_dir) / run_item.text() / item.text()
        lower = path.name.lower()
        try:
            if lower.endswith((".png", ".jpg", ".jpeg", ".bmp")):
                self.display_image(str(path), allow_overlay=False)
            elif lower.endswith(".json"):
                data = json.loads(path.read_text())
                self.show_text_dialog(f"JSON: {path.name}",
                                      json.dumps(data, indent=2)[:20000])
            elif lower.endswith((".pkl", ".pickle")):
                with open(path, "rb") as f:
                    obj = pickle.load(f)
                self.show_text_dialog(f"PKL: {path.name}",
                                      self._summarize_pickle(obj))
            else:
                self.logs.append(f"XAI: unsupported file type: {path.name}")
        except Exception as exc:
            self.logs.append(f"XAI: error opening {path.name}: {exc}")

    @staticmethod
    def _summarize_pickle(obj) -> str:
        """Safe PKL summary (reference `main.py:1692-1699`)."""
        if isinstance(obj, dict):
            keys = list(obj.keys())
            return f"Type: dict\nKeys ({len(keys)}):\n- " + \
                "\n- ".join(map(str, keys))
        return f"Type: {type(obj)}\nStr: {str(obj)[:2000]}"

    def show_text_dialog(self, title: str, content: str):
        dlg = QDialog(self)
        dlg.setWindowTitle(title)
        layout = QVBoxLayout(dlg)
        txt = QTextEdit()
        txt.setReadOnly(True)
        txt.setText(content)
        btn = QPushButton("Close")
        btn.clicked.connect(dlg.accept)
        layout.addWidget(txt)
        layout.addWidget(btn)
        dlg.resize(700, 500)
        self._last_dialog = dlg  # kept for tests/inspection
        dlg.exec_()

    # -- preview (+ XAI overlay, reference `main.py:890-966`) --------------------
    def _on_file_clicked(self, item):
        self.display_image(item.text(), allow_overlay=True)

    def display_image(self, image_path: str, allow_overlay: bool = True):
        """Show an image in the preview; with XAI mode on, show the
        attribution artifact for it instead (reference display_image's
        overlay path — ours resolves the already-saved artifact through
        `xai.integration.run_xai_analysis`)."""
        shown_path = image_path
        if allow_overlay and self.xai_check.isChecked():
            try:
                from ..xai.integration import run_xai_analysis
                _, artifact = run_xai_analysis(image_path)
                if artifact != image_path:
                    shown_path = artifact
                    self.logs.append(f"XAI overlay: {artifact}")
                else:
                    self.logs.append("XAI overlay not found; showing original")
            except Exception as exc:
                self.logs.append(f"XAI overlay failed ({exc}); showing original")
        pix = QPixmap(shown_path)
        if not pix.isNull():
            self.preview.setPixmap(pix.scaled(
                self.preview.size(), Qt.KeepAspectRatio,
                Qt.SmoothTransformation))
        self._preview_path = shown_path

    def _append_log(self, msg: str, level: str = "info"):
        self.logs.append(f"[{level}] {msg}")

    def _update_memory_info(self):
        from ..utils.profiling import device_memory_stats  # {} off CUDA

        idx = self.device_combo.currentIndex()
        # the "all devices (dp)" entry sits past the device list: show the
        # first device's stats (params replicate, usage is symmetric)
        dev = (self._devices[idx] if 0 <= idx < len(self._devices)
               else self._devices[0] if self._devices else None)
        stats = device_memory_stats(dev) if dev is not None else {}
        if stats.get("mb_in_use") is not None:
            text = (f"mem: {stats['mb_in_use']:.0f} MB "
                    f"(peak {stats.get('mb_peak', 0):.0f} MB)")
        else:
            text = "mem: n/a"
        self.mem_label.setText(text)
        self.memory_info_label.setText(text.replace("mem:", "Memory:"))

    def _on_device_changed(self, idx: int):
        if self.worker and self.worker.isRunning():
            return
        if idx == len(self._devices) and len(self._devices) > 1:
            # the "all devices (dp)" entry: mesh over every local device
            from ..parallel.mesh import create_mesh

            self.generator.set_mesh(create_mesh({"data": -1}, devices=self._devices))
            self._append_log(f"device -> dp mesh over "
                             f"{len(self._devices)} devices")
            self._update_config_info()
        elif 0 <= idx < len(self._devices):
            self.generator.set_mesh(None)
            ok = self.generator.model_manager.change_device(self._devices[idx])
            self._append_log(f"device -> {self._devices[idx]} "
                             f"({'ok' if ok else 'failed'})")
            self._update_config_info()

    # -- actions ---------------------------------------------------------------
    def start_generation(self):
        if self.worker is not None and self.worker.isRunning():
            return
        configs = [(cls, count.value())
                   for cls, (cb, count) in self.class_rows.items()
                   if cb.isChecked()]
        if not configs:
            self._append_log("select at least one class", "warning")
            return
        self.generator.set_inference_steps(self.steps_spin.value())
        if self.seed_mode.currentText() == "fixed":
            self.generator.set_generation_seed(self.seed_spin.value())
        else:
            self.generator.set_generation_seed(None)
        if self.xai_check.isChecked():
            from ..xai.integration import create_integrated_xai_analyzer
            self.generator.set_xai_analyzer(create_integrated_xai_analyzer(
                classifier_path=str(Path(self.ckpt_edit.text()) / "classifier.pth"),
                device=self.generator.model_manager.device))
            self.generator.set_xai_frequency(self.xai_freq.value())
        else:
            self.generator.set_xai_analyzer(None)

        self.worker = GenerationWorker(self.generator, configs,
                                       self.out_edit.text(), True)
        self.worker.progress.connect(self._on_progress)
        self.worker.log.connect(self._append_log)
        self.worker.finished_ok.connect(self._on_finished)
        self.start_btn.setEnabled(False)
        self.stop_btn.setEnabled(True)
        self.worker.start()

    def stop_generation(self):
        self.generator.stop_generation()
        if getattr(self, "_xai_worker", None) and self._xai_worker.isRunning():
            self._xai_worker.stop()

    def run_standalone_xai(self):
        """Launch the env-var-protocol XAI subprocess for the first
        checked class (reference XAI-queue path, `main.py:1552-1576`)."""
        checked = [cls for cls, (cb, _) in self.class_rows.items()
                   if cb.isChecked()]
        if not checked:
            self._append_log("select a class for standalone XAI", "warning")
            return
        # the window's device (the first one for the dp entry), its
        # checkpoints folder, and the folder its results browser reads
        idx = self.device_combo.currentIndex()
        device = self._devices[idx] if 0 <= idx < len(self._devices) else self._devices[0]
        extra = {"XAI_DEVICE": str(device),
                 "XAI_CHECKPOINTS_DIR": self.ckpt_edit.text(),
                 "XAI_RESULTS_DIR": self._xai_results_dir}
        if self.generator.model_manager.conditional:
            # the subprocess analyzes the same family the GUI serves
            extra.update(XAI_CONDITIONAL="1",
                         XAI_GUIDANCE_SCALE=str(self.guidance_spin.value()))
        self._xai_worker = XAIWorker(
            checked[0], self.seed_spin.value(), self.steps_spin.value(),
            extra_env=extra)
        self._xai_worker.log.connect(self._append_log)
        self._xai_worker.finished_ok.connect(
            lambda code: self._append_log(f"standalone XAI exited ({code})"))
        self._xai_worker.start()

    def _on_progress(self, done: int, total: int, msg: str):
        self.progress.setMaximum(total)
        self.progress.setValue(done)
        self.status_label.setText(msg)

    def _on_finished(self, result: dict):
        self.start_btn.setEnabled(True)
        self.stop_btn.setEnabled(False)
        self.status_label.setText(f"done: {result}")
        self.refresh_results()


def main() -> int:
    if not PYQT_AVAILABLE:
        print("PyQt5 is not installed; the GUI client requires it.\n"
              "Headless alternatives: `python -m synt_isic_tpu_torch.cli` for "
              "batch generation, `python -m synt_isic_tpu_torch.xai.standalone` "
              "for XAI.")
        return 1
    app = QApplication(sys.argv)
    win = SyntheticDataGeneratorWindow()
    win.show()
    return app.exec_()


if __name__ == "__main__":
    sys.exit(main())
