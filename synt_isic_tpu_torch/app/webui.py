"""Browser-based thin client over the generation engine, on a CUDA device.

The port of `synt_isic_tpu/app/webui.py`: the reference's PyQt5 desktop
window (`main.py:129-1759`) as a single-page app over stdlib HTTP, with the
same four panels (generation settings, class checkboxes with counts,
preview and progress, results and XAI browser, logs and system
configuration, `main.py:437-799`) and the device work in exactly one
background worker thread (the reference's GenerationWorker QThread,
`main.py:31-61`, as a `threading.Thread`).

Design notes
------------
* One ThreadingHTTPServer for the HTTP surface; handlers only read/append
  shared state under a lock and never touch the device. All sampling and
  model loading happens on the single worker thread, matching the
  reference's one-GenerationWorker-at-a-time rule (`main.py:1418-1419`).
* The page polls `/api/state` + `/api/logs` (the reference polls CUDA
  memory on a 2 s QTimer, `main.py:213-216`; the same telemetry rides the
  state poll here via `device_memory_stats`, PyTorch's caching allocator).
* File serving is sandboxed to the output and xai_results roots: the
  browser can only fetch artifacts the app itself produced.
* The standalone XAI subprocess path (reference `main.py:62-127` +
  env-var IPC `main.py:1552-1563`) is exposed as `POST /api/xai/run`
  (`python -m synt_isic_tpu_torch.xai.standalone` on the generator's
  device); its stdout streams into the same log buffer the page tails.

Run: ``python -m synt_isic_tpu_torch.app.webui --port 8976 --checkpoints
DIR`` (the card; ``--cpu`` for the CPU), then open http://127.0.0.1:8976/.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

__all__ = ["WebUIServer", "main"]

_TEXT_SUFFIXES = {".json", ".txt", ".csv", ".md", ".log"}
_IMAGE_TYPES = {".png": "image/png", ".jpg": "image/jpeg",
                ".jpeg": "image/jpeg"}


def _summarize_pickle(obj: Any, depth: int = 0) -> str:
    """Shallow structural summary of an artifact pickle (same viewer the
    Qt window exposes for `full_results.pkl`, reference `main.py:1694-1714`)."""
    pad = "  " * depth
    if isinstance(obj, dict):
        lines = [f"{pad}dict({len(obj)} keys)"]
        for k, v in list(obj.items())[:40]:
            lines.append(f"{pad}  {k!r}: " + _summarize_pickle(v, 0).strip())
        return "\n".join(lines)
    if isinstance(obj, (list, tuple)):
        head = f"{type(obj).__name__}(len={len(obj)})"
        if obj:
            head += " of " + _summarize_pickle(obj[0], 0).strip()
        return pad + head
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        return f"{pad}array{tuple(obj.shape)} {obj.dtype}"
    r = repr(obj)
    return pad + (r if len(r) <= 120 else r[:117] + "...")


class WebUIServer:
    """HTTP app wrapping one :class:`~synt_isic_tpu_torch.generator.ImageGenerator`.

    Owns the worker thread, the log ring buffer, and the progress state;
    the request handler delegates every route here.
    """

    def __init__(self, generator=None, config=None,
                 checkpoints_dir: Optional[str] = None,
                 output_dir: Optional[str] = None,
                 xai_results_dir: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0):
        from ..generator import ImageGenerator
        from ..utils.config import CLASS_NAMES, ConfigManager

        self.config = config or ConfigManager()
        self.generator = generator or ImageGenerator(
            config=self.config, checkpoints_dir=checkpoints_dir)
        self.class_names = list(CLASS_NAMES)
        self.checkpoints_dir = Path(
            checkpoints_dir
            or self.generator.model_manager.checkpoints_dir).resolve()
        self.output_dir = Path(output_dir or "generated_images").resolve()
        # integrated-XAI artifacts land next to the images they explain
        # (generator._save_xai_results / integration.analyze_trajectory both
        # derive `<output>/xai_results/<class>/...` from the image path)
        self.xai_results_dir = Path(
            xai_results_dir or self.output_dir / "xai_results").resolve()
        self.host, self.port = host, port

        self._lock = threading.Lock()
        self._logs: deque = deque(maxlen=500)   # (index, ts, level, msg)
        self._log_index = 0
        self._progress = {"done": 0, "total": 0, "message": ""}
        self._worker: Optional[threading.Thread] = None
        self._xai_proc: Optional[subprocess.Popen] = None
        self._last_result: Optional[Dict[str, Any]] = None
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._started = time.time()

        self.generator.set_log_callback(self._log)
        self.generator.set_progress_callback(self._on_progress)
        self._log(f"web UI ready (checkpoints={self.checkpoints_dir})")

    # -- shared-state plumbing (called from worker + handler threads) -------
    def _log(self, msg: str, level: str = "info") -> None:
        with self._lock:
            self._logs.append((self._log_index, time.time(), level, msg))
            self._log_index += 1

    def _on_progress(self, done: int, total: int, msg: str) -> None:
        with self._lock:
            self._progress = {"done": int(done), "total": int(total),
                              "message": str(msg)}

    @property
    def busy(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "WebUIServer":
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet; app log is the log
                pass

            def do_GET(self):
                app._route(self, "GET")

            def do_POST(self):
                app._route(self, "POST")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        t = threading.Thread(target=self._httpd.serve_forever,
                             name="webui-http", daemon=True)
        t.start()
        return self

    def stop(self) -> None:
        self.generator.stop_generation()
        if self._xai_proc and self._xai_proc.poll() is None:
            self._xai_proc.kill()
        if self._worker and self._worker.is_alive():
            self._worker.join(timeout=30)
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # -- routing ---------------------------------------------------------------
    def _route(self, h: BaseHTTPRequestHandler, method: str) -> None:
        url = urlparse(h.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        try:
            if method == "GET":
                if url.path in ("/", "/index.html"):
                    return self._send(h, 200, _PAGE.encode(),
                                      "text/html; charset=utf-8")
                if url.path == "/api/state":
                    return self._json(h, 200, self._state())
                if url.path == "/api/logs":
                    return self._json(h, 200,
                                      self._logs_since(int(q.get("since", 0))))
                if url.path == "/api/results":
                    return self._json(h, 200, self._results())
                if url.path == "/api/xai/runs":
                    return self._json(h, 200, self._xai_runs())
                if url.path == "/api/xai/files":
                    return self._json(h, 200, self._xai_files(q.get("run", "")))
                if url.path == "/api/file":
                    return self._file(h, q.get("path", ""))
                return self._json(h, 404, {"error": f"no route {url.path}"})
            # POST
            length = int(h.headers.get("Content-Length") or 0)
            body = json.loads(h.rfile.read(length) or b"{}") if length else {}
            if url.path == "/api/generate":
                code, resp = self._start_generation(body)
                return self._json(h, code, resp)
            if url.path == "/api/stop":
                self.generator.stop_generation()
                if self._xai_proc and self._xai_proc.poll() is None:
                    self._xai_proc.kill()
                    self._log("standalone XAI subprocess killed", "warning")
                return self._json(h, 200, {"ok": True})
            if url.path == "/api/xai/run":
                code, resp = self._start_standalone_xai(body)
                return self._json(h, code, resp)
            return self._json(h, 404, {"error": f"no route {url.path}"})
        except BrokenPipeError:
            pass
        except Exception as exc:  # surface handler bugs to the client+log
            self._log(f"handler error on {h.path}: {exc}", "error")
            try:
                self._json(h, 500, {"error": str(exc)})
            except Exception:
                pass

    @staticmethod
    def _send(h, code: int, payload: bytes, ctype: str) -> None:
        h.send_response(code)
        h.send_header("Content-Type", ctype)
        h.send_header("Content-Length", str(len(payload)))
        h.send_header("Cache-Control", "no-store")
        h.end_headers()
        h.wfile.write(payload)

    def _json(self, h, code: int, obj: Any) -> None:
        self._send(h, code, json.dumps(obj).encode(),
                   "application/json; charset=utf-8")

    # -- state / telemetry -------------------------------------------------------
    def _state(self) -> Dict[str, Any]:
        import torch

        from ..utils.profiling import device_memory_stats

        gen = self.generator
        mm = gen.model_manager
        # availability follows the ACTIVE variant (what load_model needs):
        # a distill-only checkpoint dir is fully usable with
        # --variant distillN even when no 'best' teacher file sits there
        if mm.conditional:
            available = set(gen.get_available_classes())
        else:
            available = {c for c in self.class_names
                         if mm.variant in mm.available_variants(c)}
        stats = device_memory_stats(mm.device) or {}
        with self._lock:
            progress = dict(self._progress)
            last = self._last_result
        cfg = self.config
        return {
            "classes": {c: c in available for c in self.class_names},
            "busy": self.busy,
            "xai_running": bool(self._xai_proc
                                and self._xai_proc.poll() is None),
            "progress": progress,
            "last_result": last,
            "device": str(mm.device),
            "n_devices": torch.cuda.device_count(),
            "mesh": dict(gen.mesh.shape) if gen.mesh is not None else None,
            "memory": {"mb_in_use": stats.get("mb_in_use"),
                       "mb_peak": stats.get("mb_peak")},
            "family": "conditional" if mm.conditional else "per-class",
            "variant": mm.variant,
            "scheduler": gen.scheduler_kind,
            "timestep_spacing": gen.timestep_spacing,
            "guidance": gen.guidance_scale,
            "steps": gen.inference_steps,
            "seed_mode": cfg.get_generation_param("seed_mode"),
            "seed_value": int(cfg.get_generation_param("seed_value")),
            "xai_frequency": int(cfg.get_generation_param("xai_frequency")),
            "checkpoints_dir": str(self.checkpoints_dir),
            "output_dir": str(self.output_dir),
            "xai_results_dir": str(self.xai_results_dir),
            "uptime_s": round(time.time() - self._started, 1),
            "config": {
                "image_size": cfg.get_generation_param("image_size"),
                "train_timesteps": cfg.get_generation_param("train_timesteps"),
                "batch_size": cfg.get("generation.batch_size", 1),
                "enable_color_postprocessing": cfg.get(
                    "advanced.enable_color_postprocessing", True),
            },
        }

    def _logs_since(self, since: int) -> Dict[str, Any]:
        with self._lock:
            entries = [[i, round(ts, 2), lvl, msg]
                       for (i, ts, lvl, msg) in self._logs if i >= since]
            nxt = self._log_index
        return {"entries": entries, "next": nxt}

    # -- generation --------------------------------------------------------------
    def _start_generation(self, body: Dict[str, Any]):
        if self.busy:
            return 409, {"error": "generation already running"}
        counts = {str(c): int(n) for c, n in (body.get("classes") or {}).items()
                  if int(n) > 0}
        configs = [(c, n) for c, n in counts.items()]
        if not configs:
            return 400, {"error": "select at least one class"}
        unknown = [c for c, _ in configs if c not in self.class_names]
        if unknown:
            return 400, {"error": f"unknown classes {unknown}"}
        gen = self.generator
        steps = int(body.get("steps") or gen.inference_steps)
        gen.set_inference_steps(steps)
        if body.get("seed_mode", "random") == "fixed":
            gen.set_generation_seed(int(body.get("seed", 42)))
        else:
            gen.set_generation_seed(None)
        if body.get("xai"):
            try:
                from ..xai.integration import create_integrated_xai_analyzer

                gen.set_xai_analyzer(create_integrated_xai_analyzer(
                    classifier_path=str(self.checkpoints_dir
                                        / "classifier.pth"),
                    device=gen.model_manager.device))
                gen.set_xai_frequency(int(body.get("xai_frequency", 1)))
            except Exception as exc:
                return 400, {"error": f"XAI analyzer unavailable: {exc}"}
        else:
            gen.set_xai_analyzer(None)
        postprocess = bool(body.get("postprocess", True))

        def work():
            try:
                result = gen.generate_images(configs, str(self.output_dir),
                                             postprocess=postprocess)
            except Exception as exc:
                self._log(f"generation failed: {exc}", "error")
                result = {"error": str(exc)}
            with self._lock:
                self._last_result = result

        self._worker = threading.Thread(target=work, name="webui-generate",
                                        daemon=True)
        self._worker.start()
        self._log(f"generation started: {counts} at {steps} steps")
        return 200, {"ok": True, "configs": configs, "steps": steps}

    def _start_standalone_xai(self, body: Dict[str, Any]):
        """Reference XAI-queue path: env-var protocol subprocess
        (`main.py:1552-1576`); stdout tees into the web log."""
        if self._xai_proc and self._xai_proc.poll() is None:
            return 409, {"error": "standalone XAI already running"}
        cls = body.get("class")
        if cls not in self.class_names:
            return 400, {"error": f"unknown class {cls!r}"}
        env = dict(
            os.environ,
            XAI_TARGET_CLASS=str(cls),
            XAI_GENERATION_SEED=str(int(body.get("seed", 42))),
            XAI_INFERENCE_STEPS=str(int(body.get("steps", 50))),
            XAI_SAVE_EVERY_N=str(int(body.get("save_every", 5))),
            XAI_CHECKPOINTS_DIR=str(self.checkpoints_dir),
            XAI_RESULTS_DIR=str(self.xai_results_dir),
            XAI_DEVICE=self.generator.model_manager.device.type,
            PYTHONUNBUFFERED="1", MPLBACKEND="Agg")
        if self.generator.model_manager.conditional:
            env["XAI_CONDITIONAL"] = "1"
            env["XAI_GUIDANCE_SCALE"] = str(self.generator.guidance_scale)
        self._xai_proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "synt_isic_tpu_torch.xai.standalone"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env)

        def pump(proc):
            for line in proc.stdout:
                self._log(f"[xai] {line.rstrip()}")
            self._log(f"standalone XAI exited ({proc.wait()})")

        threading.Thread(target=pump, args=(self._xai_proc,),
                         name="webui-xai-pump", daemon=True).start()
        self._log(f"standalone XAI started for {cls}")
        return 200, {"ok": True}

    # -- browsers ---------------------------------------------------------------
    def _results(self) -> Dict[str, Any]:
        files: List[Dict[str, Any]] = []
        if self.output_dir.is_dir():
            for p in self.output_dir.rglob("*"):
                if p.suffix.lower() in _IMAGE_TYPES and p.is_file():
                    st = p.stat()
                    entry = {"name": str(p.relative_to(self.output_dir)),
                             "path": str(p), "mtime": st.st_mtime,
                             "size": st.st_size}
                    sidecar = p.with_suffix(".json")
                    if sidecar.exists():
                        entry["sidecar"] = str(sidecar)
                    files.append(entry)
        files.sort(key=lambda e: e["mtime"], reverse=True)
        return {"files": files[:200]}

    def _xai_runs(self) -> Dict[str, Any]:
        runs = []
        if self.xai_results_dir.is_dir():
            for cls_dir in sorted(self.xai_results_dir.iterdir()):
                if not cls_dir.is_dir():
                    continue
                for run in sorted(cls_dir.iterdir()):
                    if run.is_dir():
                        runs.append({"class": cls_dir.name, "name": run.name,
                                     "path": str(run),
                                     "mtime": run.stat().st_mtime})
                    elif run.suffix == ".json":
                        # per-image integrated-XAI JSONs live flat under
                        # xai_results/<class>/ (reference
                        # `image_generator.py:866-886`)
                        runs.append({"class": cls_dir.name, "name": run.name,
                                     "path": str(run),
                                     "mtime": run.stat().st_mtime})
        runs.sort(key=lambda e: e["mtime"], reverse=True)
        return {"runs": runs[:200]}

    def _xai_files(self, run: str) -> Dict[str, Any]:
        p = self._sandboxed(run)
        if p is None:
            return {"files": [], "error": "path outside served roots"}
        if p.is_file():
            return {"files": [{"name": p.name, "path": str(p)}]}
        files = [{"name": f.name, "path": str(f)}
                 for f in sorted(p.iterdir()) if f.is_file()]
        return {"files": files}

    def _sandboxed(self, raw: str) -> Optional[Path]:
        """Resolve a client path; only artifacts under the output or
        xai_results roots are reachable."""
        if not raw:
            return None
        try:
            p = Path(raw).resolve()
        except OSError:
            return None
        for root in (self.output_dir, self.xai_results_dir):
            if p == root or p.is_relative_to(root):
                return p
        return None

    def _file(self, h, raw: str) -> None:
        p = self._sandboxed(raw)
        if p is None or not p.is_file():
            return self._json(h, 404, {"error": "not found or outside "
                                                "served roots"})
        suffix = p.suffix.lower()
        if suffix in _IMAGE_TYPES:
            return self._send(h, 200, p.read_bytes(), _IMAGE_TYPES[suffix])
        if suffix in _TEXT_SUFFIXES:
            return self._send(h, 200, p.read_bytes(),
                              "text/plain; charset=utf-8")
        if suffix == ".pkl":
            try:
                with open(p, "rb") as f:
                    summary = _summarize_pickle(pickle.load(f))
            except Exception as exc:
                summary = f"unreadable pickle: {exc}"
            return self._send(h, 200, summary.encode(),
                              "text/plain; charset=utf-8")
        return self._json(h, 415, {"error": f"unsupported type {suffix}"})


# -- the single-page app -------------------------------------------------------
_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>SYNT-ISIC</title>
<style>
 :root { --bg:#101418; --panel:#1a2027; --edge:#2c3640; --fg:#d8dee6;
         --dim:#8b98a5; --acc:#4da3ff; --ok:#41c98c; --warn:#e0b349;
         --err:#e06c75; }
 * { box-sizing:border-box; }
 body { margin:0; background:var(--bg); color:var(--fg);
        font:14px/1.45 system-ui,sans-serif; }
 header { display:flex; align-items:center; gap:16px; padding:10px 16px;
          background:var(--panel); border-bottom:1px solid var(--edge); }
 header h1 { font-size:16px; margin:0; }
 header .tag { color:var(--dim); font-size:12px; }
 main { display:grid; grid-template-columns: 230px 1fr 330px; gap:10px;
        padding:10px; }
 .panel { background:var(--panel); border:1px solid var(--edge);
          border-radius:8px; padding:10px; }
 .panel h2 { font-size:12px; text-transform:uppercase; letter-spacing:.08em;
             color:var(--dim); margin:0 0 8px; }
 .cls { display:flex; align-items:center; gap:6px; margin:4px 0; }
 .cls input[type=number] { width:64px; }
 .cls.off { opacity:.38; }
 .row { display:flex; align-items:center; gap:8px; margin:6px 0;
        flex-wrap:wrap; }
 .row label { color:var(--dim); font-size:12px; min-width:84px; }
 input,select,button { background:#141a20; color:var(--fg);
        border:1px solid var(--edge); border-radius:5px; padding:4px 8px; }
 button { cursor:pointer; }
 button.primary { background:var(--acc); color:#06121f; font-weight:600;
                  border:none; }
 button:disabled { opacity:.4; cursor:default; }
 #progressWrap { background:#0c1014; border-radius:5px; height:14px;
                 overflow:hidden; margin:8px 0; }
 #progressBar { height:100%; width:0; background:var(--ok);
                transition:width .4s; }
 #preview { width:100%; min-height:180px; background:#0c1014;
            border-radius:6px; display:flex; align-items:center;
            justify-content:center; }
 #preview img { max-width:100%; max-height:380px; image-rendering:pixelated; }
 ul.browse { list-style:none; margin:0; padding:0; max-height:180px;
             overflow:auto; font-size:12px; }
 ul.browse li { padding:2px 6px; border-radius:4px; cursor:pointer;
                white-space:nowrap; overflow:hidden; text-overflow:ellipsis; }
 ul.browse li:hover { background:#232c36; }
 ul.browse li.sel { background:#27415c; }
 #logs,#viewer { background:#0c1014; border-radius:6px; padding:8px;
        font:12px/1.5 ui-monospace,monospace; height:170px; overflow:auto;
        white-space:pre-wrap; word-break:break-all; }
 #viewer { height:220px; }
 .lvl-warning { color:var(--warn); } .lvl-error { color:var(--err); }
 footer { display:grid; grid-template-columns: 1fr 1fr; gap:10px;
          padding:0 10px 10px; }
 .kv { font-size:12px; color:var(--dim); }
 .kv b { color:var(--fg); font-weight:500; }
</style></head><body>
<header>
 <h1>SYNT-ISIC <span style="color:var(--acc)">GPU</span></h1>
 <span class="tag" id="deviceTag">device: …</span>
 <span class="tag" id="memTag">mem: n/a</span>
 <span class="tag" id="familyTag"></span>
 <span class="tag" id="stateTag"></span>
</header>
<main>
 <section class="panel">
  <h2>Classes</h2>
  <div id="classes"></div>
 </section>
 <section class="panel">
  <h2>Generation</h2>
  <div class="row"><label>steps</label>
    <input type="number" id="steps" min="1" max="1000" value="50">
   <label>seed</label>
   <select id="seedMode"><option>random</option><option>fixed</option></select>
   <input type="number" id="seedValue" min="0" value="42" style="width:90px">
  </div>
  <div class="row">
   <label>integrated XAI</label><input type="checkbox" id="xai">
   <label>frequency</label>
   <input type="number" id="xaiFreq" min="1" value="1" style="width:64px">
   <label>postprocess</label><input type="checkbox" id="postproc" checked>
  </div>
  <div class="row">
   <button class="primary" id="startBtn">Generate</button>
   <button id="stopBtn" disabled>Stop</button>
   <button id="xaiBtn">Standalone XAI</button>
   <span class="kv" id="progressText"></span>
  </div>
  <div id="progressWrap"><div id="progressBar"></div></div>
  <div id="preview"><span class="kv">preview</span></div>
 </section>
 <section class="panel">
  <h2>Results</h2>
  <ul class="browse" id="results"></ul>
  <h2 style="margin-top:10px">XAI runs</h2>
  <ul class="browse" id="xaiRuns"></ul>
  <h2 style="margin-top:10px">Run files</h2>
  <ul class="browse" id="xaiFiles"></ul>
 </section>
</main>
<footer>
 <section class="panel"><h2>Logs</h2><div id="logs"></div></section>
 <section class="panel"><h2>Viewer / system configuration</h2>
  <div id="viewer" class="kv">click a result, sidecar, or XAI artifact</div>
  <div class="kv" id="configLine" style="margin-top:6px"></div>
 </section>
</footer>
<script>
const $ = id => document.getElementById(id);
let logNext = 0, classesBuilt = false, selectedLi = null;

function buildClasses(av) {
  const host = $('classes'); host.innerHTML = '';
  for (const [cls, ok] of Object.entries(av)) {
    const div = document.createElement('div');
    div.className = 'cls' + (ok ? '' : ' off');
    div.innerHTML = `<input type="checkbox" data-cls="${cls}" ${ok?'':'disabled'}>
      <span style="width:56px">${cls}</span>
      <input type="number" min="1" value="1" data-count="${cls}" ${ok?'':'disabled'}>`;
    if (!ok) div.title = 'no checkpoint found';
    host.appendChild(div);
  }
  classesBuilt = true;
}

async function poll() {
  try {
    const s = await (await fetch('/api/state')).json();
    if (!classesBuilt) {
      buildClasses(s.classes);
      $('steps').value = s.steps; $('seedMode').value = s.seed_mode;
      $('seedValue').value = s.seed_value; $('xaiFreq').value = s.xai_frequency;
    }
    $('deviceTag').textContent = 'device: ' + s.device +
        (s.mesh ? ' (mesh ' + JSON.stringify(s.mesh) + ')' : '');
    $('memTag').textContent = s.memory.mb_in_use != null ?
        `mem: ${s.memory.mb_in_use} MB (peak ${s.memory.mb_peak})` : 'mem: n/a';
    $('familyTag').textContent = `${s.family} / ${s.variant} / ${s.scheduler}` +
        (s.guidance ? ` / cfg ${s.guidance}` : '');
    $('stateTag').textContent = s.busy ? 'GENERATING' :
        (s.xai_running ? 'XAI RUNNING' : 'idle');
    $('stateTag').style.color = s.busy || s.xai_running ?
        'var(--ok)' : 'var(--dim)';
    $('startBtn').disabled = s.busy; $('stopBtn').disabled = !s.busy &&
        !s.xai_running;
    const p = s.progress;
    $('progressBar').style.width = p.total ?
        (100 * p.done / p.total) + '%' : '0';
    $('progressText').textContent = p.total ?
        `${p.done}/${p.total} ${p.message}` : (p.message || '');
    $('configLine').textContent =
      `image_size ${s.config.image_size} · T ${s.config.train_timesteps} · ` +
      `spacing ${s.timestep_spacing} · batch ${s.config.batch_size} · ` +
      `ckpts ${s.checkpoints_dir} · out ${s.output_dir} · up ${s.uptime_s}s`;
  } catch (e) { $('stateTag').textContent = 'server unreachable'; }
  try {
    const l = await (await fetch('/api/logs?since=' + logNext)).json();
    if (l.entries.length) {
      const box = $('logs');
      for (const [i, ts, lvl, msg] of l.entries) {
        const d = document.createElement('div');
        d.className = 'lvl-' + lvl;
        d.textContent = `[${lvl}] ${msg}`;
        box.appendChild(d);
      }
      while (box.children.length > 400) box.removeChild(box.firstChild);
      box.scrollTop = box.scrollHeight;
      logNext = l.next;
    }
  } catch (e) {}
  refreshBrowsers();
}

let lastBrowse = 0;
async function refreshBrowsers(force) {
  if (!force && Date.now() - lastBrowse < 4000) return;
  lastBrowse = Date.now();
  const res = await (await fetch('/api/results')).json();
  fillList($('results'), res.files, f => f.name, f => () => {
    showImage(f.path);
    if (f.sidecar) showText(f.sidecar);
  });
  const runs = await (await fetch('/api/xai/runs')).json();
  fillList($('xaiRuns'), runs.runs, r => r.class + '/' + r.name,
           r => async () => {
    const files = await (await fetch('/api/xai/files?run=' +
        encodeURIComponent(r.path))).json();
    fillList($('xaiFiles'), files.files, f => f.name, f => () => {
      if (/\\.(png|jpe?g)$/i.test(f.name)) showImage(f.path);
      else showText(f.path);
    });
  });
}

function fillList(ul, items, labelFn, clickFn) {
  ul.innerHTML = '';
  for (const it of items) {
    const li = document.createElement('li');
    li.textContent = labelFn(it);
    li.onclick = () => { if (selectedLi) selectedLi.classList.remove('sel');
      li.classList.add('sel'); selectedLi = li; clickFn(it)(); };
    ul.appendChild(li);
  }
}

function showImage(path) {
  $('preview').innerHTML =
    `<img src="/api/file?path=${encodeURIComponent(path)}&t=${Date.now()}">`;
}
async function showText(path) {
  const r = await fetch('/api/file?path=' + encodeURIComponent(path));
  const text = await r.text();
  try { $('viewer').textContent = JSON.stringify(JSON.parse(text), null, 2); }
  catch (e) { $('viewer').textContent = text; }
}

function gatherClasses() {
  const out = {};
  document.querySelectorAll('#classes input[type=checkbox]').forEach(cb => {
    if (cb.checked) out[cb.dataset.cls] = parseInt(
      document.querySelector(`input[data-count="${cb.dataset.cls}"]`).value);
  });
  return out;
}

$('startBtn').onclick = async () => {
  const body = { classes: gatherClasses(),
    steps: parseInt($('steps').value), seed_mode: $('seedMode').value,
    seed: parseInt($('seedValue').value), xai: $('xai').checked,
    xai_frequency: parseInt($('xaiFreq').value),
    postprocess: $('postproc').checked };
  const r = await fetch('/api/generate', { method: 'POST',
    body: JSON.stringify(body) });
  if (!r.ok) alert((await r.json()).error);
};
$('stopBtn').onclick = () => fetch('/api/stop', { method: 'POST' });
$('xaiBtn').onclick = async () => {
  const checked = Object.keys(gatherClasses());
  if (!checked.length) return alert('select a class for standalone XAI');
  const r = await fetch('/api/xai/run', { method: 'POST',
    body: JSON.stringify({ class: checked[0],
      seed: parseInt($('seedValue').value),
      steps: parseInt($('steps').value) }) });
  if (!r.ok) alert((await r.json()).error);
};

poll(); setInterval(poll, 1500);
</script></body></html>
"""


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m synt_isic_tpu_torch.app.webui",
        description="Browser-based thin client for the SYNT-ISIC generator "
                    "on a CUDA device (the reference PyQt5 window, main.py, "
                    "as a web app)")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default loopback). WARNING: the "
                             "server has NO authentication: binding "
                             "0.0.0.0 gives anyone on the network full "
                             "generate/XAI/file-browse access; keep it on "
                             "loopback or behind an authenticating reverse "
                             "proxy / SSH tunnel")
    parser.add_argument("--port", type=int, default=8976)
    parser.add_argument("--checkpoints", default=None,
                        help="checkpoints dir (default: config paths)")
    parser.add_argument("--output", default="generated_images")
    parser.add_argument("--xai-results", default="xai_results")
    parser.add_argument("--conditional", action="store_true",
                        help="serve the single conditional checkpoint "
                             "instead of per-class models")
    parser.add_argument("--guidance", type=float, default=None,
                        help="CFG scale for --conditional")
    parser.add_argument("--guidance-map", default=None, metavar="SPEC",
                        help="per-class CFG weights for --conditional, "
                             "e.g. 'MEL=2.5,NV=2' (absent classes use "
                             "--guidance; weights <= 1 mean no guidance, "
                             "same as the scalar flag)")
    parser.add_argument("--variant", default="best",
                        help="checkpoint variant (best/distill8/...)")
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (the attention kernel's plain "
                             "version) and leave the card free, e.g. to "
                             "browse artifacts while training owns it")
    args = parser.parse_args(argv)

    from ..generator import ImageGenerator, parse_guidance_map
    from ..utils.config import ConfigManager

    config = ConfigManager()
    generator = ImageGenerator(
        config=config, checkpoints_dir=args.checkpoints,
        device="cpu" if args.cpu else "cuda",
        model_variant=args.variant,
        conditional=True if args.conditional else None,
        guidance_scale=args.guidance,
        guidance_map=parse_guidance_map(args.guidance_map))
    app = WebUIServer(generator=generator, config=config,
                      checkpoints_dir=args.checkpoints,
                      output_dir=args.output,
                      xai_results_dir=args.xai_results,
                      host=args.host, port=args.port).start()
    print(f"SYNT-ISIC web UI: http://{app.host}:{app.port}/ "
          f"({generator.model_manager.device})", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        app.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
