"""Long-lived generation service: models stay hot, requests get batched.

The port of `synt_isic_tpu/serve.py`. The daemon keeps an `ImageGenerator`
resident on a CUDA device (loaded weights, built kernels, cached samplers)
and serves a newline-delimited JSON protocol over TCP, with the JAX
daemon's requests and reply keys, so its clients work unchanged:

  {"op": "classes"}                          -> {"ok": true, "classes": [..]}
  {"op": "status"}                           -> {"ok": true, ...queue/stats}
  {"op": "warmup", "class": "NV",
   "compile": true?, "steps": 50?}           -> load weights; compile:true
                                                also builds the kernels and
                                                runs one b1 walk and one
                                                device-batch walk, so no
                                                client pays the first call
  {"op": "generate", "class": "NV", "count": 4,
   "seed": 42?, "steps": 50?, "output_dir": "..."?,
   "postprocess": true?, "xai": false?,
   "fast": false?}                           -> {"ok": true, "files": [..],
                                                 "output_dir", "elapsed_s",
                                                 "xai_dir"?, "fast_variant"?}
   ("fast": true samples the server's fast lane (--fast-variant, a
    distilled checkpoint variant, or --fast-scheduler, a few-step solver on
    the same weights) on the priority lane, capped at max_batch images)
  {"op": "shutdown"}                         -> {"ok": true}

Execution model: connection threads only parse and enqueue; ONE worker
thread owns the device. At dequeue time the worker coalesces queued
requests that share (class, steps, postprocess, xai, output_dir) and let
the server draw seeds (seed=None) into one device batch; each image's
recorded seed keeps it reproducible however requests were merged. A
`--conditional` server coalesces across classes too: the one
class-conditional model takes a label per image, so a burst of
different-class requests becomes one mixed-class device batch.

Priority: requests whose device cost (count x steps) is at most
`interactive_cost` ride a fast lane serviced ahead of queued bulk work, and
a running bulk job yields to them between its device blocks (the
generator's between-blocks hook); replies served that way carry
`"interactive": true`. `status` reports `latency` / `interactive_latency`
({p50_ms, p95_ms, n}), `fast_lane_depth` and `throughput_img_s`.

Multi-device: `--mesh N|auto` (reference `serve.py:758, 879-881`) shards
every device batch over a data-parallel mesh (`parallel.apply_dp_mesh`,
`ShardedSampler`, one walk per shard on its card): per-seed noise streams
keep each image the single-device image, the device batch is rounded up to
a multiple of the mesh, `status` reports the mesh, the warmup walks the
sharded sampler and `"xai": true` requests fan their attribution over the
same mesh. A `DxT` spec builds a {'data': D, 'model': T} mesh: each data
shard walks on its row of T devices with the UNet channel-sharded over it
and attention run by heads (`parallel/tensor_parallel.py`), the device
batch is rounded up by D only, and `status` reports both axes; a spec that
is not N, auto or DxT exits 2. The fast lane stays on one device: it
serves images one by one.

Where the port differs: `--device {cuda,cpu}` (the card by default; no
silent drop to the CPU; with `cpu` a mesh is N repeats of the CPU device),
and `--dtype` maps to torch.bfloat16 / torch.float32.
"""
from __future__ import annotations

import argparse
import json
import queue
import socket
import socketserver
import threading
import time
import uuid
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _snapshot_keys(d: Dict[str, Any]) -> List[str]:
    """Sorted key snapshot of a dict another thread may be inserting into
    (the worker loads models while connection threads serve `status`)."""
    for _ in range(8):
        try:
            return sorted(d)
        except RuntimeError:  # "dictionary changed size during iteration"
            continue
    return []


class _Request:
    __slots__ = ("payload", "event", "response", "cancelled", "t_enqueue")

    def __init__(self, payload: Dict[str, Any]):
        self.payload = payload
        self.event = threading.Event()
        self.response: Dict[str, Any] = {}
        # set when the waiting client gave up (timeout/disconnect); the
        # worker drops cancelled requests instead of generating orphans
        self.cancelled = False
        self.t_enqueue = time.time()


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _coalesce_key(payload: Dict[str, Any],
                  ignore_class: bool = False) -> Optional[Tuple]:
    """Requests merge iff they are generates for the same sampler and
    artifact location AND let the server draw seeds: a fixed client seed
    pins image indices, so such requests never merge. Fast-lane requests
    run one by one on the fast generator.

    `ignore_class=True` (conditional serving): the one class-conditional
    model takes per-image labels, so requests for different classes share
    a device batch too."""
    if payload.get("op") != "generate" or payload.get("seed") is not None:
        return None
    if payload.get("fast"):
        return None
    return (None if ignore_class else payload["class"],
            payload.get("steps"),
            bool(payload.get("postprocess", True)),
            bool(payload.get("xai", False)),
            payload.get("output_dir"))


def drain_batch(q: "queue.Queue[_Request]", first: _Request,
                max_batch: int,
                backlog: Optional["deque[_Request]"] = None,
                fast: Optional["deque[_Request]"] = None,
                classify=None, ignore_class: bool = False) -> List[_Request]:
    """Greedily pull queued requests coalescible with `first` (no waiting).

    Non-matching requests land in `backlog`, a worker-owned deque serviced
    BEFORE new queue items, so a request skipped during a drain keeps its
    place at the front instead of being re-queued behind later arrivals.
    `fast` is the interactive lane: scanned for matches too; when
    `classify(payload)` is given, non-matching pulls from `q` that classify
    as interactive are diverted into `fast` instead of `backlog`."""
    if backlog is None:
        backlog = deque()
    batch = [first]
    key = _coalesce_key(first.payload, ignore_class)
    if key is None:
        return batch
    total = int(first.payload.get("count", 1))
    # the worker-owned lanes first: they hold the oldest requests
    for lane in (fast, backlog):
        if lane is None:
            continue
        for r in list(lane):
            if total >= max_batch:
                break
            if r.cancelled:
                lane.remove(r)
                continue
            n = int(r.payload.get("count", 1))
            if _coalesce_key(r.payload, ignore_class) == key and total + n <= max_batch:
                lane.remove(r)
                batch.append(r)
                total += n
    while total < max_batch:
        try:
            nxt = q.get_nowait()
        except queue.Empty:
            break
        if nxt is None or nxt.cancelled:
            continue
        n = int(nxt.payload.get("count", 1))
        if _coalesce_key(nxt.payload, ignore_class) == key and total + n <= max_batch:
            batch.append(nxt)
            total += n
        elif fast is not None and classify is not None and classify(nxt.payload):
            fast.append(nxt)
        else:
            backlog.append(nxt)
    return batch


class GenerationServer:
    """TCP front + single device-owning worker around an ImageGenerator."""

    def __init__(self, generator, host: str = "127.0.0.1", port: int = 0,
                 output_root: str = "serve_output", max_batch: int = 64,
                 xai_analyzer_factory=None, interactive_cost: int = 256,
                 fast_generator=None):
        self.generator = generator
        # the fast-preview lane: a second ImageGenerator on the same device
        # (worker-serialised), a distilled variant at its few-step setting
        # or the same weights with a few-step solver; explicit opt-in only
        self.fast_generator = fast_generator
        self.output_root = Path(output_root)
        self.max_batch = max_batch
        self._default_steps = generator.inference_steps
        # requests whose device cost (count x steps) is at most this many
        # step-images ride the fast lane, ahead of queued bulk work
        self.interactive_cost = int(interactive_cost)
        # "xai": true requests run the integrated pipeline on each served
        # image's trajectory; the analyzer is built once, lazily
        self._xai_factory = xai_analyzer_factory
        self._xai_analyzer = None
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._backlog: "deque[_Request]" = deque()  # worker-owned, bulk FIFO
        self._fast: "deque[_Request]" = deque()     # worker-owned, priority
        self._stop = threading.Event()
        self._served = 0
        self._t0 = time.time()
        # completed-request latencies (enqueue -> reply), bounded; the
        # worker appends while `status` connection threads sort
        self._lat_lock = threading.Lock()
        self._lat_all: "deque[float]" = deque(maxlen=1024)
        self._lat_interactive: "deque[float]" = deque(maxlen=1024)

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    line = raw.decode("utf-8").strip()
                    if not line:
                        continue
                    try:
                        payload = json.loads(line)
                    except json.JSONDecodeError as exc:
                        self._reply({"ok": False, "error": f"bad json: {exc}"})
                        continue
                    self._reply(outer._dispatch(payload))
                    if payload.get("op") == "shutdown":
                        return

            def _reply(self, obj):
                self.wfile.write((json.dumps(obj) + "\n").encode("utf-8"))
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._worker = threading.Thread(target=self._work_loop,
                                        name="serve-worker", daemon=True)
        self._accept = threading.Thread(target=self._server.serve_forever,
                                        name="serve-accept", daemon=True)
        # priority within a long bulk run: the generator calls back between
        # device blocks (same worker thread), so interactive requests run
        # mid-run instead of behind the whole job
        generator.between_blocks_hook = self._service_fast_lane

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GenerationServer":
        self._worker.start()
        self._accept.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)  # wake the worker
        # shutdown() blocks until a running serve_forever() exits: on a
        # server that was never started it would wait forever
        if self._accept.is_alive():
            self._server.shutdown()
        self._server.server_close()
        if self._worker.is_alive():
            self._worker.join(timeout=30)

    def serve_forever(self) -> None:
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- request handling --------------------------------------------------
    def _dispatch(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        op = payload.get("op")
        if op == "classes":
            return {"ok": True,
                    "classes": self.generator.get_available_classes()}
        if op == "status":
            return {"ok": True,
                    "queue_depth": (self._queue.qsize() + len(self._backlog)
                                    + len(self._fast)),
                    "fast_lane_depth": len(self._fast),
                    "served_images": self._served,
                    "uptime_s": round(time.time() - self._t0, 1),
                    "throughput_img_s": round(
                        self._served / max(time.time() - self._t0, 1e-9), 2),
                    "latency": self._lat_stats(self._lat_all),
                    "interactive_latency": self._lat_stats(
                        self._lat_interactive),
                    "interactive_cost": self.interactive_cost,
                    "classes": self.generator.get_available_classes(),
                    "loaded_models": _snapshot_keys(
                        self.generator.model_manager.loaded_models),
                    "device_batch": self.generator.batch_size,
                    "mesh": (dict(self.generator.mesh.shape)
                             if self.generator.mesh is not None else None),
                    "max_batch": self.max_batch,
                    "default_steps": self._default_steps,
                    "fast_variant": (
                        None if self.fast_generator is None else {
                            "variant": self.fast_generator.model_manager.variant,
                            "steps": self.fast_generator.inference_steps,
                            "timestep_spacing":
                                self.fast_generator.timestep_spacing}),
                    "generator": self.generator.get_generation_status()}
        if op == "shutdown":
            threading.Thread(target=self.stop, daemon=True).start()
            return {"ok": True, "shutting_down": True}
        if op in ("generate", "warmup"):
            if self._stop.is_set():
                return {"ok": False, "error": "server shutting down"}
            if "class" not in payload:
                return {"ok": False, "error": "missing 'class'"}
            cls = payload["class"]
            if cls not in self.generator.get_available_classes():
                return {"ok": False, "error": f"unknown class {cls!r}"}
            req = _Request(payload)
            self._queue.put(req)
            # generation blocks the calling connection thread, not the server
            if not req.event.wait(timeout=float(payload.get("timeout_s", 3600))):
                req.cancelled = True  # the worker drops it if not yet started
                return {"ok": False, "error": "timed out waiting for worker"}
            return req.response
        return {"ok": False, "error": f"unknown op {op!r}"}

    # -- worker ------------------------------------------------------------
    def _is_interactive(self, payload: Dict[str, Any]) -> bool:
        """Fast-lane test: device cost (count x steps) within budget.
        Plain warmups are interactive (one load); a warmup with
        `"compile": true` builds the kernels and runs two walks, which must
        not run in the between-blocks lane ahead of queued b1 previews."""
        if payload.get("op") == "warmup":
            return not payload.get("compile")
        if payload.get("fast"):
            return True   # explicit preview opt-in (count capped when served)
        steps = int(payload.get("steps") or self._default_steps)
        return int(payload.get("count", 1)) * steps <= self.interactive_cost

    def _pump(self, block: bool) -> bool:
        """Move socket-thread arrivals from the queue into the worker-owned
        lanes (fast/bulk). Returns False when the shutdown sentinel was
        seen."""
        alive = True
        try:
            r = self._queue.get(block=block)
        except queue.Empty:
            return alive
        while True:
            if r is None:
                alive = False
            elif not r.cancelled:
                (self._fast if self._is_interactive(r.payload)
                 else self._backlog).append(r)
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return alive

    def _next_request(self) -> Optional[_Request]:
        """Oldest pending request, fast lane strictly first; backlog (bulk
        arrivals + drain skips) before anything newly queued."""
        alive = self._pump(block=False)
        while True:
            for lane in (self._fast, self._backlog):
                while lane:
                    r = lane.popleft()
                    if not r.cancelled:
                        return r
            if not alive or self._stop.is_set():
                return None
            alive = self._pump(block=True)

    def _work_loop(self) -> None:
        try:
            while not self._stop.is_set():
                req = self._next_request()
                if req is None:
                    break
                batch = drain_batch(self._queue, req, self.max_batch,
                                    self._backlog, fast=self._fast,
                                    classify=self._is_interactive,
                                    # conditional serving: one model, a
                                    # label per image, classes share a batch
                                    ignore_class=self.generator
                                    .model_manager.conditional)
                try:
                    self._run_batch(batch)
                except Exception as exc:  # a failed batch must not kill the worker
                    for r in batch:
                        self._finish(r, {"ok": False, "error": str(exc)})
        finally:
            # shutdown: every pending request gets a reply, so no blocked
            # connection thread waits for its timeout_s
            pending = list(self._fast) + list(self._backlog)
            self._fast.clear()
            self._backlog.clear()
            while True:
                try:
                    r = self._queue.get_nowait()
                except queue.Empty:
                    break
                if r is not None:
                    pending.append(r)
            for r in pending:
                if not r.event.is_set():
                    r.response = {"ok": False, "error": "server shutting down"}
                    r.event.set()

    # -- mid-run interactive service ---------------------------------------
    def _service_fast_lane(self) -> None:
        """Between-blocks callback (worker thread, inside a bulk
        `generate_images` run): pump arrivals and serve every pending
        interactive request now through the single-image path."""
        self._pump(block=False)
        while self._fast and not self._stop.is_set():
            req = self._fast.popleft()
            if req.cancelled:
                continue
            try:
                self._run_interactive(req)
            except Exception as exc:  # reported to its client; the bulk run goes on
                self._finish(req, {"ok": False, "error": str(exc)})

    def _run_interactive(self, req: _Request) -> None:
        """Serve one interactive request through `generate_single_image`,
        saving and restoring every generator knob so a surrounding bulk run
        continues unchanged. Same thread: one device owner."""
        from .generator import class_seed_offset
        from .io.csv_io import append_synthetic_row, initialize_synthetic_csv

        p = req.payload
        if p.get("op") == "warmup":
            self._finish(req, self._do_warmup(p))
            return
        use_fast = bool(p.get("fast"))
        if use_fast and self.fast_generator is None:
            self._finish(req, {"ok": False, "error":
                               "no fast variant configured (start the "
                               "server with --fast-variant or --fast-scheduler)"})
            return
        if (use_fast and p.get("steps")
                and int(p["steps"]) != self.fast_generator.inference_steps):
            # the fast lane runs its own step count: refuse, never substitute
            self._finish(req, {"ok": False, "error":
                               f"fast previews run at the fast variant's "
                               f"step count "
                               f"({self.fast_generator.inference_steps}); "
                               f"omit 'steps' or drop 'fast'"})
            return
        if use_fast and int(p.get("count", 1)) > self.max_batch:
            self._finish(req, {"ok": False, "error":
                               f"fast previews are capped at max_batch="
                               f"{self.max_batch} images per request"})
            return
        g = self.fast_generator if use_fast else self.generator
        saved = (g.inference_steps, g.base_seed, g.save_trajectory,
                 g.xai_analyzer, g.xai_frequency)
        try:
            cls = p["class"]
            count = int(p.get("count", 1))
            if not use_fast:
                g.set_inference_steps(
                    int(p["steps"]) if p.get("steps") else self._default_steps)
            want_xai = bool(p.get("xai"))
            analyzer = self._get_xai_analyzer() if want_xai else None
            g.save_trajectory = want_xai
            out_dir = Path(p.get("output_dir") or
                           (self.output_root / f"req_{uuid.uuid4().hex[:12]}"))
            class_dir = out_dir / cls
            if class_dir.exists() and any(class_dir.glob("ISIC_*.png")):
                self._finish(req, {"ok": False, "error":
                                   f"output_dir {out_dir} already holds "
                                   f"generated {cls} images; use a fresh "
                                   f"directory"})
                return
            class_dir.mkdir(parents=True, exist_ok=True)
            csv_path = out_dir / "synthetic_dataset.csv"
            initialize_synthetic_csv(csv_path)
            t0 = time.time()
            files: List[str] = []
            xai_error: Optional[str] = None
            for i in range(count):
                # numbered from 1, as the bulk path numbers them
                fname = g.path_manager.get_isic_filename(i + 1)
                path = class_dir / fname
                seed = (None if p.get("seed") is None else
                        (int(p["seed"]) + class_seed_offset(cls) + i)
                        & 0x7FFFFFFF)
                ok, traj = g.generate_single_image(
                    cls, str(path), postprocess=bool(p.get("postprocess", True)),
                    seed=seed)
                if not ok:
                    break
                files.append(str(path))
                append_synthetic_row(csv_path, {
                    "filename": fname, "class": cls, "isic_number": i + 1,
                    "source": "synthetic",
                    "generated_at": str(path.stat().st_mtime)})
                if want_xai and analyzer is not None and traj is not None:
                    try:
                        recorded = json.loads(
                            path.with_suffix(".json").read_text())["seed"]
                        analyzer.analyze_trajectory(
                            trajectory=traj, class_name=cls, seed=recorded,
                            inference_steps=g.inference_steps,
                            filename=fname, file_path=str(path))
                    except Exception as exc:  # reported in the reply; generation goes on
                        xai_error = f"{type(exc).__name__}: {exc}"
            self._served += len(files)
            response: Dict[str, Any] = {
                "ok": len(files) == count, "class": cls, "files": files,
                "output_dir": str(out_dir), "coalesced": 1,
                "interactive": True,
                "elapsed_s": round(time.time() - t0, 3)}
            if use_fast:
                response["fast_variant"] = g.model_manager.variant
                response["fast_steps"] = g.inference_steps
            if want_xai:
                xd = out_dir / "xai_results" / cls
                response["xai_dir"] = str(xd) if xd.exists() else None
                if xai_error is not None:
                    response["xai_error"] = xai_error
                elif response["xai_dir"] is None:
                    response["xai_error"] = ("XAI produced no artifacts "
                                             "(see server logs)")
            if len(files) != count:
                response["error"] = f"partial generation: {len(files)}/{count}"
            self._finish(req, response)
        finally:
            (g.inference_steps, g.base_seed, g.save_trajectory,
             g.xai_analyzer, g.xai_frequency) = saved

    def _do_warmup(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """`warmup` op body: load the class's weights; with `"compile":
        true` also build the hand-written kernels (and the XAI host
        library) if they are not built yet and run one b1 walk and one
        device-batch walk through the sampler the generate path uses (its
        steps, scheduler, spacing and guidance), so the first real request
        pays no build and no first call."""
        g = self.generator
        if payload.get("fast"):
            if self.fast_generator is None:
                return {"ok": False, "error": "no fast variant configured"}
            g = self.fast_generator
        t0 = time.time()
        cls = payload["class"]
        mm = g.model_manager
        model = mm.loaded_models.get(cls) if mm.load_model(cls) else None
        resp: Dict[str, Any] = {"ok": model is not None}
        if resp["ok"] and payload.get("compile"):
            from . import native as host_native
            from .ops import attention
            from .ops import native

            steps = int(payload.get("steps")
                        or (g.inference_steps if payload.get("fast")
                            else self._default_steps))
            if mm.use_fused_attention:
                native.build([attention.KERNEL])
            host_native.lib()
            # over the mesh when one is set: the walk the generate path runs
            sampler = g.block_sampler(steps)
            if g.mesh is not None:
                resp["mesh"] = dict(g.mesh.shape)
            labels = mm.class_id(cls) if mm.conditional else None
            sizes = sorted({1, int(g.batch_size)})
            for b in sizes:
                sampler.sample(model, np.arange(b, dtype=np.uint32), class_labels=labels)
            if mm.device.type == "cuda":
                torch.cuda.synchronize(mm.device)
            resp["compiled_batches"] = sizes
            resp["steps"] = steps
        resp["elapsed_s"] = round(time.time() - t0, 3)
        return resp

    def _get_xai_analyzer(self):
        if self._xai_analyzer is None:
            if self._xai_factory is not None:
                self._xai_analyzer = self._xai_factory()
            else:
                from .xai.integration import create_integrated_xai_analyzer

                # the classifier on the generator's device; a mesh-backed
                # server fans the attribution batches over the same mesh
                self._xai_analyzer = create_integrated_xai_analyzer(
                    device=self.generator.model_manager.device,
                    mesh=self.generator.mesh)
        return self._xai_analyzer

    def _finish(self, r: _Request, response: Dict[str, Any]) -> None:
        """Set the reply and record the end-to-end latency."""
        r.response = response
        lat = time.time() - r.t_enqueue
        with self._lat_lock:
            self._lat_all.append(lat)
            if self._is_interactive(r.payload):
                self._lat_interactive.append(lat)
        r.event.set()

    def _lat_stats(self, lats: "deque[float]") -> Dict[str, Any]:
        with self._lat_lock:
            vals = sorted(lats)
        return {"p50_ms": round(_percentile(vals, 0.50) * 1e3, 1),
                "p95_ms": round(_percentile(vals, 0.95) * 1e3, 1),
                "n": len(vals)}

    def _run_batch(self, batch: List[_Request]) -> None:
        head = batch[0].payload
        if head.get("op") == "warmup":
            self._finish(batch[0], self._do_warmup(head))
            return
        if head.get("fast"):
            # fast previews never coalesce and run on the fast generator
            self._run_interactive(batch[0])
            return

        # per-request steps must not leak into later requests that omit it
        self.generator.set_inference_steps(
            int(head["steps"]) if head.get("steps") else self._default_steps)
        self.generator.set_generation_seed(
            int(head["seed"]) if head.get("seed") is not None else None)
        if head.get("xai"):
            self.generator.set_xai_analyzer(self._get_xai_analyzer())
            self.generator.set_xai_frequency(1)
        else:
            self.generator.set_xai_analyzer(None)
        out_dir = Path(head.get("output_dir") or
                       (self.output_root / f"req_{uuid.uuid4().hex[:12]}"))
        # one (class, count) entry per request, in order; a conditional
        # server's list spans classes and becomes mixed-class blocks
        configs = [(r.payload["class"], int(r.payload.get("count", 1)))
                   for r in batch]

        # images are numbered from ISIC_0000001 per run: a reused
        # output_dir would overwrite images served to an earlier client
        for c in dict.fromkeys(c for c, _ in configs):
            class_dir = out_dir / c
            if class_dir.exists() and any(class_dir.glob("ISIC_*.png")):
                for r in batch:
                    self._finish(r, {"ok": False, "error":
                                     f"output_dir {out_dir} already holds generated "
                                     f"{c} images; use a fresh directory (or omit "
                                     f"output_dir for an auto-created one)"})
                return
        t0 = time.time()
        result = self.generator.generate_images(
            configs, str(out_dir),
            postprocess=bool(head.get("postprocess", True)))
        elapsed = time.time() - t0
        if "error" in result:
            for r in batch:
                self._finish(r, {"ok": False, "error": result["error"]})
            return
        self._served += result.get("generated", 0)
        # files split across the coalesced requests in order: the
        # generator numbers each class's images on across repeated
        # entries, so each request's slice is known; a stopped run
        # short-changes the tail requests, which get ok:false
        next_num: Dict[str, int] = {}
        for r in batch:
            r_cls = r.payload["class"]
            n = int(r.payload.get("count", 1))
            start = next_num.get(r_cls, 1)
            next_num[r_cls] = start + n
            files = [str(out_dir / r_cls / f"ISIC_{i:07d}.png")
                     for i in range(start, start + n)
                     if (out_dir / r_cls / f"ISIC_{i:07d}.png").exists()]
            complete = len(files) == n
            response = {"ok": complete, "class": r_cls,
                        "files": files,
                        "output_dir": str(out_dir),
                        "coalesced": len(batch),
                        "elapsed_s": round(elapsed, 3)}
            if head.get("xai"):
                # a failed analysis is logged and generation goes on: say
                # so when no artifacts were written
                xd = out_dir / "xai_results" / r_cls
                if xd.exists():
                    response["xai_dir"] = str(xd)
                else:
                    response["xai_dir"] = None
                    response["xai_error"] = ("XAI produced no artifacts "
                                             "(see server logs)")
            if not complete:
                response["error"] = (
                    f"partial generation: {len(files)}/{n} images "
                    f"(stopped={result.get('stopped', False)})")
            self._finish(r, response)


def request(host: str, port: int, payload: Dict[str, Any],
            timeout: float = 3600.0) -> Dict[str, Any]:
    """One-shot client: send a request line, return the parsed reply."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(payload) + "\n").encode("utf-8"))
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf.decode("utf-8"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m synt_isic_tpu_torch.serve",
        description="long-lived generation service on a CUDA device "
                    "(JSON lines over TCP)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7933,
                   help="TCP port (0 picks a free one; the 'serving on' line "
                        "names it)")
    p.add_argument("--checkpoints", default=None)
    p.add_argument("--output-root", default="serve_output")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=128,
                   help="device batch size of the generator")
    p.add_argument("--max-batch", type=int, default=None,
                   help="coalescing cap in images (default: --batch, the "
                        "device batch the warmup runs)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype (bf16: the tensor-core attention "
                        "kernel; f32: its 3xTF32 kernel)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device to serve on (cuda runs the hand-written "
                        "attention kernel; cpu runs its plain version)")
    p.add_argument("--mesh", default=None, metavar="N|auto|DxT",
                   help="shard every device batch over a data-parallel mesh of "
                        "N devices ('auto' = every visible card; with --device "
                        "cpu, N repeats of the CPU device); rounds --batch up "
                        "to a multiple of N. 'DxT' (e.g. 1x2) adds tensor "
                        "parallelism: a {data: D, model: T} mesh over D x T "
                        "cards whose T-sized 'model' axis channel-shards the "
                        "UNet weights and runs attention by heads (the "
                        "LATENCY axis; --batch is rounded up by D only)")
    p.add_argument("--interactive-cost", type=int, default=256,
                   help="count x steps threshold under which a request "
                        "rides the priority lane (ahead of queued bulk "
                        "jobs; default 256 = e.g. 4 images at 50 steps)")
    p.add_argument("--warmup", nargs="*", default=[],
                   help="classes to load, build and run once before "
                        "accepting traffic")
    p.add_argument("--model-variant", default="best",
                   help="checkpoint variant to serve (e.g. 'distill8', pair "
                        "with --steps 8; recorded in sidecars). Distilled "
                        "variants default the sampler to ddim/trailing "
                        "unless --scheduler/--timestep-spacing say otherwise")
    p.add_argument("--png-compress-level", type=int, default=None,
                   metavar="0-9", choices=range(10),
                   help="zlib level for PNG artifacts (default: PIL's 6). "
                        "Recorded in sidecars; --reproduce honours it")
    p.add_argument("--scheduler",
                   choices=("ddpm", "ddim", "dpm_solver", "dpm_solver_sde", "unipc"),
                   default=None,
                   help="sampler of the main generator (default: ddpm; ddim "
                        "for distill* variants)")
    p.add_argument("--timestep-spacing", choices=("leading", "trailing"),
                   default=None,
                   help="main generator's timestep spacing (default: "
                        "leading; trailing for distill* variants)")
    p.add_argument("--conditional", action="store_true",
                   help="serve the one class-conditional checkpoint "
                        "(unet_conditional_<variant>.pth): one resident "
                        "model answers every class")
    p.add_argument("--guidance-scale", type=float, default=0.0, metavar="S",
                   help="classifier-free guidance weight with --conditional "
                        "(0/1 = plain conditional; > 1 = guided, one "
                        "2B-batched UNet forward per step)")
    p.add_argument("--guidance-map", default=None, metavar="SPEC",
                   help="per-class guidance with --conditional, e.g. "
                        "'MEL=2.5,NV=2' (absent classes use --guidance-scale)")
    p.add_argument("--fast-variant", default=None, metavar="V",
                   help="fast-preview lane on another checkpoint variant "
                        "(e.g. a distilled distill8) at --fast-steps")
    p.add_argument("--fast-scheduler", default=None,
                   choices=("ddpm", "ddim", "dpm_solver", "dpm_solver_sde",
                            "unipc"),
                   help="fast-preview lane on the SAME weights with a "
                        "few-step scheduler (e.g. unipc at --fast-steps 8)")
    p.add_argument("--fast-steps", type=int, default=None,
                   help="steps of the fast lane (default: the trailing "
                        "integer of the variant name, e.g. distill8 -> 8; "
                        "or 8 for a scheduler-only fast lane)")
    p.add_argument("--fast-spacing", choices=("leading", "trailing"),
                   default="trailing",
                   help="timestep spacing of the fast lane")
    return p


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.mesh:
        from .parallel.mesh import parse_mesh_spec

        try:
            parse_mesh_spec(args.mesh)
        except ValueError as exc:
            p.error(f"--mesh {args.mesh}: {exc}")

    from .generator import ImageGenerator, parse_guidance_map

    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    guidance_map = parse_guidance_map(args.guidance_map)
    gen = ImageGenerator(
        checkpoints_dir=args.checkpoints, device=args.device,
        compute_dtype=dtype, model_variant=args.model_variant,
        conditional=args.conditional, guidance_scale=args.guidance_scale,
        guidance_map=guidance_map)
    # a distilled student was trained for DDIM steps on a trailing grid
    is_distilled = args.model_variant.startswith("distill")
    gen.scheduler_kind = args.scheduler or ("ddim" if is_distilled
                                            else gen.scheduler_kind)
    gen.timestep_spacing = args.timestep_spacing or (
        "trailing" if is_distilled else gen.timestep_spacing)
    if args.png_compress_level is not None:
        gen.png_compress_level = args.png_compress_level
    if is_distilled and (args.scheduler is None
                         or args.timestep_spacing is None):
        print(f"model variant {args.model_variant}: sampler defaults set "
              f"to {gen.scheduler_kind}/{gen.timestep_spacing} "
              f"(its distillation grid)", flush=True)
    if args.steps:
        gen.set_inference_steps(args.steps)
    if args.batch:
        gen.batch_size = args.batch
    if args.mesh:
        from .parallel.mesh import apply_dp_mesh

        mesh = apply_dp_mesh(gen, args.mesh)
        print(f"serving over a {dict(mesh.shape)} mesh "
              f"(device batch {gen.batch_size})", flush=True)
    fast_gen = None
    if args.fast_variant or args.fast_scheduler:
        import re

        if args.fast_variant:
            m = re.search(r"(\d+)$", args.fast_variant)
            fast_steps = args.fast_steps or (int(m.group(1)) if m else None)
            if not fast_steps:
                p.error("--fast-steps required (variant name has no "
                        "trailing integer to infer it from)")
        else:
            # scheduler-only fast lane: same weights, few-step solver
            fast_steps = args.fast_steps or 8
        fast_variant = args.fast_variant or args.model_variant
        fast_gen = ImageGenerator(
            checkpoints_dir=args.checkpoints, device=args.device,
            compute_dtype=dtype, model_variant=fast_variant,
            conditional=args.conditional, guidance_scale=args.guidance_scale,
            guidance_map=guidance_map)
        if fast_variant == args.model_variant:
            # scheduler-only lane: share the main generator's weights (the
            # sampler's kind and steps are per-generator settings)
            fast_gen.model_manager = gen.model_manager
        fast_gen.set_inference_steps(fast_steps)
        fast_gen.timestep_spacing = args.fast_spacing
        fast_gen.scheduler_kind = args.fast_scheduler or (
            "ddim" if args.fast_variant else "unipc")
        fast_gen.save_trajectory = False
        print(f"fast lane: variant={fast_variant} "
              f"{fast_gen.scheduler_kind}-{fast_steps} "
              f"({args.fast_spacing})", flush=True)
    server = GenerationServer(gen, host=args.host, port=args.port,
                              output_root=args.output_root,
                              # gen.batch_size, not args.batch: --mesh may
                              # have rounded the device batch up
                              max_batch=args.max_batch or gen.batch_size,
                              interactive_cost=args.interactive_cost,
                              fast_generator=fast_gen)
    for cls in args.warmup:
        print(f"warming up {cls} (weights, kernels, first walks)...", flush=True)
        r = server._do_warmup({"class": cls, "compile": True})
        print(f"  {cls}: {r}", flush=True)
        if fast_gen is not None:
            rf = server._do_warmup({"class": cls, "compile": True, "fast": True})
            print(f"  {cls} (fast): {rf}", flush=True)
    server.start()
    print(f"serving on {server.address[0]}:{server.address[1]} "
          f"({len(gen.get_available_classes())} classes, "
          f"{gen.model_manager.device})", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
