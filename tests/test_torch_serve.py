"""The port's generation service (`synt_isic_tpu_torch/serve.py`) against
the JAX package's, with a tiny checkpoint on the CPU.

`drain_batch` is held to the JAX one request sequence by request sequence
(the drain cases of `tests/test_serve.py`, and a property over random
sequences). Served images are compared where both servers sample with the
same injected initial noise (the seam of `tests/test_torch_generator.py`)
and draw the same server seeds: DDIM at eta 0 is then deterministic, so the
files, CSV rows, `coalesced` counts and sidecars agree exactly (except what
differs by design or by clock: paths under each server's root, elapsed
times, the device name, the model's load time) and the f32 images within
1e-4. The rest of `tests/test_serve.py`'s behaviours run against the port
alone.
"""
import csv
import json
import queue
import secrets
import socket
import threading
from collections import deque
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from synt_isic_tpu import generator as jax_generator
from synt_isic_tpu import serve as jax_serve
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu_torch import serve
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.serve import GenerationServer, _Request, request

from tests.test_torch_generator import _inject, _keys, _without_clock
from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params

STEPS, BATCH = 2, 2


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("serve_ckpt")
    save_pth(flax_to_torch(jax_params()), str(path / "unet_NV_best.pth"))
    return path


def _setup(gen):
    gen.set_inference_steps(STEPS)
    gen.scheduler_kind = "ddim"
    gen.batch_size = BATCH
    return gen


def _port_gen(ckpt_dir, **kw) -> ImageGenerator:
    return _setup(ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY,
                                 device="cpu", **kw))


def _port_server(ckpt_dir, tmp_path, **kw) -> GenerationServer:
    return GenerationServer(_port_gen(ckpt_dir), port=0,
                            output_root=str(tmp_path / "served"), **kw)


@pytest.fixture(scope="module")
def port_server(ckpt_dir, tmp_path_factory):
    srv = _port_server(ckpt_dir, tmp_path_factory.mktemp("port_served")).start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def jax_server(ckpt_dir, tmp_path_factory):
    """One JAX server for the parity tests; its samplers take injected noise."""
    gen = _setup(jax_generator.ImageGenerator(checkpoints_dir=str(ckpt_dir),
                                              model_config=TINY_JAX))
    images = []
    _inject(gen, jnp.asarray, images)
    srv = jax_serve.GenerationServer(gen, port=0,
                                     output_root=str(tmp_path_factory.mktemp("jax_served")))
    yield srv, images
    srv.stop()


def _rpc(srv, payload):
    host, port = srv.address
    return request(host, port, payload, timeout=120)


# -- drain_batch: the same batches, backlog and fast lane as the JAX one ----------------

def _gen(**kw):
    return dict({"op": "generate", "class": "NV", "count": 1}, **kw)


def _interactive(payload):
    return int(payload.get("count", 1)) * int(payload.get("steps") or 50) <= 256


# (first, queued, backlog, fast or None, drain kwargs); a payload with
# "cancelled" is a request its client gave up on
DRAIN_CASES = {
    "merges_seedless_same_target": (_gen(count=2), [_gen(count=3), _gen(count=1)], [], None, {}),
    "fixed_seed_stays_apart": (_gen(), [_gen(seed=42)], [], None, {}),
    "max_batch_and_mixed_keys": (_gen(count=60), [_gen(count=10), _gen(count=4),
                                                  _gen(count=10, steps=99)], [], None, {}),
    "backlog_before_queue": (_gen(), [_gen()], [_gen(count=3), _gen(count=2, steps=99)],
                             None, {}),
    "drops_cancelled": (_gen(), [_gen(cancelled=True), _gen(count=2)], [], None, {}),
    "warmup_never_merges": ({"op": "warmup", "class": "NV"}, [_gen()], [], None, {}),
    "xai_apart_from_plain": (_gen(), [_gen(xai=True)], [], None, {}),
    "no_cross_class_per_class": (_gen(), [_gen(**{"class": "MEL", "count": 2})], [], None,
                                 {}),
    "cross_class_conditional": (_gen(), [_gen(**{"class": "MEL", "count": 2}),
                                         _gen(**{"class": "VASC", "steps": 7})], [], None,
                                {"ignore_class": True}),
    "diverts_interactive_to_fast": (_gen(count=4, steps=500),
                                    [_gen(steps=20), _gen(count=8, steps=500)], [], [],
                                    {"classify": _interactive}),
    "scans_fast_lane_first": (_gen(count=2), [_gen(count=3)],
                              [_gen(count=1, cancelled=True)],
                              [_gen(count=1), _gen(count=1, seed=3)],
                              {"classify": _interactive}),
    "stops_at_max_batch_in_lanes": (_gen(count=3), [_gen(count=1)], [_gen(count=1)],
                                    [_gen(count=1)], {"max_batch": 4,
                                                      "classify": _interactive}),
    "fast_opt_in_never_merges": (_gen(fast=True), [_gen()], [], [], {}),
}


def _drain(module, first, queued, backlog, fast, kwargs):
    """Run `module.drain_batch` on fresh requests; return every request's
    place afterwards, by its index in (first, queued, backlog, fast)."""
    payloads = [first, *queued, *backlog, *(fast or [])]
    reqs = []
    for i, p in enumerate(payloads):
        r = module._Request({k: v for k, v in p.items() if k != "cancelled"})
        r.cancelled = bool(p.get("cancelled"))
        r.payload["id"] = i
        reqs.append(r)
    q = queue.Queue()
    for r in reqs[1:1 + len(queued)]:
        q.put(r)
    lane_backlog = deque(reqs[1 + len(queued):1 + len(queued) + len(backlog)])
    lane_fast = (deque(reqs[1 + len(queued) + len(backlog):]) if fast is not None else None)
    kwargs = dict(kwargs)
    batch = module.drain_batch(q, reqs[0], kwargs.pop("max_batch", 64), lane_backlog,
                               fast=lane_fast, **kwargs)
    left = []
    while not q.empty():
        left.append(q.get_nowait().payload["id"])
    return {"batch": [r.payload["id"] for r in batch],
            "backlog": [r.payload["id"] for r in lane_backlog],
            "fast": None if lane_fast is None else [r.payload["id"] for r in lane_fast],
            "queue": left}


@pytest.mark.parametrize("case", sorted(DRAIN_CASES))
def test_drain_batch_matches_jax(case):
    first, queued, backlog, fast, kwargs = DRAIN_CASES[case]
    mine = _drain(serve, first, queued, backlog, fast, kwargs)
    assert mine == _drain(jax_serve, first, queued, backlog, fast, kwargs)
    if case == "merges_seedless_same_target":
        assert mine["batch"] == [0, 1, 2] and mine["queue"] == []
    if case == "diverts_interactive_to_fast":
        assert mine == {"batch": [0, 2], "backlog": [], "fast": [1], "queue": []}


_payloads = st.fixed_dictionaries(
    {"op": st.sampled_from(["generate", "generate", "generate", "warmup"]),
     "class": st.sampled_from(["NV", "MEL"]),
     "count": st.integers(1, 40)},
    optional={"seed": st.integers(0, 3), "steps": st.sampled_from([10, 20, 500]),
              "xai": st.booleans(), "fast": st.booleans(),
              "postprocess": st.booleans(), "output_dir": st.sampled_from(["a", "b"]),
              "cancelled": st.booleans()})


@settings(max_examples=60, deadline=None, database=None)
@given(first=_payloads, queued=st.lists(_payloads, max_size=8),
       backlog=st.lists(_payloads, max_size=4),
       fast=st.one_of(st.none(), st.lists(_payloads, max_size=4)),
       max_batch=st.integers(1, 64), ignore_class=st.booleans(), classify=st.booleans())
def test_drain_batch_matches_jax_on_random_sequences(first, queued, backlog, fast, max_batch,
                                                     ignore_class, classify):
    first = {k: v for k, v in first.items() if k != "cancelled"}
    kwargs = {"max_batch": max_batch, "ignore_class": ignore_class,
              "classify": _interactive if classify else None}
    assert (_drain(serve, first, queued, backlog, fast, kwargs)
            == _drain(jax_serve, first, queued, backlog, fast, kwargs))


def test_helpers_match_jax():
    for vals in ([], [3.0], [1.0, 2.0, 9.0], list(range(20))):
        for q in (0.0, 0.5, 0.95, 1.0):
            assert serve._percentile(vals, q) == jax_serve._percentile(vals, q)
    for payload, ignore in ((_gen(), False), (_gen(seed=1), False), (_gen(fast=True), False),
                            (_gen(xai=True, steps=5), True), ({"op": "warmup"}, False)):
        assert serve._coalesce_key(payload, ignore) == jax_serve._coalesce_key(payload, ignore)
    assert serve._snapshot_keys({"b": 1, "a": 2}) == ["a", "b"]


# -- served images against the JAX server --------------------------------------------------

def _scenario(srv, root: Path, monkeypatch):
    """A coalesced burst of two seedless requests (3 images: blocks of 2
    and 1), a fixed-seed request, and an interactive one served through
    the single-image path, all on the worker path directly (no thread
    races); server seeds from a counter."""
    drawn = iter(range(1000, 2000))
    monkeypatch.setattr(secrets, "randbelow", lambda n: next(drawn) % n)
    mk = srv_module(srv)._Request
    a = mk({"op": "generate", "class": "NV", "count": 2, "postprocess": False,
            "output_dir": str(root / "burst")})
    b = mk({"op": "generate", "class": "NV", "count": 1, "postprocess": False,
            "output_dir": str(root / "burst")})
    c = mk({"op": "generate", "class": "NV", "count": 2, "seed": 7, "postprocess": False,
            "output_dir": str(root / "seeded")})
    d = mk({"op": "generate", "class": "NV", "count": 1, "seed": 3, "postprocess": False,
            "output_dir": str(root / "interactive")})
    srv._queue.put(b)
    batch = srv_module(srv).drain_batch(srv._queue, a, srv.max_batch, srv._backlog,
                                        fast=srv._fast, classify=srv._is_interactive)
    srv._run_batch(batch)
    srv._run_batch([c])
    srv._run_interactive(d)
    replies = []
    for r in (a, b, c, d):
        reply = {k: v for k, v in r.response.items() if k != "elapsed_s"}
        reply["output_dir"] = str(Path(reply["output_dir"]).relative_to(root))
        reply["files"] = [str(Path(f).relative_to(root)) for f in reply["files"]]
        replies.append(reply)
    return replies


def srv_module(srv):
    return jax_serve if isinstance(srv, jax_serve.GenerationServer) else serve


def _served_artifacts(root: Path):
    pngs = sorted(root.rglob("*.png"))
    sidecars = {str(p.relative_to(root)): json.loads(p.with_suffix(".json").read_text())
                for p in pngs}
    rows = {}
    for path in sorted(root.rglob("synthetic_dataset.csv")):
        with open(path, newline="") as f:
            rows[str(path.relative_to(root))] = [
                {k: v for k, v in r.items() if k != "generated_at"} for r in csv.DictReader(f)]
    return pngs, sidecars, rows


def test_served_images_match_jax_server(ckpt_dir, tmp_path, jax_server, monkeypatch):
    jsrv, jax_images = jax_server
    del jax_images[:]
    port_images = []
    srv = _port_server(ckpt_dir, tmp_path)
    _inject(srv.generator, lambda a: a, port_images)
    mine = _scenario(srv, tmp_path / "port", monkeypatch)
    theirs = _scenario(jsrv, tmp_path / "jax", monkeypatch)
    srv.stop()
    assert mine == theirs
    assert [r["coalesced"] for r in mine] == [2, 2, 1, 1] and mine[3]["interactive"]
    assert [r["files"] for r in mine[:2]] == [["burst/NV/ISIC_0000001.png",
                                               "burst/NV/ISIC_0000002.png"],
                                              ["burst/NV/ISIC_0000003.png"]]
    pngs, sidecars, rows = _served_artifacts(tmp_path / "port")
    jpngs, jsidecars, jrows = _served_artifacts(tmp_path / "jax")
    assert [p.relative_to(tmp_path / "port") for p in pngs] == [
        p.relative_to(tmp_path / "jax") for p in jpngs]
    assert len(pngs) == 6 and rows == jrows and len(rows) == 3
    for name, meta in sidecars.items():
        assert _keys(meta) == _keys(jsidecars[name])
        assert _without_clock(meta) == _without_clock(jsidecars[name])
        assert meta["noise_hash"] == jsidecars[name]["noise_hash"]
    assert sidecars["burst/NV/ISIC_0000001.png"]["block"]["seeds"] == [1000, 1001]
    # blocks of 2 and 1 (burst), 2 (seeded) and 1 (interactive)
    assert [i.shape[0] for i in port_images] == [2, 1, 2, 1]
    for a, b in zip(port_images, jax_images):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_noise_injection_leaves_no_trace_between_servers(ckpt_dir, tmp_path, monkeypatch):
    """Seedless requests take their seeds from the server's draws and record
    them; the same draws give the same files in a second server."""
    outs = []
    for name in ("one", "two"):
        srv = _port_server(ckpt_dir, tmp_path / name)
        drawn = iter(range(5, 100))
        monkeypatch.setattr(secrets, "randbelow", lambda n: next(drawn))
        r = _Request({"op": "generate", "class": "NV", "count": 3, "postprocess": False})
        srv._run_batch([r])
        srv.stop()
        assert r.response["ok"] and r.response["coalesced"] == 1
        outs.append([Path(f).read_bytes() for f in r.response["files"]])
        seeds = [json.loads(Path(f).with_suffix(".json").read_text())["seed"]
                 for f in r.response["files"]]
        assert seeds == [5, 6, 7]
    assert outs[0] == outs[1]


# -- the rest of tests/test_serve.py's behaviours ------------------------------------------

def test_classes_status_and_protocol(port_server):
    assert _rpc(port_server, {"op": "classes"}) == {"ok": True, "classes": ["NV"]}
    status = _rpc(port_server, {"op": "status"})
    jax_keys = {"ok", "queue_depth", "fast_lane_depth", "served_images", "uptime_s",
                "throughput_img_s", "latency", "interactive_latency", "interactive_cost",
                "classes", "loaded_models", "device_batch", "mesh", "max_batch",
                "default_steps", "fast_variant", "generator"}
    assert set(status) == jax_keys
    assert status["mesh"] is None and status["default_steps"] == STEPS
    assert status["generator"]["device"] == "cpu"
    assert not _rpc(port_server, {"op": "nope"})["ok"]
    assert "missing 'class'" in _rpc(port_server, {"op": "generate"})["error"]
    assert "unknown class" in _rpc(port_server, {"op": "generate", "class": "MEL"})["error"]


def test_warmup_then_generate(port_server):
    w = _rpc(port_server, {"op": "warmup", "class": "NV"})
    assert w["ok"] and "compiled_batches" not in w
    w = _rpc(port_server, {"op": "warmup", "class": "NV", "compile": True})
    assert w["ok"] and w["steps"] == STEPS and w["compiled_batches"] == [1, BATCH]
    warmed = set(port_server.generator.model_manager._samplers)
    r = _rpc(port_server, {"op": "generate", "class": "NV", "count": 2, "seed": 42,
                           "postprocess": False})
    assert r["ok"] and len(r["files"]) == 2 and r["coalesced"] == 1
    assert all(Path(f).exists() for f in r["files"])
    # the warmup built the sampler the generate path runs, and no other
    assert set(port_server.generator.model_manager._samplers) == warmed
    assert "NV" in _rpc(port_server, {"op": "status"})["loaded_models"]


def test_fixed_seed_reproducible_and_steps_do_not_leak(port_server):
    r1, r2 = (_rpc(port_server, {"op": "generate", "class": "NV", "count": 1, "seed": 7,
                                 "postprocess": False}) for _ in range(2))
    assert Path(r1["files"][0]).read_bytes() == Path(r2["files"][0]).read_bytes()
    _rpc(port_server, {"op": "generate", "class": "NV", "count": 1, "steps": 3, "seed": 5,
                       "postprocess": False})
    r = _rpc(port_server, {"op": "generate", "class": "NV", "count": 1, "seed": 5,
                           "postprocess": False})
    sidecar = json.loads(Path(r["files"][0]).with_suffix(".json").read_text())
    assert sidecar["inference_steps"] == STEPS


def test_reused_output_dir_is_refused(port_server, tmp_path):
    out = tmp_path / "fixed"
    r1 = _rpc(port_server, {"op": "generate", "class": "NV", "count": 1, "seed": 1,
                            "postprocess": False, "output_dir": str(out)})
    assert r1["ok"]
    r2 = _rpc(port_server, {"op": "generate", "class": "NV", "count": 1, "seed": 2,
                            "postprocess": False, "output_dir": str(out)})
    assert not r2["ok"] and "already holds" in r2["error"]
    assert Path(r1["files"][0]).exists()
    # the interactive path refuses it too
    r3 = _Request({"op": "generate", "class": "NV", "count": 1, "output_dir": str(out)})
    port_server._run_interactive(r3)
    assert not r3.response["ok"] and "already holds" in r3.response["error"]


def test_concurrent_requests_all_served(port_server):
    results = []
    threads = [threading.Thread(target=lambda: results.append(_rpc(port_server, {
        "op": "generate", "class": "NV", "count": 1, "postprocess": False})))
        for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 3 and all(r["ok"] and len(r["files"]) == 1 for r in results)


def test_protocol_bad_json_and_persistent_connection(port_server):
    host, port = port_server.address
    with socket.create_connection((host, port), timeout=60) as sock:
        f = sock.makefile("rwb")
        for payload, check in [
            (b"{not json}\n", lambda r: not r["ok"] and "bad json" in r["error"]),
            (b"\n", None),
            (b'{"op": "classes"}\n', lambda r: r["ok"] and r["classes"] == ["NV"]),
            (b'{"op": "status"}\n', lambda r: r["ok"]),
        ]:
            f.write(payload)
            f.flush()
            if check is not None:
                reply = json.loads(f.readline().decode())
                assert check(reply), reply


def test_fast_lane_jumps_bulk_and_classification(ckpt_dir, tmp_path):
    srv = _port_server(ckpt_dir, tmp_path, interactive_cost=256)
    bulk = _Request(_gen(count=8, steps=1000))
    fast = _Request(_gen(count=1, steps=20))
    srv._queue.put(bulk)
    srv._queue.put(fast)
    assert srv._next_request() is fast
    assert srv._next_request() is bulk
    assert srv._is_interactive({"op": "generate", "count": 4, "steps": 50})
    assert not srv._is_interactive({"op": "generate", "count": 8, "steps": 50})
    assert srv._is_interactive({"op": "generate", "count": 100})   # server default: 2 steps
    assert srv._is_interactive({"op": "warmup", "class": "NV"})
    assert not srv._is_interactive({"op": "warmup", "class": "NV", "compile": True})
    assert srv._is_interactive({"op": "generate", "count": 99, "steps": 99, "fast": True})
    srv.stop()


def test_interactive_served_mid_bulk_run(ckpt_dir, tmp_path):
    """An interactive request that arrives while a bulk job runs is served
    between device blocks, before the bulk job finishes, and leaves the
    bulk run's settings alone."""
    srv = _port_server(ckpt_dir, tmp_path, interactive_cost=4)
    srv.generator.batch_size = 1
    order = []
    finish = srv._finish

    def tracking_finish(r, resp):
        order.append(r)
        finish(r, resp)
    srv._finish = tracking_finish
    bulk = _Request(_gen(count=3, steps=3, postprocess=False))        # cost 9 > 4
    inter = _Request(_gen(count=1, steps=4, postprocess=False))       # cost 4
    srv._queue.put(inter)
    srv._run_batch([bulk])
    assert inter.response["ok"] and inter.response["interactive"] is True
    assert bulk.response["ok"] and order[0] is inter
    assert len(bulk.response["files"]) == 3 and len(inter.response["files"]) == 1
    steps = [json.loads(Path(r.response["files"][0]).with_suffix(".json").read_text())[
        "inference_steps"] for r in (inter, bulk)]
    assert steps == [4, 3]
    status = srv._dispatch({"op": "status"})
    assert status["interactive_latency"]["n"] == 1 and status["latency"]["n"] == 2
    assert status["served_images"] == 4
    srv.stop()


def test_shutdown_drains_pending_requests(ckpt_dir, tmp_path):
    srv = _port_server(ckpt_dir, tmp_path)
    queued, backlogged, fast = _Request(_gen()), _Request(_gen(seed=7)), _Request(_gen())
    srv._queue.put(queued)
    srv._backlog.append(backlogged)
    srv._fast.append(fast)
    srv._stop.set()
    srv._queue.put(None)
    srv._work_loop()
    for r in (queued, backlogged, fast):
        assert r.event.is_set() and r.response == {"ok": False,
                                                   "error": "server shutting down"}
    assert srv._dispatch(_gen())["error"] == "server shutting down"
    srv.stop()


def test_status_latency_safe_under_concurrent_finish(ckpt_dir, tmp_path):
    """The worker appends latencies while `status` threads sort them: under
    `_lat_lock` no status call fails and no latency is lost."""
    import sys

    srv = _port_server(ckpt_dir, tmp_path)
    stop, errors, finished = threading.Event(), [], [0] * 4
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def hammer(k):
        while not stop.is_set():
            srv._finish(_Request(_gen(count=1, steps=1)), {"ok": True})
            finished[k] += 1

    threads = [threading.Thread(target=hammer, args=(k,), daemon=True) for k in range(4)]
    try:
        for t in threads:
            t.start()
        for _ in range(200):
            try:
                assert srv._dispatch({"op": "status"})["ok"]
            except RuntimeError as exc:  # the fault the lock prevents
                errors.append(exc)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    status = srv._dispatch({"op": "status"})
    assert status["latency"]["n"] == min(1024, sum(finished))
    srv.stop()


def _fast_server(ckpt_dir, tmp_path, variant=None):
    gen = _port_gen(ckpt_dir)
    fast = _port_gen(ckpt_dir, model_variant=variant or "best")
    if variant is None:
        fast.model_manager = gen.model_manager      # what `main` does: one set of weights
        fast.scheduler_kind = "unipc"
    fast.set_inference_steps(3)
    fast.timestep_spacing = "trailing"
    fast.save_trajectory = False
    return GenerationServer(gen, port=0, output_root=str(tmp_path / "out"),
                            fast_generator=fast).start()


def test_scheduler_only_fast_lane_shares_weights(ckpt_dir, tmp_path):
    srv = _fast_server(ckpt_dir, tmp_path)
    try:
        assert _rpc(srv, {"op": "status"})["fast_variant"] == {
            "variant": "best", "steps": 3, "timestep_spacing": "trailing"}
        w = _rpc(srv, {"op": "warmup", "class": "NV", "fast": True, "compile": True})
        assert w["ok"] and w["steps"] == 3 and w["compiled_batches"] == [1, BATCH]
        r = _rpc(srv, {"op": "generate", "class": "NV", "count": 2, "seed": 5, "fast": True,
                       "postprocess": False})
        assert r["ok"] and r["fast_variant"] == "best" and r["fast_steps"] == 3
        assert r["interactive"] is True and len(r["files"]) == 2
        meta = json.loads(Path(r["files"][0]).with_suffix(".json").read_text())
        assert (meta["scheduler"]["kind"], meta["scheduler"]["timestep_spacing"],
                meta["inference_steps"], meta["scheduler"]["model_variant"]) == (
            "unipc", "trailing", 3, "best")
        fast = srv.fast_generator
        assert fast.model_manager is srv.generator.model_manager
        assert list(srv.generator.model_manager.loaded_models) == ["NV"]
        main = _rpc(srv, {"op": "generate", "class": "NV", "count": 1, "seed": 5,
                          "postprocess": False})
        meta = json.loads(Path(main["files"][0]).with_suffix(".json").read_text())
        assert meta["scheduler"]["kind"] == "ddim" and meta["inference_steps"] == STEPS
        refused = _rpc(srv, {"op": "generate", "class": "NV", "count": 1, "fast": True,
                             "steps": 9})
        assert not refused["ok"] and "step count" in refused["error"]
        capped = _rpc(srv, {"op": "generate", "class": "NV", "count": srv.max_batch + 1,
                            "fast": True})
        assert not capped["ok"] and "capped" in capped["error"]
    finally:
        srv.stop()


def test_fast_variant_lane_and_no_fast_lane(ckpt_dir, tmp_path):
    student = tmp_path / "ckpt"
    student.mkdir()
    (student / "unet_NV_best.pth").write_bytes((ckpt_dir / "unet_NV_best.pth").read_bytes())
    save_pth(flax_to_torch(jax_params(seed=9)), str(student / "unet_NV_distill3.pth"))
    srv = _fast_server(student, tmp_path, variant="distill3")
    try:
        r = _rpc(srv, {"op": "generate", "class": "NV", "count": 1, "seed": 7, "fast": True,
                       "postprocess": False})
        assert r["ok"] and r["fast_variant"] == "distill3"
        meta = json.loads(Path(r["files"][0]).with_suffix(".json").read_text())
        assert meta["scheduler"]["model_variant"] == "distill3"
        best = _rpc(srv, {"op": "generate", "class": "NV", "count": 1, "seed": 7, "steps": 3,
                          "postprocess": False})
        assert Path(r["files"][0]).read_bytes() != Path(best["files"][0]).read_bytes()
    finally:
        srv.stop()
    srv = _port_server(ckpt_dir, tmp_path).start()
    try:
        r = _rpc(srv, {"op": "generate", "class": "NV", "count": 1, "fast": True})
        assert not r["ok"] and "no fast variant" in r["error"]
        assert not _rpc(srv, {"op": "warmup", "class": "NV", "fast": True})["ok"]
        assert _rpc(srv, {"op": "status"})["fast_variant"] is None
    finally:
        srv.stop()


def test_xai_request_returns_artifacts(ckpt_dir, tmp_path):
    """"xai": true runs the integrated pipeline on each served image's
    trajectory, in the bulk path and the interactive one."""
    from synt_isic_tpu_torch.models.classifier import LesionClassifier, random_resnet
    from synt_isic_tpu_torch.xai.integration import create_integrated_xai_analyzer

    from tests.torch_port_fixtures import small_classifiers

    built = []

    def factory():
        built.append(1)
        return create_integrated_xai_analyzer(
            classifier=LesionClassifier(random_resnet(8, 0), device="cpu"), ig_n_steps=2,
            shap_n_samples=4, n_bootstrap=20, n_permutations=20, with_sanity=False,
            with_gradcam=False, save_figures=False, verbose=False)

    srv = _port_server(ckpt_dir, tmp_path, xai_analyzer_factory=factory,
                       interactive_cost=1)
    with small_classifiers(32):
        r = _Request(_gen(seed=3, xai=True, postprocess=False))
        srv._run_batch([r])
        inter = _Request(_gen(seed=4, xai=True, postprocess=False))
        srv._run_interactive(inter)
    assert r.response["ok"] and inter.response["ok"], (r.response, inter.response)
    for reply in (r.response, inter.response):
        assert any(Path(reply["xai_dir"]).rglob("analysis_results.json"))
        assert "xai_error" not in reply
    assert built == [1]                       # built once, lazily
    plain = _Request(_gen(seed=5, postprocess=False))
    srv._run_batch([plain])
    assert plain.response["ok"] and "xai_dir" not in plain.response
    assert srv.generator.xai_analyzer is None
    srv.stop()


def test_main_refuses_mesh_and_a_missing_card(ckpt_dir, tmp_path, monkeypatch, capsys):
    """Tensor parallelism is ported: `--mesh 1x2 --device cpu` serves over a
    {'data': 1, 'model': 2} mesh (`status` reports it; the device batch is
    rounded by the data size only) and answers a generate request with the
    images the same request gets without a mesh, within one 8-bit level,
    its sidecars recording the mesh's 2 devices. A spec that is not N, auto
    or DxT exits 2 before any model is built, and without a card the CUDA
    default raises."""
    from PIL import Image

    with pytest.raises(SystemExit) as exc:
        serve.main(["--mesh", "2xq", "--checkpoints", str(ckpt_dir)])
    assert exc.value.code == 2 and "--mesh 2xq" in capsys.readouterr().err
    replies = []

    def serve_once(self):
        host, port = self.address
        replies.append((request(host, port, {"op": "status"}),
                        request(host, port, {"op": "generate", "class": "NV", "count": 2,
                                             "seed": 1, "postprocess": False})))
        self.stop()

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(GenerationServer, "serve_forever", serve_once)
    monkeypatch.setattr(ImageGenerator, "__init__", _tiny_init())
    for mesh in ("1x2", None):
        argv = ["--device", "cpu", "--checkpoints", str(ckpt_dir), "--port", "0",
                "--steps", str(STEPS), "--batch", "3", "--scheduler", "ddim", "--dtype", "f32",
                "--output-root", str(tmp_path / str(mesh))]
        assert serve.main(argv + (["--mesh", mesh] if mesh else [])) == 0
    (status, reply), (plain_status, plain) = replies
    assert status["mesh"] == {"data": 1, "model": 2} and plain_status["mesh"] is None
    assert status["device_batch"] == plain_status["device_batch"] == 3
    assert reply["ok"] and plain["ok"] and len(reply["files"]) == len(plain["files"]) == 2
    for got, want in zip(reply["files"], plain["files"]):
        a, b = (np.asarray(Image.open(f), np.int16) for f in (got, want))
        assert np.abs(a - b).max() <= 1
        assert json.loads(open(got[:-4] + ".json").read())["block"]["dp_mesh"] == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--checkpoints", str(ckpt_dir)])


def test_main_serves_on_the_cpu(ckpt_dir, tmp_path, monkeypatch, capsys):
    """`main` with every flag that shapes the generators, until a client
    shuts it down."""
    started = []
    monkeypatch.chdir(tmp_path)           # the generator's default folders land here
    monkeypatch.setattr(GenerationServer, "serve_forever",
                        lambda self: (started.append(self), self.stop()))
    monkeypatch.setattr(ImageGenerator, "__init__", _tiny_init())
    rc = serve.main(["--device", "cpu", "--checkpoints", str(ckpt_dir), "--port", "0",
                     "--steps", "2", "--batch", "2", "--scheduler", "ddim", "--dtype", "f32",
                     "--fast-scheduler", "ddim", "--fast-steps", "2",
                     "--output-root", str(tmp_path / "out"), "--warmup", "NV",
                     "--png-compress-level", "1"])
    assert rc == 0 and len(started) == 1
    srv = started[0]
    out = capsys.readouterr().out
    assert "serving on 127.0.0.1:" in out and "compiled_batches" in out
    assert srv.max_batch == 2 and srv.generator.png_compress_level == 1
    assert srv.fast_generator.model_manager is srv.generator.model_manager
    assert srv.generator.model_manager.dtype == torch.float32


def _tiny_init():
    """`ImageGenerator.__init__` at the tiny configuration."""
    original = ImageGenerator.__init__

    def init(self, *args, **kwargs):
        kwargs.setdefault("model_config", TINY)
        original(self, *args, **kwargs)
    return init

