"""The port's browser UI (`synt_isic_tpu_torch/app/webui.py`), driven over
HTTP on a loopback port as `tests/test_webui.py` drives the JAX package's:
state and telemetry, generation through the single worker thread, the
results and XAI browsers, incremental logs, the file-serving sandbox, and
the conditional family; with tiny checkpoints on the CPU."""
import json
import pickle
import time
import urllib.error
import urllib.request

import pytest
import torch

from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu_torch.app import webui
from synt_isic_tpu_torch.app.webui import WebUIServer
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.train.train_conditional import write_conditional_metadata
from synt_isic_tpu_torch.utils.config import ConfigManager

from tests.torch_port_fixtures import (COND_CLASSES, TINY, TINY_COND, TINY_COND_JAX,
                                       jax_params)


def _get(app, path, raw=False):
    with urllib.request.urlopen(f"http://127.0.0.1:{app.port}{path}", timeout=30) as r:
        body = r.read()
        return body if raw else json.loads(body)


def _post(app, path, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{app.port}{path}",
                                 data=json.dumps(obj).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post_err(app, path, obj):
    try:
        return _post(app, path, obj)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_idle(server, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _get(server, "/api/state")["busy"]:
            return
        time.sleep(0.1)
    raise TimeoutError("generation did not finish")


@pytest.fixture(scope="module")
def app(tmp_path_factory):
    base = tmp_path_factory.mktemp("webui")
    ckpt = base / "checkpoints"
    ckpt.mkdir()
    for cls in ("MEL", "NV"):
        save_pth(flax_to_torch(jax_params()), str(ckpt / f"unet_{cls}_best.pth"))
    cfg = ConfigManager(config_file=str(base / "config.json"), project_root=str(base))
    gen = ImageGenerator(config=cfg, checkpoints_dir=str(ckpt), model_config=TINY,
                         device="cpu")
    server = WebUIServer(generator=gen, config=cfg, checkpoints_dir=str(ckpt),
                         output_dir=str(base / "generated")).start()
    yield server, base
    server.stop()


def test_index_page_served(app):
    server, _ = app
    page = _get(server, "/", raw=True).decode()
    assert "SYNT-ISIC" in page and "/api/state" in page


def test_state_reports_classes_device_and_config(app):
    server, base = app
    s = _get(server, "/api/state")
    assert s["classes"]["MEL"] and s["classes"]["NV"] and not s["classes"]["BCC"]
    assert s["family"] == "per-class" and s["variant"] == "best" and not s["busy"]
    assert s["output_dir"] == str((base / "generated").resolve())
    assert s["xai_results_dir"].startswith(s["output_dir"])
    assert s["config"]["image_size"] == 128          # the config's, not the model's
    # no card: no device memory to report
    assert s["device"] == "cpu" and s["mesh"] is None
    assert s["memory"] == {"mb_in_use": None, "mb_peak": None}
    assert s["n_devices"] == torch.cuda.device_count()


def test_generate_validation_errors(app):
    server, _ = app
    code, resp = _post_err(server, "/api/generate", {"classes": {}})
    assert code == 400 and "at least one" in resp["error"]
    code, resp = _post_err(server, "/api/generate", {"classes": {"NOPE": 1}})
    assert code == 400 and "NOPE" in resp["error"]
    code, resp = _post_err(server, "/api/xai/run", {"class": "NOPE"})
    assert code == 400 and "NOPE" in resp["error"]
    code, resp = _post_err(server, "/api/nowhere", {})
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server, "/api/nowhere")
    assert exc.value.code == 404


def test_generate_end_to_end_and_browsers(app):
    server, _ = app
    code, resp = _post(server, "/api/generate", {
        "classes": {"MEL": 2}, "steps": 2, "seed_mode": "fixed", "seed": 42,
        "postprocess": True})
    assert code == 200 and resp == {"ok": True, "configs": [["MEL", 2]], "steps": 2}
    _wait_idle(server)
    s = _get(server, "/api/state")
    assert s["last_result"]["generated"] == 2
    assert s["progress"]["done"] == s["progress"]["total"] > 0
    files = _get(server, "/api/results")["files"]
    assert len(files) == 2
    entry = files[0]
    assert entry["name"].startswith("MEL/ISIC_") and "sidecar" in entry
    png = _get(server, "/api/file?path=" + entry["path"], raw=True)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    sidecar = json.loads(_get(server, "/api/file?path=" + entry["sidecar"], raw=True))
    assert sidecar["class"] == "MEL" and sidecar["seed"] is not None
    assert sidecar["inference_steps"] == 2 and sidecar["device"] == "cpu"


def test_logs_are_incremental(app):
    server, _ = app
    first = _get(server, "/api/logs?since=0")
    assert first["entries"] and first["next"] > 0
    assert _get(server, f"/api/logs?since={first['next']}")["entries"] == []


def test_stop_endpoint_ok_when_idle(app):
    server, _ = app
    assert _post(server, "/api/stop", {}) == (200, {"ok": True})


def test_file_sandbox_blocks_traversal(app):
    server, base = app
    for path in ("/etc/passwd", str(base / "generated" / ".." / ".." / "etc" / "passwd"),
                 str(base / "config.json"), ""):
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(server, "/api/file?path=" + path, raw=True)
        assert exc.value.code == 404


def test_xai_browser_lists_runs_and_serves_artifacts(app):
    server, _ = app
    run_dir = server.xai_results_dir / "MEL" / "demo_seed42"
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "analysis_results.json").write_text(json.dumps({"target_class": "MEL"}))
    with open(run_dir / "full_results.pkl", "wb") as f:
        pickle.dump({"cfi": [1.0, 2.0], "nested": {"a": (1, 2)}}, f)
    (server.xai_results_dir / "MEL" / "xai_ISIC_0000001_x.json").write_text("{}")
    runs = _get(server, "/api/xai/runs")["runs"]
    match = [r for r in runs if r["name"] == "demo_seed42"]
    assert match and match[0]["class"] == "MEL"
    assert any(r["name"] == "xai_ISIC_0000001_x.json" for r in runs)
    files = _get(server, "/api/xai/files?run=" + match[0]["path"])["files"]
    assert {"analysis_results.json", "full_results.pkl"} <= {f["name"] for f in files}
    view = _get(server, "/api/file?path=" + str(run_dir / "full_results.pkl"),
                raw=True).decode()
    assert "dict(2 keys)" in view and "'cfi'" in view
    outside = _get(server, "/api/xai/files?run=/etc")
    assert outside["files"] == [] and "outside" in outside["error"]


def test_busy_guard_rejects_concurrent_generate(app):
    server, _ = app
    gate = server.generator.model_manager
    load = gate.load_model
    import threading

    release = threading.Event()

    def slow_load(cls, *args, **kwargs):
        release.wait(timeout=30)
        return load(cls, *args, **kwargs)
    gate.load_model = slow_load
    try:
        code, _ = _post(server, "/api/generate", {
            "classes": {"NV": 1}, "steps": 2, "seed_mode": "fixed", "seed": 1})
        assert code == 200
        code2, resp2 = _post_err(server, "/api/generate", {"classes": {"MEL": 1}, "steps": 2})
        assert code2 == 409 and "already running" in resp2["error"]
        assert _get(server, "/api/state")["busy"]
    finally:
        release.set()
        _wait_idle(server)
        gate.load_model = load


def test_summarize_pickle_matches_jax():
    from synt_isic_tpu.app import webui as jax_webui

    import numpy as np

    for obj in ({"a": [1, 2], "b": np.zeros((2, 3))}, [], (1, "x" * 200), 3.5):
        assert webui._summarize_pickle(obj) == jax_webui._summarize_pickle(obj)


def test_main_runs_on_the_cpu_flag(tmp_path, monkeypatch):
    """`--cpu` builds the generator on the CPU; without it, the card (and
    without a card, `resolve_device`'s error)."""
    seen = []

    class Stop(Exception):
        pass

    def fake_server(**kwargs):
        seen.append(kwargs["generator"].model_manager.device.type)
        raise Stop
    monkeypatch.setattr(webui, "WebUIServer", fake_server)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)           # the default config's folders land here
    with pytest.raises(Stop):
        webui.main(["--cpu", "--checkpoints", str(tmp_path), "--port", "0"])
    assert seen == ["cpu"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        webui.main(["--checkpoints", str(tmp_path), "--port", "0"])


# -- the conditional family ----------------------------------------------------------------

@pytest.fixture(scope="module")
def cond_app(tmp_path_factory):
    base = tmp_path_factory.mktemp("webui_cond")
    ckpt = base / "checkpoints"
    ckpt.mkdir()
    save_pth(flax_to_torch(jax_params(TINY_COND_JAX)), str(ckpt / "unet_conditional_best.pth"))
    write_conditional_metadata(str(ckpt), list(COND_CLASSES), 0.1)
    cfg = ConfigManager(config_file=str(base / "config.json"), project_root=str(base))
    gen = ImageGenerator(config=cfg, checkpoints_dir=str(ckpt), model_config=TINY,
                         device="cpu", conditional=True, guidance_scale=2.0)
    assert gen.model_manager.config == TINY_COND
    server = WebUIServer(generator=gen, config=cfg, checkpoints_dir=str(ckpt),
                         output_dir=str(base / "generated")).start()
    yield server, base
    server.stop()


def test_conditional_state_reports_family_and_classes(cond_app):
    server, _ = cond_app
    state = _get(server, "/api/state")
    assert state["family"] == "conditional" and state["guidance"] == 2.0
    assert {c for c, ok in state["classes"].items() if ok} == set(COND_CLASSES)


def test_conditional_generate_end_to_end(cond_app):
    server, base = cond_app
    status, body = _post(server, "/api/generate", {
        "classes": {"NV": 1, "VASC": 1}, "steps": 2, "seed_mode": "fixed", "seed": 7})
    assert status == 200, body
    _wait_idle(server)
    for cls in ("NV", "VASC"):
        out = list((base / "generated" / cls).glob("ISIC_*.png"))
        assert len(out) == 1
        sidecar = json.loads(out[0].with_suffix(".json").read_text())
        assert sidecar["scheduler"]["conditional"] is True
        assert sidecar["scheduler"]["guidance_scale"] == 2.0
