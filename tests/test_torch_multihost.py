"""The port's multi-process tier (`parallel/multihost.py`) on the CPU.

In one process every helper is a no-op, as in the JAX package. Across two
real processes joined by `gloo` (each started with `Popen` and a 120 s
timeout): `local_batch_bounds`, `broadcast_from_host0`, `host0_only` (its
write and its failure), a data-parallel train step over the 2-process mesh
that equals the one-process step over the whole global batch (weights to
1e-5; the attention key biases, whose exact gradient is zero, to 3 * lr),
and a sharded sampling walk whose gathered images equal the one-process
walk's at the batch-composition bound, rtol=atol=1e-5.
"""
import dataclasses
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from synt_isic_tpu.parallel import multihost as jax_multihost
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.diffusion.schedules import DiffusionSchedule as Schedule
from synt_isic_tpu_torch.models.unet2d import UNet2D
from synt_isic_tpu_torch.parallel import multihost
from synt_isic_tpu_torch.train import train_ddpm

from tests.torch_port_fixtures import TINY, one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SEEDS = [4, 8, 15]


def test_single_process_is_a_no_op(monkeypatch, tmp_path):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize() is False
    assert not multihost.is_multihost()
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)
    tree = {"a": torch.arange(3), "b": "x"}
    assert multihost.broadcast_from_host0(tree) is tree
    multihost.sync_hosts()
    assert multihost.host0_only(lambda p: Path(p).write_text("w") and "done",
                                tmp_path / "f") == "done"
    with pytest.raises(ValueError, match="boom"):
        multihost.host0_only(lambda: (_ for _ in ()).throw(ValueError("boom")))
    mesh = multihost.hybrid_mesh(devices=[CPU] * 2)
    assert (mesh.shape, mesh.processes) == ({"data": 2}, 1)
    parts = multihost.global_batch_array(np.arange(6), mesh)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5]]
    assert multihost.gather_rows(parts[0]) is parts[0]
    copies = multihost.replicated_global({"w": np.ones(2)}, mesh)
    assert list(copies) == [CPU] and copies[CPU]["w"].tolist() == [1.0, 1.0]


def test_defaults_to_cuda_and_never_to_the_cpu(monkeypatch):
    """Without a card the defaults raise, as `create_mesh`'s do: the CPU
    device and the gloo backend are taken only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.local_devices()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.hybrid_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize(init_method="tcp://127.0.0.1:1", world_size=1, rank=0)
    assert not torch.distributed.is_initialized()
    assert multihost.local_devices("cpu") == [CPU]


@pytest.mark.parametrize("batch, pid, count", [(8, 0, 2), (8, 1, 2), (12, 2, 3), (4, 0, 1)])
def test_local_batch_bounds_match_jax(batch, pid, count):
    assert multihost.local_batch_bounds(batch, pid, count) == \
        jax_multihost.local_batch_bounds(batch, pid, count)


def test_local_batch_bounds_refuse_uneven():
    with pytest.raises(ValueError, match="not divisible"):
        multihost.local_batch_bounds(7, 0, 2)
    with pytest.raises(ValueError):
        jax_multihost.local_batch_bounds(7, 0, 2)


WORKER = r'''
import json, sys
from pathlib import Path
import numpy as np, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.parallel import ShardedSampler, multihost
from synt_isic_tpu_torch.train import train_ddpm

root, port, rank, out_dir = sys.argv[1], sys.argv[2], int(sys.argv[3]), Path(sys.argv[4])
case = json.loads(sys.argv[5])
config = UNet2DConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in case["config"].items()})
out = {"initialized": multihost.initialize(init_method=f"tcp://127.0.0.1:{port}",
                                           world_size=2, rank=rank, device="cpu")}
out["multi"] = multihost.is_multihost()
out["bounds"] = list(multihost.local_batch_bounds(case["batch"]))
got = multihost.broadcast_from_host0({"seeds": torch.arange(3) + 10 * rank, "name": f"r{rank}"})
out["broadcast"] = {"seeds": got["seeds"].tolist(), "name": got["name"]}
marker = out_dir / "host0.txt"
out["host0_result"] = multihost.host0_only(lambda: marker.write_text(str(rank)) and rank)
out["host0_file"] = marker.read_text()
try:
    multihost.host0_only(lambda: 1 / 0)
except Exception as exc:
    out["host0_raised"] = type(exc).__name__

mesh = multihost.hybrid_mesh(devices=[torch.device("cpu")])
out["mesh"] = [mesh.shape, mesh.processes]
torch.manual_seed(0)
model = UNet2D(config)
cfg = train_ddpm.TrainConfig(image_size=config.sample_size, batch_size=case["batch"],
                             bf16_compute=False)
state = train_ddpm.create_train_state(model, cfg, mesh=mesh)
step = train_ddpm.make_train_step(DiffusionSchedule.create(), cfg)
batch = torch.from_numpy(np.load(out_dir / "batch.npy"))
lo, hi = out["bounds"]
out["loss"] = float(step(state, batch[lo:hi], torch.Generator().manual_seed(0)))
if rank == 0:
    torch.save(model.state_dict(), out_dir / "dp_weights.pt")

sampler = DiffusionSampler(DiffusionSchedule.create(),
                           SamplerConfig(num_inference_steps=2, image_size=config.sample_size,
                                         scheduler="ddim"), device="cpu")
torch.manual_seed(1)
walker = UNet2D(config).eval()
images = ShardedSampler(sampler, mesh).sample(walker, np.asarray(case["seeds"], np.uint32))
np.save(out_dir / f"images{rank}.npy", images["images"].numpy())
out["n_hashes"] = len(images["noise_hashes"])
(out_dir / f"out{rank}.json").write_text(json.dumps(out))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("gloo")
    batch = np.tanh(np.random.default_rng(2).normal(size=(4, TINY.sample_size,
                                                          TINY.sample_size, 3)))
    np.save(out_dir / "batch.npy", batch.astype(np.float32))
    case = json.dumps({"config": dataclasses.asdict(TINY), "batch": 4, "seeds": SEEDS})
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(ROOT), port, str(rank),
                               str(out_dir), case],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
    outs = [json.loads((out_dir / f"out{r}.json").read_text()) for r in (0, 1)]
    return out_dir, outs


def test_two_gloo_processes_helpers(two_processes):
    _, (a, b) = two_processes
    assert a["initialized"] and b["initialized"] and a["multi"] and b["multi"]
    assert (a["bounds"], b["bounds"]) == ([0, 2], [2, 4])
    assert a["broadcast"] == b["broadcast"] == {"seeds": [0, 1, 2], "name": "r0"}
    # process 0 wrote, and every process saw the file once host0_only returned
    assert (a["host0_result"], b["host0_result"]) == (0, None)
    assert a["host0_file"] == b["host0_file"] == "0"
    assert a["host0_raised"] == "ZeroDivisionError" and b["host0_raised"] == "RuntimeError"
    assert a["mesh"] == b["mesh"] == [{"data": 2}, 2]


def test_two_gloo_processes_dp_step_equals_one_process(two_processes):
    out_dir, (a, b) = two_processes
    torch.manual_seed(0)
    model = UNet2D(TINY)
    cfg = train_ddpm.TrainConfig(image_size=TINY.sample_size, batch_size=4,
                                 bf16_compute=False)
    state = train_ddpm.create_train_state(model, cfg)
    step = train_ddpm.make_train_step(Schedule.create(), cfg)
    batch = torch.from_numpy(np.load(out_dir / "batch.npy"))
    loss = float(step(state, batch, torch.Generator().manual_seed(0)))
    # the all-reduced loss of the global batch, on both processes
    assert a["loss"] == pytest.approx(loss, rel=1e-6) and b["loss"] == a["loss"]
    dp = torch.load(out_dir / "dp_weights.pt", weights_only=True)
    for name, w in model.state_dict().items():
        atol = 3 * cfg.learning_rate if name.endswith("to_k.bias") else 1e-5
        np.testing.assert_allclose(dp[name].numpy(), w.numpy(), rtol=0, atol=atol,
                                   err_msg=name)


def test_two_gloo_processes_sampling_gathers_every_row(two_processes):
    out_dir, (a, b) = two_processes
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=2,
                                             image_size=TINY.sample_size, scheduler="ddim"),
                               device="cpu")
    torch.manual_seed(1)
    walker = UNet2D(TINY).eval()
    want = sampler.sample(walker, np.asarray(SEEDS, np.uint32))["images"].numpy()
    for rank in (0, 1):
        got = np.load(out_dir / f"images{rank}.npy")
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert a["n_hashes"] == b["n_hashes"] == len(SEEDS)
