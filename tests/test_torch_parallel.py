"""The port's device mesh and data-parallel sampler against the JAX
package's, on the CPU.

The JAX side runs on the 8 virtual CPU devices `tests/conftest.py` sets;
the port's meshes repeat the one CPU device (`create_mesh(devices=[cpu] *
n)`), which the port allows and JAX does not. The JAX sampler's initial
noise is replaced by a table indexed by seed, so both packages walk the
same noise; the JAX walk runs at highest matmul precision.

A mesh of `[cpu, cpu:1]` (`TWO_DEVICES`) has two distinct devices that
both compute on the CPU: each gets its own replica and host thread, as a
second card would.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion import DiffusionSampler as JaxSampler
from synt_isic_tpu.diffusion import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.diffusion import SamplerConfig as JaxSamplerConfig
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.parallel import mesh as jax_mesh
from synt_isic_tpu.parallel import sharded_sampler as jax_sharded
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.ops import attention
from synt_isic_tpu_torch.parallel import ShardedSampler, create_mesh
from synt_isic_tpu_torch.parallel import mesh as port_mesh
from synt_isic_tpu_torch.parallel.replicas import run_per_device, sampling_replica
from synt_isic_tpu_torch.parallel.sharded_sampler import sharded_scores

from tests.torch_port_fixtures import TINY_JAX, jax_params, one_thread, port_model  # noqa: F401

CPU = torch.device("cpu")
STEPS = 3
SIZE = TINY_JAX.sample_size


TWO_DEVICES = [CPU, torch.device("cpu", 1)]


def _cpus(n):
    return [CPU] * n


@pytest.mark.parametrize("axes, n", [({"data": -1}, 8), ({"data": 2, "model": -1}, 8),
                                     ({"data": 2}, 8), ({"data": 2, "model": 2}, 8),
                                     (None, 4)],
                         ids=["all", "data-model", "prefix", "prefix-2d", "default"])
def test_create_mesh_shapes_match_jax(axes, n):
    """The same axis sizes as the JAX mesh over the same device count; an
    underfilled mesh takes a prefix of the devices."""
    want = jax_mesh.create_mesh(axes, jax.devices()[:n])
    got = create_mesh(axes, _cpus(n))
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.devices.size == want.devices.size


@pytest.mark.parametrize("axes", [{"data": 3}, {"data": -1, "model": -1}, {"data": 2, "model": 3}],
                         ids=["not-dividing", "two-free", "second-not-dividing"])
def test_create_mesh_errors_match_jax(axes):
    with pytest.raises(ValueError) as want:
        jax_mesh.create_mesh(axes, jax.devices()[:8])
    with pytest.raises(ValueError) as got:
        create_mesh(axes, _cpus(8))
    assert str(got.value) == str(want.value)


def test_create_mesh_defaults_to_cuda_and_never_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh({"data": -1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.data_mesh(2)
    assert port_mesh.data_mesh(3, "cpu").shape == {"data": 3}
    assert port_mesh.data_mesh(-1, "cpu").shape == {"data": 1}


def test_tensor_parallel_refused(model):
    """Tensor parallelism is ported: a 1 x 2 ('data', 'model') mesh gives
    the data-only mesh's shards (each row's first device) and its row, the
    specs name both sizes, and the placement of the tiny UNet is that of
    the JAX `tp_param_shardings` (`tests/test_torch_tensor_parallel.py`
    holds it leaf for leaf)."""
    mesh = create_mesh({"data": 1, "model": 2}, _cpus(2))
    assert mesh.shard_devices("data") == create_mesh({"data": 1}, _cpus(1)).shard_devices()
    assert mesh.rows("data") == [_cpus(2)]
    dims = port_mesh.tp_param_shardings(model, mesh)
    assert dims["conv_in.weight"] == 0 and dims["conv_in.bias"] is None
    assert dims["conv_out.weight"] is None
    assert port_mesh.tp_param_shardings({}, mesh) == {}
    assert [port_mesh.parse_mesh_spec(s) for s in ("4", "auto", "2x1", "2x2")] == [
        {"data": 4}, {"data": -1}, {"data": 2, "model": 1}, {"data": 2, "model": 2}]


def test_shard_batch_and_pad():
    mesh = create_mesh({"data": 4}, _cpus(4))
    parts = port_mesh.shard_batch(np.arange(8), mesh)
    assert [p.tolist() for p in parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [port_mesh.pad_to_multiple(n, 4) for n in (1, 4, 5)] == [
        jax_mesh.pad_to_multiple(n, 4) for n in (1, 4, 5)] == [4, 4, 8]


class _FakeGenerator:
    def __init__(self, batch_size):
        self.batch_size = batch_size
        self.mesh = None
        self.model_manager = type("MM", (), {"device": CPU})()

    def set_mesh(self, mesh):
        self.mesh = mesh


@pytest.mark.parametrize("spec, batch, want", [("4", 6, 8), ("4", 8, 8), ("2x1", 3, 4),
                                               ("auto", 3, 3)])
def test_apply_dp_mesh_rounds_the_device_batch_up(spec, batch, want):
    """The device batch becomes a multiple of the dp size, as the JAX
    `apply_dp_mesh` makes it ('auto' is every device: 8 JAX CPU devices,
    the one CPU device here)."""
    gen = _FakeGenerator(batch)
    mesh = port_mesh.apply_dp_mesh(gen, spec)
    assert gen.mesh is mesh and gen.batch_size == want
    if spec != "auto":
        jgen = _FakeGenerator(batch)
        jax_mesh.apply_dp_mesh(jgen, spec)
        assert jgen.batch_size == want and dict(jgen.mesh.shape)["data"] == mesh.shape["data"]


@pytest.fixture(scope="module")
def params():
    return jax_params(seed=7)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


@pytest.fixture(scope="module")
def jax_sampler():
    jmodel = JaxUNet2D(config=TINY_JAX)
    return JaxSampler(lambda p, x, t: jmodel.apply({"params": p}, x, t), JaxSchedule.create(),
                      JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                       scheduler="ddim"))


def _port_sampler(**kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=STEPS, image_size=SIZE, **kw),
                            device="cpu")


NOISE = np.random.default_rng(3).normal(size=(8, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("n", [8, 5, 1])
def test_sharded_sampler_matches_jax_and_unsharded(params, model, jax_sampler, monkeypatch, n):
    """4 shards, 8, 5 (padded to 8) and 1 seed (padded to 4 by tiling):
    the port's sharded walk against the JAX `ShardedSampler` on a 4-device
    mesh (every frame: 1e-4 on the first, 1e-3 on the last, the golden
    chain's bounds in `tests/test_torch_sampler.py`) and against the
    port's unsharded walk at the batch-composition bound, rtol=atol=1e-5.
    Exactly n images, noise hashes and seeds come back."""
    seeds = np.arange(n, dtype=np.uint32)
    # the JAX sampler's noise for seed s is row s of the table
    monkeypatch.setattr(jax_sampler, "initial_noise",
                        lambda s: jnp.asarray(NOISE[np.asarray(s, np.int64)]))
    jmesh = jax_mesh.create_mesh({"data": 4}, jax.devices()[:4])
    with jax.default_matmul_precision("highest"):
        want = jax_sharded.ShardedSampler(jax_sampler, jmesh).sample(
            params, seeds, capture_trajectory=True)
    want_traj = np.asarray(want["trajectory"])

    sampler = _port_sampler(scheduler="ddim")
    mesh = create_mesh({"data": 4}, _cpus(4))
    got = ShardedSampler(sampler, mesh).sample(model, seeds, capture_trajectory=True,
                                               initial_noise=NOISE[:n])
    traj = got["trajectory"].numpy()
    assert traj.shape == want_traj.shape == (STEPS, n, SIZE, SIZE, 3)
    np.testing.assert_allclose(traj[0], want_traj[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(traj[-1], want_traj[-1], rtol=1e-3, atol=1e-3)
    assert len(got["images"]) == len(got["noise_hashes"]) == len(got["seeds"]) == n
    assert list(got["seeds"]) == list(want["seeds"]) == list(seeds)

    alone = sampler.sample(model, seeds, capture_trajectory=True, initial_noise=NOISE[:n])
    np.testing.assert_allclose(traj, alone["trajectory"].numpy(), rtol=1e-5, atol=1e-5)
    assert list(got["noise_hashes"]) == list(alone["noise_hashes"])


@pytest.mark.parametrize("scheduler", ["ddpm", "unipc"])
def test_sharded_walk_draws_the_unsharded_streams(model, scheduler):
    """Without injected noise every seed's initial and step noise is the
    unsharded walk's (drawn on the primary sampler's device, whichever
    shard walks it), captured frames streamed to host memory included;
    the labels of a conditional block ride with their seeds."""
    sampler = _port_sampler(scheduler=scheduler)
    seeds = np.asarray([5, 9, 13], np.uint32)
    mesh = create_mesh({"data": 2}, _cpus(2))
    got = ShardedSampler(sampler, mesh).sample(model, seeds, capture_trajectory=2,
                                               stream_to_host=True)
    alone = sampler.sample(model, seeds, capture_trajectory=2, stream_to_host=True)
    assert got["save_indices"] == alone["save_indices"]
    assert isinstance(got["trajectory"], np.ndarray)
    np.testing.assert_allclose(got["trajectory"], alone["trajectory"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["images"].numpy(), alone["images"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert list(got["noise_hashes"]) == list(alone["noise_hashes"])


@pytest.mark.parametrize("n, shards", [(3, 8), (5, 4), (4, 4)])
def test_sharded_scores_pads_short_batches(n, shards):
    """A batch shorter than its pad (3 rows on 8 shards) is tiled to the
    shard count and cut back, as the JAX `sharded_scores` does."""
    batch = np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)

    def fn(x):
        return x * 2.0 + x[:, :1]

    got = sharded_scores(fn, batch, create_mesh({"data": shards}, _cpus(shards)))
    want = jax_sharded.sharded_scores(jax.jit(fn), batch,
                                      jax_mesh.create_mesh({"data": shards},
                                                           jax.devices()[:shards]))
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, fn(batch), rtol=1e-6, atol=1e-6)


def test_launch_counts_stay_exact_across_threads():
    """`_count` (and `_remember`) from 16 threads at once, more than the
    cores, with the interpreter switching threads every microsecond: no
    increment is lost (the shards of a mesh launch from one host thread per
    device)."""
    before = dict(attention.LAUNCHES)
    names = (attention.KERNEL, attention.FAST_KERNEL)
    threads_n, calls = 16, 2000
    start = threading.Barrier(threads_n)

    def hammer(i):
        start.wait()
        for j in range(calls):
            attention._count(names)
            attention._remember(("stress", i, j % 300), None)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(i,)) for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
        attention._PLANS.clear()
    assert not any(t.is_alive() for t in threads)
    for name in names:
        assert attention.LAUNCHES[name] - before[name] == threads_n * calls
        attention.LAUNCHES[name] = before[name]


def test_two_devices_run_on_their_own_threads_in_shard_order():
    """Shards of [cpu, cpu:1, cpu, cpu:1]: the first shard of each device
    waits for the other's (so the two devices' threads run at once), each
    device's shards run in one thread, and the results come back in shard
    order."""
    meet = threading.Barrier(2, timeout=30)

    def work(i):
        if i < 2:
            meet.wait()
        return i, threading.get_ident()

    got = run_per_device(TWO_DEVICES * 2, work)
    assert [i for i, _ in got] == [0, 1, 2, 3]
    threads = [t for _, t in got]
    assert threads[0] == threads[2] != threads[1] == threads[3]
    assert threading.get_ident() not in threads


def test_sharded_sampler_on_two_devices_walks_a_replica(model):
    """5 seeds over [cpu, cpu:1] (padded to 6): the second device's shard
    walks a replica built from the primary's state dict, and the images,
    noise hashes and trajectory equal the unsharded walk's at the
    batch-composition bound, rtol=atol=1e-5."""
    sampler = _port_sampler(scheduler="ddim")
    seeds = np.arange(5, dtype=np.uint32)
    got = ShardedSampler(sampler, create_mesh({"data": 2}, TWO_DEVICES)).sample(
        model, seeds, capture_trajectory=True, initial_noise=NOISE[:5])
    twin = sampling_replica(model, TWO_DEVICES[1])
    assert twin is not model
    for name, value in model.state_dict().items():
        assert torch.equal(twin.state_dict()[name], value)
    alone = sampler.sample(model, seeds, capture_trajectory=True, initial_noise=NOISE[:5])
    assert len(got["images"]) == len(got["noise_hashes"]) == len(got["seeds"]) == 5
    np.testing.assert_allclose(got["trajectory"].numpy(), alone["trajectory"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert list(got["noise_hashes"]) == list(alone["noise_hashes"])
