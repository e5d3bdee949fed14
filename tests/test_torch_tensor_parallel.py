"""The port's tensor parallelism against the JAX package's, on the CPU.

The JAX side places the UNet weights by its `tp_param_shardings` over the
8 virtual CPU devices `tests/conftest.py` sets, and GSPMD partitions the
walk. The port's meshes repeat the one CPU device: each 'model' slice of a
sharded layer is computed on its own (`parallel/tensor_parallel.py`), with
no copy. The JAX sampler's initial noise is replaced by a table indexed by
seed, so both packages walk the same noise; the JAX walk runs at highest
matmul precision, and each mesh's JAX walk runs once per module.

Bounds: against the JAX walk every frame within 1e-4 on the first frame
and 1e-3 on the last (the golden chain's bounds,
`tests/test_torch_sampler.py`); against the port's unsharded walk
rtol=atol=1e-5, the batch-composition bound of the data-parallel walk
(`tests/test_torch_parallel.py`): a sharded layer only computes fewer
output channels per product.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synt_isic_tpu.diffusion import DiffusionSampler as JaxSampler
from synt_isic_tpu.diffusion import DiffusionSchedule as JaxSchedule
from synt_isic_tpu.diffusion import SamplerConfig as JaxSamplerConfig
from synt_isic_tpu.models.unet2d import UNet2D as JaxUNet2D
from synt_isic_tpu.models.unet2d import UNet2DConfig as JaxUNet2DConfig
from synt_isic_tpu.models.unet2d import init_unet_params
from synt_isic_tpu.parallel import mesh as jax_mesh
from synt_isic_tpu.parallel import sharded_sampler as jax_sharded
from synt_isic_tpu_torch.diffusion import DiffusionSampler, DiffusionSchedule, SamplerConfig
from synt_isic_tpu_torch.io.convert import flatten_tree, torch_to_flax
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.parallel import ShardedSampler, create_mesh
from synt_isic_tpu_torch.parallel import mesh as port_mesh
from synt_isic_tpu_torch.parallel import tensor_parallel as tp
from synt_isic_tpu_torch.parallel.mesh import Mesh

from tests.torch_port_fixtures import (TINY, TINY_COND, TINY_COND_JAX, TINY_JAX,  # noqa: F401
                                       jax_params, one_thread, port_model)

CPU = torch.device("cpu")
STEPS = 3
SIZE = TINY_JAX.sample_size
NOISE = np.random.default_rng(5).normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
MESHES = {"1x2": {"data": 1, "model": 2}, "2x2": {"data": 2, "model": 2}}


def _cpus(n):
    return [CPU] * n


def _tp_mesh(axes):
    return create_mesh(axes, _cpus(int(np.prod(list(axes.values())))))


# -- placement --------------------------------------------------------------------------

@functools.cache
def _jax_shapes(config):
    return jax.eval_shape(lambda: init_unet_params(JaxUNet2D(config=config),
                                                   jax.random.PRNGKey(0)))


@functools.cache
def _port_shapes(config):
    with torch.device("meta"):
        return UNet2D(config).state_dict()


def _flax_key(key, shape):
    """The '/'-joined Flax key and leaf shape the weight carrier gives a
    torch leaf."""
    ((flax_key, leaf),) = flatten_tree(torch_to_flax({key: np.zeros(shape, np.float32)},
                                                     strip_prefixes=())).items()
    return flax_key, leaf.shape


CONFIGS = {"tiny": (TINY, TINY_JAX), "cond": (TINY_COND, TINY_COND_JAX),
           "full": (UNet2DConfig(), JaxUNet2DConfig())}


@pytest.mark.parametrize("tp_size", [2, 4, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_param_shardings_match_jax(name, tp_size):
    """Leaf for leaf through the weight carrier: the port shards a leaf
    exactly where the JAX `tp_param_shardings` does, on the torch dim that
    is last in its Flax leaf (dim 0 of a conv or linear weight, dim 1 of the
    class embedding); the full-width config from its shapes alone."""
    port_cfg, jax_cfg = CONFIGS[name]
    jmesh = jax_mesh.create_mesh({"data": 1, "model": tp_size}, jax.devices()[:tp_size])
    specs = jax_mesh.tp_param_shardings(_jax_shapes(jax_cfg), jmesh)
    want = {"/".join(p.key for p in path): s.spec
            for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]}
    shapes = _port_shapes(port_cfg)
    got = port_mesh.tp_param_shardings(shapes, create_mesh({"data": 1, "model": tp_size},
                                                           _cpus(tp_size)))
    assert set(got) == set(shapes)
    seen, sharded = set(), 0
    for key, dim in got.items():
        shape = tuple(shapes[key].shape)
        flax_key, flax_shape = _flax_key(key, shape)
        spec = want[flax_key]
        seen.add(flax_key)
        if dim is None:
            assert all(a is None for a in spec), key
        else:
            sharded += 1
            assert tuple(spec) == (None,) * (len(shape) - 1) + ("model",), key
            assert shape[dim] == flax_shape[-1]
            assert dim == (1 if key == "class_embedding.weight" else 0)
    assert seen == set(want) and sharded > 0
    if name == "cond":
        assert got["class_embedding.weight"] == 1


# -- the walk against JAX's and the unsharded walk ----------------------------------------

@pytest.fixture(scope="module")
def params():
    return jax_params(seed=11)


@pytest.fixture(scope="module")
def model(params):
    return port_model(params)


@pytest.fixture(scope="module")
def jax_walks(params):
    """The JAX `ShardedSampler` walk of each mesh over NOISE's first 3
    seeds, run once per module."""
    jmodel = JaxUNet2D(config=TINY_JAX)
    sampler = JaxSampler(lambda p, x, t: jmodel.apply({"params": p}, x, t),
                         JaxSchedule.create(),
                         JaxSamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                          scheduler="ddim"))
    sampler.initial_noise = lambda s: jnp.asarray(NOISE[np.asarray(s, np.int64)])

    @functools.cache
    def walk(name):
        axes = MESHES[name]
        n = int(np.prod(list(axes.values())))
        jsharded = jax_sharded.ShardedSampler(
            sampler, jax_mesh.create_mesh(axes, jax.devices()[:n]))
        assert jsharded.tp_axis == "model"
        with jax.default_matmul_precision("highest"):
            out = jsharded.sample(params, np.arange(3, dtype=np.uint32),
                                  capture_trajectory=True)
        return np.asarray(out["trajectory"]), list(out["seeds"])

    return walk


def _port_sampler(**kw):
    return DiffusionSampler(DiffusionSchedule.create(),
                            SamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                          scheduler="ddim", **kw), device="cpu")


@pytest.mark.parametrize("name", list(MESHES))
def test_tp_walk_matches_jax_and_unsharded(model, jax_walks, name):
    """3 seeds over a 1 x 2 and a 2 x 2 ('data', 'model') mesh (the 2 x 2
    pads to 4): the port's walk, its UNet channel-sharded over each row,
    against the JAX walk on the same mesh and against the port's unsharded
    walk; every attention block ran on its own heads."""
    want_traj, want_seeds = jax_walks(name)
    sampler = _port_sampler()
    seeds = np.arange(3, dtype=np.uint32)
    before = dict(tp.ROUTES)
    sharded = ShardedSampler(sampler, _tp_mesh(MESHES[name]))
    got = sharded.sample(model, seeds, capture_trajectory=True, initial_noise=NOISE[:3])
    assert sharded.tp_axis == "model"
    traj = got["trajectory"].numpy()
    assert traj.shape == want_traj.shape == (STEPS, 3, SIZE, SIZE, 3)
    np.testing.assert_allclose(traj[0], want_traj[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(traj[-1], want_traj[-1], rtol=1e-3, atol=1e-3)
    assert list(got["seeds"]) == want_seeds == list(seeds)
    # 6 attention blocks per evaluation (2 down, 1 mid, 3 up), one walk per
    # data shard
    assert tp.ROUTES[tp.HEADS] - before[tp.HEADS] == 6 * STEPS * MESHES[name]["data"]
    assert tp.ROUTES[tp.FIRST] == before[tp.FIRST]

    alone = sampler.sample(model, seeds, capture_trajectory=True, initial_noise=NOISE[:3])
    np.testing.assert_allclose(traj, alone["trajectory"].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["images"].numpy(), alone["images"].numpy(),
                               rtol=1e-5, atol=1e-5)
    assert list(got["noise_hashes"]) == list(alone["noise_hashes"])


def test_tp_replica_holds_the_slices_on_the_row(model):
    """Over [cpu, cpu:1] (two devices of a row): every sharded weight is
    two contiguous halves of the primary's, the replicated ones are the
    primary's, the replica is built once per row, and a forward equals the
    primary's."""
    row = [CPU, torch.device("cpu", 1)]
    twin = tp.tp_replica(model, row)
    assert tp.tp_replica(model, row) is twin and twin is not model
    assert tp.tp_replica(model, _cpus(2)) is not twin
    conv = twin.down_blocks[0].resnets[0].conv1
    assert isinstance(conv, tp.ShardedLayer) and conv.devices == row
    full = model.down_blocks[0].resnets[0].conv1.weight
    assert torch.equal(torch.cat([p.weight for p in conv.parts]), full)
    assert not isinstance(twin.conv_out, tp.ShardedLayer)     # 3 channels
    assert torch.equal(twin.conv_out.weight, model.conv_out.weight)
    x = torch.from_numpy(NOISE[:2]).permute(0, 3, 1, 2)
    t = torch.tensor([500, 20])
    with torch.no_grad():
        np.testing.assert_allclose(twin(x, t).numpy(), model(x, t).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_conditional_tp_walk_equals_unsharded():
    """The conditional UNet (its class embedding sharded on dim 1) walked
    with classifier-free guidance over a 1 x 2 mesh against its unsharded
    walk, mixed labels."""
    model = port_model(jax_params(TINY_COND_JAX, seed=2), TINY_COND)
    null = TINY_COND.num_class_embeds - 1
    sampler = DiffusionSampler(DiffusionSchedule.create(),
                               SamplerConfig(num_inference_steps=STEPS, image_size=SIZE,
                                             scheduler="ddim", guidance_scale=3.0),
                               device="cpu", conditional=True, null_label=null)
    seeds, labels = np.arange(3, dtype=np.uint32), np.asarray([0, 2, 1])
    twin = tp.tp_replica(model, _cpus(2))
    assert isinstance(twin.class_embedding, tp.ShardedLayer)
    kw = dict(capture_trajectory=True, initial_noise=NOISE[:3], class_labels=labels)
    got = ShardedSampler(sampler, _tp_mesh(MESHES["1x2"])).sample(model, seeds, **kw)
    alone = sampler.sample(model, seeds, **kw)
    np.testing.assert_allclose(got["trajectory"].numpy(), alone["trajectory"].numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp_size, group, route", [(2, 2, tp.HEADS), (4, 2, tp.FIRST),
                                                   (4, 1, tp.HEADS)],
                         ids=["heads-G2", "first-G-does-not-divide", "heads-G1"])
def test_head_sharded_attention_block_equals_unsharded(params, tp_size, group, route):
    """The mid block's attention (4 heads of 4) with fast math and
    heads_per_program G through the kernels' wrappers (their plain versions
    on the CPU): over T = 2 at G = 2 each device runs 2 heads; over T = 4 a G
    of 2 does not divide the 1 head per device, so q, k, v are gathered and
    the core runs over all heads on the first device (JAX's replicated
    Pallas call). Both equal the unsharded block; ROUTES counts the route."""
    model = port_model(params, use_fused_attention=True, fused_fast_math=True,
                       fused_heads_per_program=group)
    block = model.mid_block.attentions[0]
    twin = tp.tp_replica(model, _cpus(tp_size)).mid_block.attentions[0]
    assert isinstance(twin, tp.TPAttentionBlock) and twin.route == route
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 16, 4, 4)).astype(np.float32))
    before = dict(tp.ROUTES)
    with torch.no_grad():
        got, want = twin(x), block(x)
    assert tp.ROUTES[route] == before[route] + 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


def test_tp_gradients_flow_through_the_slices(params):
    """Under grad (the trainable attention pair) the sharded replica's input
    gradient equals the unsharded model's."""
    model = port_model(params)
    twin = tp.tp_replica(model, _cpus(2))
    x = torch.from_numpy(NOISE[:1]).permute(0, 3, 1, 2).contiguous()
    t = torch.tensor([300])
    grads = []
    for m in (twin, model):
        xi = x.clone().requires_grad_(True)
        m(xi, t).square().sum().backward()
        grads.append(xi.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-5, atol=1e-5)


# -- meshes, specs and refusals ----------------------------------------------------------

@pytest.mark.parametrize("axes", [{"data": 8}, {"data": 4, "model": 1}, {"data": 2, "model": 4},
                                  {"data": 1, "model": 8}],
                         ids=["1d", "model-1", "dp-tp", "tp"])
def test_tp_sampler_1d_mesh_unchanged(axes):
    """`tp_axis` is "model" exactly where the JAX `ShardedSampler` sets it
    (a 'model' axis above 1), and None on a 1-D 'data' mesh, whose shards
    keep their own devices; the data shards of a 2-D mesh are its rows'
    first devices."""
    n = int(np.prod(list(axes.values())))
    want = jax_sharded.ShardedSampler(None, jax_mesh.create_mesh(axes, jax.devices()[:n]))
    devices = [torch.device("cpu", i) for i in range(n)]
    got = ShardedSampler(_port_sampler(), create_mesh(axes, devices))
    assert got.tp_axis == want.tp_axis
    assert got.n_shards == want.n_shards == axes["data"]
    per = n // axes["data"]
    assert got.rows == [devices[i * per:(i + 1) * per] for i in range(axes["data"])]
    assert got.devices == [devices[i * per] for i in range(axes["data"])]


class _FakeGenerator:
    def __init__(self, batch_size):
        self.batch_size = batch_size
        self.mesh = None
        self.model_manager = type("MM", (), {"device": CPU})()

    def set_mesh(self, mesh):
        self.mesh = mesh


@pytest.mark.parametrize("spec, batch, want", [("4x2", 6, 8), ("1x2", 3, 3), ("2x4", 5, 6),
                                               ("2x1", 3, 4)])
def test_apply_dp_mesh_rounds_device_batch_up(spec, batch, want):
    """A 'DxT' spec builds the {'data': D, 'model': T} mesh the JAX
    `apply_dp_mesh` builds (on the CPU, D x T repeats of the CPU device)
    and rounds the device batch up by D only."""
    gen, jgen = _FakeGenerator(batch), _FakeGenerator(batch)
    mesh = port_mesh.apply_dp_mesh(gen, spec)
    jax_mesh.apply_dp_mesh(jgen, spec)
    assert gen.mesh is mesh and gen.batch_size == jgen.batch_size == want
    assert mesh.shape == dict(jgen.mesh.shape)
    assert port_mesh.parse_mesh_spec(spec) == dict(jgen.mesh.shape)
    assert [port_mesh.parse_mesh_spec(s) for s in ("4", "auto")] == [{"data": 4},
                                                                     {"data": -1}]


def test_multi_process_tp_is_refused_with_jax_message(model, monkeypatch):
    """A tensor-parallel mesh that spans processes raises before any walk,
    with the JAX package's message."""
    jsampler = type("S", (), {"initial_noise": lambda self, s: None})()
    jsharded = jax_sharded.ShardedSampler(
        jsampler, jax_mesh.create_mesh({"data": 1, "model": 2}, jax.devices()[:2]))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError) as want:
        jsharded.sample(None, np.arange(2, dtype=np.uint32))
    grid = np.empty((1, 2), dtype=object)
    grid[0, :] = _cpus(2)
    mesh = Mesh(grid, ("data", "model"), processes=2)
    with pytest.raises(NotImplementedError) as got:
        ShardedSampler(_port_sampler(), mesh).sample(model, np.arange(2, dtype=np.uint32))
    assert str(got.value) == str(want.value)


# -- a tensor-parallel block's sidecar and its --reproduce ---------------------------------

@pytest.fixture(scope="module")
def ckpt_dir(model, tmp_path_factory):
    from synt_isic_tpu_torch.io.pth import save_checkpoint

    path = tmp_path_factory.mktemp("tp_ckpt")
    save_checkpoint(model.state_dict(), str(path / "unet_MEL_best.pth"))
    return path


@pytest.fixture(scope="module")
def tp_block(ckpt_dir, tmp_path_factory):
    """Two MEL images in one block of `ImageGenerator` over a 1 x 2 mesh on
    [cpu, cpu:1] (two devices of a row): their PNGs and sidecars."""
    from synt_isic_tpu_torch.generator import ImageGenerator

    out = tmp_path_factory.mktemp("tp_block")
    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY, device="cpu")
    gen.set_inference_steps(STEPS)
    gen.set_generation_seed(4)
    gen.scheduler_kind = "ddim"
    gen.batch_size = 2
    gen.set_mesh(create_mesh(MESHES["1x2"], [CPU, torch.device("cpu", 1)]))
    assert gen.generate_images([("MEL", 2)], str(out))["generated"] == 2
    return sorted((out / "MEL").glob("*.json"))


def _reproduce_recording_mesh(sidecar, ckpt_dir, monkeypatch):
    """`reproduce_from_sidecar` on the CPU: (rc, the mesh it set on the
    generator, or None)."""
    from synt_isic_tpu_torch import cli
    from synt_isic_tpu_torch.generator import ImageGenerator

    meshes = []
    set_mesh = ImageGenerator.set_mesh
    monkeypatch.setattr(ImageGenerator, "set_mesh",
                        lambda self, mesh: (meshes.append(mesh), set_mesh(self, mesh))[1])
    rc = cli.reproduce_from_sidecar(str(sidecar), str(ckpt_dir), model_config=TINY,
                                    device="cpu")
    return rc, (meshes[-1] if meshes else None)


def _edited(sidecar, folder, change):
    """A copy of `sidecar`, with `change` applied to its block, beside a
    copy of its image, in `folder`."""
    import json
    import shutil

    meta = json.loads(sidecar.read_text())
    change(meta["block"])
    folder.mkdir()
    shutil.copy(sidecar.with_name(meta["filename"]), folder / meta["filename"])
    path = folder / sidecar.name
    path.write_text(json.dumps(meta))
    return path


def test_tp_block_records_its_mesh_and_reproduces_over_it(tp_block, ckpt_dir, monkeypatch,
                                                          capsys):
    """A 1 x 2 block's sidecars record `dp_mesh` (D x T, the JAX package's
    field) and the mesh's axes and devices; `--reproduce` rebuilds exactly
    that mesh, its 'model' axis included, and is byte-identical."""
    import json

    for sidecar in tp_block:
        block = json.loads(sidecar.read_text())["block"]
        assert block["dp_mesh"] == 2
        assert block["mesh"] == {"axes": {"data": 1, "model": 2}, "devices": ["cpu", "cpu:1"]}
    capsys.readouterr()
    rc, mesh = _reproduce_recording_mesh(tp_block[1], ckpt_dir, monkeypatch)
    assert rc == 0 and "byte-identical" in capsys.readouterr().out
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 1, "model": 2}
    assert mesh.rows() == [[CPU, torch.device("cpu", 1)]]
    redo = tp_block[1].with_name(tp_block[1].stem + "_reproduced.json")
    assert json.loads(redo.read_text())["block"]["mesh"]["axes"] == {"data": 1, "model": 2}


def test_dp_mesh_only_sidecar_rebuilds_a_1d_mesh(tp_block, ckpt_dir, tmp_path, monkeypatch):
    """A sidecar whose block has `dp_mesh` alone (as the JAX package, and the
    port before it recorded the mesh, write it) is rebuilt over a 1-D 'data'
    mesh of that many devices, as before: here 2 repeats of the CPU."""
    legacy = _edited(tp_block[0], tmp_path / "legacy", lambda b: b.pop("mesh"))
    rc, mesh = _reproduce_recording_mesh(legacy, ckpt_dir, monkeypatch)
    assert rc in (0, 1)      # the 1-D walk need not round as the sharded one did
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 2}
    assert [str(d) for d in mesh.devices.reshape(-1)] == ["cpu", "cpu"]


def test_recorded_device_the_host_lacks_exits_2(tp_block, ckpt_dir, tmp_path, monkeypatch,
                                                capsys):
    """A block recorded over a card this host does not have is refused with
    rc 2 before any model is built, and nothing is written."""
    missing = f"cuda:{torch.cuda.device_count()}"
    edited = _edited(tp_block[0], tmp_path / "missing",
                     lambda b: b["mesh"].update(devices=["cpu", missing]))
    capsys.readouterr()
    rc, mesh = _reproduce_recording_mesh(edited, ckpt_dir, monkeypatch)
    assert rc == 2 and mesh is None
    err = capsys.readouterr().err
    assert missing in err and "cannot be rebuilt here" in err
    assert not list(edited.parent.glob("*_reproduced*"))
