"""The port's library generator (`ImageGenerator`), model manager tuning,
cache and configuration against the JAX package's, with a tiny checkpoint
on the CPU.

Images are compared where both generators are handed the same injected
initial noise (the pattern of `tests/test_golden_chain.py`), with DDIM
(eta 0), which is then deterministic: f32 images within 1e-4 (the tolerance
`tests/test_torch_sampler.py` holds a whole port walk to the JAX walk at).
Everything else that the two write is compared exactly, except what
differs by design or by clock: the noise hash (seed-derived noise comes
from other generators), the device name, the model's load time and
timestamp, and the CSV's `generated_at` (a file time).
"""
import csv
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from synt_isic_tpu import cache as jax_cache
from synt_isic_tpu import generator as jax_generator
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu.utils import config as jax_config
from synt_isic_tpu_torch import generator
from synt_isic_tpu_torch.cache import CacheManager
from synt_isic_tpu_torch.generator import ImageGenerator
from synt_isic_tpu_torch.utils import config
from synt_isic_tpu_torch.utils.config import CLASS_NAMES, ConfigManager

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params, tp_mesh

STEPS, BATCH, SEED = 2, 2, 5


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    save_pth(flax_to_torch(jax_params()), str(path / "unet_MEL_best.pth"))
    return path


def _port(ckpt_dir, **kw) -> ImageGenerator:
    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY,
                         device="cpu", **kw)
    gen.set_inference_steps(STEPS)
    gen.scheduler_kind = "ddim"
    gen.batch_size = BATCH
    gen.set_generation_seed(SEED)
    return gen


def _noise(seeds):
    """Injected initial noise: a numpy stream per seed."""
    size = TINY.sample_size
    return np.stack([np.random.default_rng(int(s)).normal(size=(size, size, 3))
                     for s in seeds]).astype(np.float32)


def _inject(gen, as_array, images):
    """Route every sampler the generator makes through injected noise and
    keep the float images it returns."""
    mm = gen.model_manager
    create = mm.create_sampler

    def create_sampler(*args, **kwargs):
        sampler = create(*args, **kwargs)

        def sample(model, seeds, **kw):
            out = sampler.sample(model, seeds, initial_noise=as_array(_noise(seeds)), **kw)
            images.append(np.asarray(out["images"]))
            return out
        return types.SimpleNamespace(sample=sample, initial_noise=sampler.initial_noise)
    mm.create_sampler = create_sampler


def _artifacts(out):
    pngs = sorted((out / "MEL").glob("*.png"))
    sidecars = {p.name: json.loads(p.with_suffix(".json").read_text()) for p in pngs}
    with open(out / "synthetic_dataset.csv", newline="") as f:
        rows = [{k: v for k, v in r.items() if k != "generated_at"}
                for r in csv.DictReader(f)]
    return pngs, sidecars, rows


def _pixels(path):
    return np.asarray(Image.open(path), np.int16)


def _keys(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix}
    return {prefix} | {k for key, v in tree.items() for k in _keys(v, f"{prefix}/{key}")}


CLOCK = ("noise_hash", "device")
MODEL_CLOCK = ("loaded_at", "load_seconds", "device")


def _without_clock(meta):
    meta = {k: v for k, v in meta.items() if k not in CLOCK}
    meta["model"] = {k: v for k, v in meta["model"].items() if k not in MODEL_CLOCK}
    return meta


def test_seed_bookkeeping_matches_jax():
    for cls in CLASS_NAMES + ["X"]:
        assert generator.class_seed_offset(cls) == jax_generator.class_seed_offset(cls)
    offsets = {c: generator.class_seed_offset(c) for c in CLASS_NAMES}
    for base in (0, 7, 0x7FFFFFF0):
        me = types.SimpleNamespace(base_seed=base)
        for cls, i in (("MEL", 0), ("NV", 3), ("VASC", 1000)):
            assert (ImageGenerator._seed_for(me, cls, i, offsets)
                    == jax_generator.ImageGenerator._seed_for(me, cls, i, offsets))
    assert 0 <= ImageGenerator._seed_for(types.SimpleNamespace(base_seed=None),
                                         "MEL", 0, {}) < 0x7FFFFFFF
    for spec in ("MEL=2.5,NV=2", "", None, " BCC = 1 ,"):
        assert generator.parse_guidance_map(spec) == jax_generator.parse_guidance_map(spec)
    with pytest.raises(ValueError):
        generator.parse_guidance_map("MEL")


def test_generate_images_writes_what_jax_writes(tmp_path, ckpt_dir):
    port_images, jax_images = [], []
    gen = _port(ckpt_dir)
    _inject(gen, lambda a: a, port_images)
    port = gen.generate_images([("MEL", 3)], str(tmp_path / "port"), postprocess=False)

    jgen = jax_generator.ImageGenerator(checkpoints_dir=str(ckpt_dir),
                                        model_config=TINY_JAX)
    jgen.set_inference_steps(STEPS)
    jgen.scheduler_kind = "ddim"
    jgen.batch_size = BATCH
    jgen.set_generation_seed(SEED)
    _inject(jgen, jnp.asarray, jax_images)
    jax_result = jgen.generate_images([("MEL", 3)], str(tmp_path / "jax"),
                                      postprocess=False)
    assert port["generated"] == jax_result["generated"] == 3

    pngs, sidecars, rows = _artifacts(tmp_path / "port")
    jpngs, jsidecars, jrows = _artifacts(tmp_path / "jax")
    assert [p.name for p in pngs] == [p.name for p in jpngs] == [
        "ISIC_0000001.png", "ISIC_0000002.png", "ISIC_0000003.png"]
    assert rows == jrows
    for name in sidecars:
        assert _keys(sidecars[name]) == _keys(jsidecars[name])
        assert _without_clock(sidecars[name]) == _without_clock(jsidecars[name])
        # the same injected noise hashes the same on both sides
        assert sidecars[name]["noise_hash"] == jsidecars[name]["noise_hash"]
    assert sidecars["ISIC_0000001.png"]["block"]["seeds"] == [
        (SEED + generator.class_seed_offset("MEL") + i) & 0x7FFFFFFF for i in range(2)]
    assert "block" not in sidecars["ISIC_0000003.png"]
    assert sidecars["ISIC_0000001.png"]["scheduler"]["dtype"] == "float32"
    assert sidecars["ISIC_0000001.png"]["device"] == "cpu"
    assert [i.shape[0] for i in port_images] == [2, 1]
    for mine, theirs in zip(port_images, jax_images):
        np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-4)
    # uint8 images: the f32 difference may cross a rounding boundary
    for p, q in zip(pngs, jpngs):
        assert _pixels(p).shape == (TINY.sample_size, TINY.sample_size, 3)
        assert np.abs(_pixels(p) - _pixels(q)).max() <= 1


def test_batched_equals_serial_and_seeds_reproduce(tmp_path, ckpt_dir):
    runs = {}
    for name, batch in (("batched", 3), ("serial", 1), ("again", 3)):
        gen = _port(ckpt_dir)
        gen.batch_size = batch
        result = gen.generate_images([("MEL", 3)], str(tmp_path / name), postprocess=False)
        assert result["generated"] == 3 and not result["stopped"]
        runs[name] = _artifacts(tmp_path / name)
    # a batch-size-dependent convolution may reorder f32 sums: uint8
    # images within one step
    for a, b in zip(runs["batched"][0], runs["serial"][0]):
        assert np.abs(_pixels(a) - _pixels(b)).max() <= 1
    # a fixed base seed gives the same files byte for byte
    assert [p.read_bytes() for p in runs["batched"][0]] == [
        p.read_bytes() for p in runs["again"][0]]
    seeds = [m["seed"] for m in runs["batched"][1].values()]
    assert seeds == [m["seed"] for m in runs["serial"][1].values()]
    assert [m["noise_hash"] for m in runs["batched"][1].values()] == [
        m["noise_hash"] for m in runs["serial"][1].values()]


def test_stop_generation_halts_between_blocks(tmp_path, ckpt_dir):
    """The hook runs before each round of the pipeline: the first round
    queues block 0, the second queues block 1 and writes block 0, so a
    stop at the third call leaves block 1, queued but unwritten, out."""
    gen = _port(ckpt_dir)
    calls, progress = [], []
    gen.set_progress_callback(lambda done, total, msg: progress.append((done, total)))

    def hook():
        calls.append(1)
        if len(calls) == 3:
            gen.stop_generation()
    gen.between_blocks_hook = hook
    result = gen.generate_images([("MEL", 6)], str(tmp_path / "out"))
    assert result["generated"] == BATCH and result["stopped"] and len(calls) == 3
    assert len(list((tmp_path / "out" / "MEL").glob("*.png"))) == BATCH
    assert progress == [(STEPS, 6 * STEPS), (2 * STEPS, 6 * STEPS)]
    assert gen.get_generation_status()["is_generating"] is False


def test_single_image_unknown_class_and_status(tmp_path, ckpt_dir):
    gen = _port(ckpt_dir)
    logs = []
    gen.set_log_callback(lambda msg, level: logs.append(level))
    ok, traj = gen.generate_single_image("MEL", str(tmp_path / "one.png"), seed=11)
    assert ok and traj.shape == (STEPS, TINY.sample_size, TINY.sample_size, 3)
    meta = json.loads((tmp_path / "one.json").read_text())
    assert meta["seed"] == 11 and "block" not in meta
    assert gen.generate_single_image("DF", str(tmp_path / "two.png"))[0] is False
    result = gen.generate_images([("DF", 2), ("MEL", 1)], str(tmp_path / "run"))
    assert result["generated"] == 1 and "error" in logs
    assert gen.validate_models() == {"MEL": True}
    status = gen.get_generation_status()
    assert status["loaded_models"] == ["MEL"] and status["device"] == "cpu"
    assert gen.generate_batch_images("MEL", str(tmp_path / "b"), 3, batch_size=3)[
        "generated"] == 3 and gen.batch_size == BATCH
    gen.cleanup()
    assert gen.model_manager.loaded_models == {} and gen.stop_requested


def test_later_slices_raise(ckpt_dir, monkeypatch, tmp_path):
    # the conditional family is ported: asking for it on a directory of
    # per-class checkpoints fails for want of the conditional metadata
    with pytest.raises(FileNotFoundError, match="unet_conditional_best.json"):
        ImageGenerator(checkpoints_dir=str(ckpt_dir), device="cpu", conditional=True)
    gen = _port(ckpt_dir)
    # data-parallel sampling is ported (tests/test_torch_mesh_surfaces.py),
    # and so is tensor parallelism: over a 1 x 2 ('data', 'model') mesh the
    # blocks walk on the row with the UNet channel-sharded, the images are
    # the unsharded generator's within one 8-bit level, and each sidecar
    # records the mesh's 2 devices, as the JAX generator does
    from PIL import Image

    gen.set_mesh(tp_mesh())
    assert gen.block_sampler().tp_axis == "model"
    assert gen.generate_images([("MEL", 3)], str(tmp_path / "tp"))["generated"] == 3
    plain = _port(ckpt_dir)
    assert plain.generate_images([("MEL", 3)], str(tmp_path / "plain"))["generated"] == 3
    sidecars = sorted((tmp_path / "tp" / "MEL").glob("*.json"))
    assert [json.loads(p.read_text())["block"]["dp_mesh"] for p in sidecars] == [2, 2, 2]
    for p in sidecars:
        a, b = (np.asarray(Image.open(d / "MEL" / p.with_suffix(".png").name), np.int16)
                for d in (tmp_path / "tp", tmp_path / "plain"))
        assert np.abs(a - b).max() <= 1
    gen.set_mesh(None)
    # integrated XAI (A7) is ported: its setters take their values
    analyzer = object()
    gen.set_xai_hook(print, every_n=3)
    gen.set_xai_analyzer(analyzer)
    gen.set_xai_frequency(0)
    assert (gen.xai_hook, gen.xai_hook_every_n, gen.xai_analyzer, gen.xai_frequency) == (
        print, 3, analyzer, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ImageGenerator(checkpoints_dir=str(ckpt_dir))


def test_attention_tuning_and_model_manager(tmp_path, ckpt_dir):
    cache = CacheManager(str(tmp_path / "cache"))
    gen = _port(ckpt_dir)
    mm = gen.model_manager
    mm.cache = cache
    assert mm.load_model("MEL")
    sampler = mm.create_sampler(STEPS)
    before = {k: v.clone() for k, v in mm.loaded_models["MEL"].state_dict().items()}
    mm.set_attention_tuning(heads_per_program=4, fast_math=True)
    assert (mm.attention_heads_per_program, mm.attention_fast_math) == (4, True)
    assert mm.create_sampler(STEPS) is not sampler        # samplers were cleared
    blocks = [m for m in mm.loaded_models["MEL"].modules()
              if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.fused_fast_math and b.fused_heads_per_program == 4
                          and not b.use_fused for b in blocks)   # no kernel on the CPU
    after = mm.loaded_models["MEL"].state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    mm.set_attention_tuning(heads_per_program=2)
    assert (mm.attention_heads_per_program, mm.attention_fast_math) == (2, True)
    assert gen.sidecar_scheduler()["attention_fast_math"] is True
    assert mm.validate_model("MEL") and not mm.validate_model("NV")
    info = mm.get_loaded_models_info()["MEL"]
    assert info["parameters"] == sum(v.numel() for v in before.values())
    assert set(info) == {"parameters", "parameters_millions", "model_path",
                         "loaded_at", "device", "load_seconds"}
    assert mm.change_device("cpu") and mm.model_metadata["MEL"]["device"] == "cpu"
    assert cache.get_cache_stats()["cached_models"] == 1
    assert mm.unload_model("MEL") and not mm.unload_model("MEL")


def test_change_device_rebuilds_with_the_new_device_switches(ckpt_dir, monkeypatch):
    """`change_device` takes the kernel switches of the new device and
    rebuilds the loaded models with them, keeping weights and knobs. The
    CPU has no kernel, so the switch is forced as CUDA would set it; the
    `gpu` test in test_torch_gpu.py moves a manager to the card for real."""
    gen = _port(ckpt_dir, compute_dtype=torch.bfloat16)
    mm = gen.model_manager
    assert mm.load_model("MEL")
    mm.set_attention_tuning(heads_per_program=2, fast_math=True)
    before = {k: v.clone() for k, v in mm.loaded_models["MEL"].state_dict().items()}
    sampler = mm.create_sampler(STEPS)
    assert (mm.use_fused_attention, mm.fast_norm) == (False, False)
    set_device = mm._set_device

    def as_on_cuda(device):
        set_device(device)
        mm.use_fused_attention, mm.fast_norm = True, True
    monkeypatch.setattr(mm, "_set_device", as_on_cuda)
    assert mm.change_device("cpu")
    model = mm.loaded_models["MEL"]
    blocks = [m for m in model.modules() if type(m).__name__ == "AttentionBlock"]
    assert blocks and all(b.use_fused and b.fast_norm and b.fused_fast_math
                          and b.fused_heads_per_program == 2 for b in blocks)
    after = model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert mm.create_sampler(STEPS) is not sampler         # samplers were cleared
    monkeypatch.undo()
    assert mm.change_device("cpu")                        # and back to the plain path
    assert not any(b.use_fused or b.fast_norm for b in mm.loaded_models["MEL"].modules()
                   if type(b).__name__ == "AttentionBlock")


def test_cache_manager_matches_jax(tmp_path, ckpt_dir):
    src = tmp_path / "unet_MEL_best.pth"
    src.write_bytes((ckpt_dir / "unet_MEL_best.pth").read_bytes())
    mine = CacheManager(str(tmp_path / "port"))
    theirs = jax_cache.CacheManager(str(tmp_path / "jax"))
    for cm in (mine, theirs):
        cached = cm.cache_model("MEL", str(src))
        assert cached.read_bytes() == src.read_bytes()
        assert cm.get_cached_model("MEL", str(src)) == cached
        tmp = tmp_path / f"tmp_{type(cm).__module__}.bin"
        tmp.write_bytes(b"x")
        cm.register_temp_file(str(tmp), "test")
        assert cm.cleanup_temp_files(max_age_s=-1) == 1 and not tmp.exists()
    assert mine.get_cache_stats()["total_size_bytes"] == theirs.get_cache_stats()[
        "total_size_bytes"] == src.stat().st_size
    assert CacheManager.file_hash(str(src)) == jax_cache.CacheManager.file_hash(str(src))
    assert not hasattr(mine, "cache_converted")
    # a changed source evicts the stale entry; the metadata persists
    src.write_bytes(b"changed")
    assert mine.get_cached_model("MEL", str(src)) is None
    assert CacheManager(str(tmp_path / "port")).metadata["models"] == {}
    assert mine.cleanup_old_models(max_age_s=-1) == 0
    mine.clear_all_cache()
    assert mine.get_cache_stats()["cached_models"] == 0


def test_config_manager_matches_jax(tmp_path, ckpt_dir, monkeypatch):
    for name in ("XAI_SAVE_EVERY_N", "XAI_INFERENCE_STEPS", "XAI_GENERATION_SEED",
                 "XAI_TARGET_CLASS", "XAI_DDPM_MODEL_PATH", "XAI_IMAGE_PATH",
                 "XAI_COALITIONAL_SHAP", "XAI_COALITIONAL_PERMUTATIONS"):
        monkeypatch.delenv(name, raising=False)
    assert config.default_config() == jax_config.default_config()
    path = tmp_path / "config.json"
    path.write_text(json.dumps({
        "generation": {"batch_size": 3, "inference_timesteps": STEPS},
        "compute": {"scheduler": "ddim", "png_compress_level": 1},
        "paths": {"checkpoints": str(ckpt_dir)}}))
    mine = ConfigManager(config_file=str(path), project_root=str(tmp_path))
    theirs = jax_config.ConfigManager(config_file=str(path), project_root=str(tmp_path))
    assert mine.config == theirs.config
    monkeypatch.setenv("XAI_SAVE_EVERY_N", "3")
    config.apply_env_overrides(mine.config)
    assert mine.get_xai_param("save_every_n_steps") == 3
    mine.set("compute.ddim_eta", 0.0)
    assert json.loads(path.read_text())["compute"]["ddim_eta"] == 0.0

    gen = ImageGenerator(config=mine, model_config=TINY, device="cpu")
    assert (gen.batch_size, gen.inference_steps, gen.scheduler_kind,
            gen.png_compress_level) == (3, STEPS, "ddim", 1)
    assert gen.cache_manager is not None and gen.get_available_classes() == ["MEL"]
    result = gen.generate_images([("MEL", 1)], str(tmp_path / "out"))
    assert result["generated"] == 1
    meta = json.loads((tmp_path / "out" / "MEL" / "ISIC_0000001.json").read_text())
    assert meta["scheduler"]["png_compress_level"] == 1
    assert "attention_fast_math" not in meta["scheduler"]


class _RecordingAnalyzer:
    """An integrated-XAI stub: records each call and returns a small
    JSON-able result (or raises, when told to)."""

    def __init__(self, fail: bool = False):
        self.calls, self.fail = [], fail

    def analyze_trajectory(self, trajectory, class_name, seed, inference_steps, filename,
                           file_path):
        if self.fail:
            raise RuntimeError("analysis failed")
        self.calls.append({"shape": tuple(np.shape(trajectory)), "class_name": class_name,
                           "seed": seed, "steps": inference_steps, "filename": filename,
                           "file": "/".join(file_path.split("/")[-2:]),
                           "type": type(trajectory).__name__})
        return {"class": class_name, "first": np.asarray(trajectory)[0, 0, 0].tolist()}


def _xai_json(out):
    return {p.name.rsplit("_", 2)[0]: json.loads(p.read_text())
            for p in sorted((out / "xai_results" / "MEL").glob("xai_*.json"))}


def test_integrated_xai_cadence_matches_jax(tmp_path, ckpt_dir):
    """Every xai_frequency-th image of a class has its whole trajectory
    analysed, the result written to xai_results/<class>/xai_<stem>_<ts>.json,
    in both packages; a failed analysis is logged and generation goes on."""
    port_rec, jax_rec, port_images, jax_images = (_RecordingAnalyzer(), _RecordingAnalyzer(),
                                                  [], [])
    gen = _port(ckpt_dir)
    _inject(gen, lambda a: a, port_images)
    jgen = jax_generator.ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY_JAX)
    jgen.set_inference_steps(STEPS)
    jgen.scheduler_kind = "ddim"
    jgen.batch_size = BATCH
    jgen.set_generation_seed(SEED)
    _inject(jgen, jnp.asarray, jax_images)
    for g, rec in ((gen, port_rec), (jgen, jax_rec)):
        g.set_save_trajectory(True)
        g.set_xai_analyzer(rec)
        g.set_xai_frequency(2)
    port = gen.generate_images([("MEL", 4)], str(tmp_path / "port"), postprocess=False)
    jax_result = jgen.generate_images([("MEL", 4)], str(tmp_path / "jax"), postprocess=False)
    assert port["generated"] == jax_result["generated"] == 4
    size = TINY.sample_size
    assert port_rec.calls == [dict(c, type="ndarray") for c in jax_rec.calls]
    assert [c["filename"] for c in port_rec.calls] == ["ISIC_0000002.png", "ISIC_0000004.png"]
    assert {c["shape"] for c in port_rec.calls} == {(STEPS, size, size, 3)}
    port_json, jax_json = _xai_json(tmp_path / "port"), _xai_json(tmp_path / "jax")
    assert list(port_json) == list(jax_json) == ["xai_ISIC_0000002", "xai_ISIC_0000004"]
    for stem in port_json:
        assert port_json[stem]["class"] == "MEL"
        np.testing.assert_allclose(port_json[stem]["first"], jax_json[stem]["first"],
                                   rtol=1e-4, atol=1e-4)
    # no analyzer, or trajectories off: no capture, no analysis
    gen = _port(ckpt_dir)
    gen.set_xai_analyzer(_RecordingAnalyzer())
    gen.set_save_trajectory(False)
    gen.generate_images([("MEL", 2)], str(tmp_path / "off"), postprocess=False)
    assert gen.xai_analyzer.calls == [] and not (tmp_path / "off" / "xai_results").exists()
    # a failing analysis is logged, and every image is still written
    gen = _port(ckpt_dir)
    logs = []
    gen.set_log_callback(lambda msg, level: logs.append((level, msg)))
    gen.set_xai_analyzer(_RecordingAnalyzer(fail=True))
    gen.set_xai_frequency(1)
    result = gen.generate_images([("MEL", 2)], str(tmp_path / "fail"), postprocess=False)
    assert result["generated"] == 2
    assert [lvl for lvl, msg in logs if "integrated XAI failed" in msg] == ["warning"] * 2
    assert not list((tmp_path / "fail").glob("xai_results/MEL/*.json"))


def test_trajectory_block_is_capped(ckpt_dir, tmp_path):
    """With integrated XAI on, a block's captured walk (every step, f32)
    stays within 4 GiB: at 1000 steps of 128² images that is 21 images."""
    from synt_isic_tpu_torch.models.unet2d import UNet2DConfig

    gen = _port(ckpt_dir)
    assert gen.model_manager.load_model("MEL")
    gen.model_manager.config = UNet2DConfig()      # sizes the frames at 128²
    gen.set_inference_steps(1000)
    gen.batch_size = 64
    seen = []

    def record(classes, seeds, capture):
        seen.append((len(seeds), capture))
        raise RuntimeError("recorded")

    gen._sample_block = record
    for analyzer, want in ((_RecordingAnalyzer(), (21, True)), (None, (40, False))):
        gen.set_xai_analyzer(analyzer)
        assert "recorded" in gen.generate_images([("MEL", 40)], str(tmp_path))["error"]
        assert seen.pop() == want


# -- the two-stage pipeline against the JAX generator ---------------------------------------

@pytest.fixture(scope="module")
def jax_gen(ckpt_dir):
    """One JAX generator for the pipeline tests, its samplers on injected noise."""
    jgen = jax_generator.ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY_JAX)
    jgen.set_inference_steps(STEPS)
    jgen.scheduler_kind = "ddim"
    jgen.batch_size = BATCH
    jgen.set_generation_seed(SEED)
    images = []
    _inject(jgen, jnp.asarray, images)
    return jgen, images


def _run_both(tmp_path, ckpt_dir, jax_gen, request, stop_at=None, analyzer=None):
    """`request` through the port's generator and the JAX one, a hook that
    counts its calls and stops at call `stop_at`; returns per side the
    result, the hook's calls and the artifacts, and the float images."""
    jgen, jax_images = jax_gen
    del jax_images[:]
    port_images = []
    gen = _port(ckpt_dir)
    _inject(gen, lambda a: a, port_images)
    sides = {}
    for name, g in (("port", gen), ("jax", jgen)):
        calls = []

        def hook(g=g, calls=calls):
            calls.append(1)
            if len(calls) == stop_at:
                g.stop_generation()
        g.between_blocks_hook = hook
        g.set_save_trajectory(analyzer is not None)
        g.set_xai_analyzer(analyzer)
        g.set_xai_frequency(1)
        result = g.generate_images(request, str(tmp_path / name), postprocess=False)
        g.between_blocks_hook = None
        g.set_xai_analyzer(None)
        pngs = sorted(p.relative_to(tmp_path / name) for p in (tmp_path / name).rglob("*.png"))
        with open(tmp_path / name / "synthetic_dataset.csv", newline="") as f:
            rows = [{k: v for k, v in r.items() if k != "generated_at"}
                    for r in csv.DictReader(f)]
        sidecars = [_without_clock(json.loads((tmp_path / name / p).with_suffix(".json")
                                              .read_text())) for p in pngs]
        sides[name] = ({k: v for k, v in result.items()
                        if k in ("generated", "requested", "stopped")},
                       len(calls), pngs, rows, sidecars)
    assert sides["port"] == sides["jax"]
    # after a stop from the hook the JAX loop still samples the next block,
    # if there is one, and drops it; the port queues none once stopped
    extra = len(jax_images) - len(port_images)
    assert extra in ((0, 1) if sides["port"][0]["stopped"] else (0,))
    assert [i.shape for i in port_images] == [i.shape for i in jax_images][:len(port_images)]
    for mine, theirs in zip(port_images, jax_images):
        np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-4)
    return sides["port"]


def test_pipeline_matches_jax_with_a_dead_class_mid_list(tmp_path, ckpt_dir, jax_gen):
    """MEL blocks of 2 and 1, DF (no checkpoint) dropped, then MEL again:
    the same rounds, files, rows and sidecars as the JAX pipeline."""
    result, calls, pngs, rows, _ = _run_both(
        tmp_path, ckpt_dir, jax_gen, [("MEL", 3), ("DF", 2), ("MEL", 1)])
    assert result == {"generated": 4, "requested": 6, "stopped": False}
    assert [str(p) for p in pngs] == [f"MEL/ISIC_000000{i}.png" for i in range(1, 5)]
    assert [r["isic_number"] for r in rows] == ["1", "2", "3", "4"]
    # one round per block queued or dropped, and the last write
    assert calls == 5


@pytest.mark.parametrize("stop_at, written", [(2, 0), (3, 2), (4, 4)])
def test_pipeline_stop_between_blocks_matches_jax(tmp_path, ckpt_dir, jax_gen, stop_at,
                                                  written):
    """A stop from the hook leaves the block in flight unwritten."""
    result, calls, pngs, _, _ = _run_both(tmp_path, ckpt_dir, jax_gen, [("MEL", 6)],
                                          stop_at=stop_at)
    assert result == {"generated": written, "requested": 6, "stopped": True}
    assert len(pngs) == written and calls == stop_at


def test_trajectory_mode_runs_one_block_at_a_time_as_jax(tmp_path, ckpt_dir, jax_gen):
    """With integrated XAI on, each round writes the block it queued (no
    pipeline), so a stop at the hook's second call keeps the first block."""
    result, calls, pngs, _, _ = _run_both(tmp_path, ckpt_dir, jax_gen, [("MEL", 4)],
                                          stop_at=2, analyzer=_RecordingAnalyzer())
    assert result == {"generated": BATCH, "requested": 4, "stopped": True}
    assert calls == 2 and len(pngs) == BATCH


def test_pipeline_reads_each_block_back_before_the_next_is_queued(tmp_path, ckpt_dir):
    """Block k's host copy is started right after its walk and before block
    k+1 is queued; its files are written after block k+1 is queued."""
    from synt_isic_tpu_torch import generator as port_generator

    events = []
    gen = _port(ckpt_dir)
    sample_block = gen._sample_block

    def recording_block(classes, seeds, capture):
        events.append(("queue", len(seeds)))
        return sample_block(classes, seeds, capture)
    gen._sample_block = recording_block

    class RecordingCopy(port_generator.HostCopy):
        def __init__(self, tensor):
            events.append(("copy", tensor.shape[0]))
            super().__init__(tensor)

        def numpy(self):
            events.append(("read", self._host.shape[0]))
            return super().numpy()
    write = gen._write_image_artifacts

    def recording_write(out, idx, *args, **kwargs):
        if idx == 0:
            events.append(("write", len(out["images"])))
        return write(out, idx, *args, **kwargs)
    gen._write_image_artifacts = recording_write
    original = port_generator.HostCopy
    port_generator.HostCopy = RecordingCopy
    try:
        assert gen.generate_images([("MEL", 5)], str(tmp_path), postprocess=False)[
            "generated"] == 5
    finally:
        port_generator.HostCopy = original
    assert events == [("queue", 2), ("copy", 2), ("queue", 2), ("copy", 2), ("read", 2),
                      ("write", 2), ("queue", 1), ("copy", 1), ("read", 2), ("write", 2),
                      ("read", 1), ("write", 1)]


# -- the noise hash -------------------------------------------------------------------------

def test_noise_hash_is_unchanged_and_read_lazily(ckpt_dir):
    """The hash of a seed's initial noise is today's bytes (SHA-256 of the
    f32 NHWC noise); `HostCopy` and `NoiseHashes`, which carry it from the
    card, give the same on the CPU."""
    import hashlib

    from synt_isic_tpu_torch.diffusion.sampler import HostCopy, NoiseHashes, noise_hash

    gen = _port(ckpt_dir)
    assert gen.model_manager.load_model("MEL")
    sampler = gen._sampler()
    seeds = np.asarray([5, 6], np.uint32)
    out = sampler.sample(gen.model_manager.loaded_models["MEL"], seeds)
    noise = sampler.initial_noise(seeds).numpy()
    today = [hashlib.sha256(np.ascontiguousarray(n, np.float32).tobytes()).hexdigest()[:16]
             for n in noise]
    assert out["noise_hashes"] == today and isinstance(out["noise_hashes"], list)
    # seeds 5 and 6 at 16x16x3, as the sampler hashed them before the pipeline
    assert today == ["f2233a04737af851", "0041086b9f2c025d"]
    lazy = NoiseHashes(HostCopy(torch.from_numpy(noise)))
    assert list(lazy) == today and len(lazy) == 2 and lazy[1] == noise_hash(noise[1])
    assert HostCopy(torch.ones(3)).numpy().tolist() == [1.0, 1.0, 1.0]
