"""`--reproduce SIDECAR_JSON` in the port, on the CPU with a tiny
checkpoint: every kind of sidecar regenerates byte for byte, every setting
a sidecar pins is honoured, and what this slice cannot reproduce, or what
another noise stream wrote, is refused without writing an image."""
import json
import shutil

import pytest
import torch

from synt_isic_tpu.generator import ImageGenerator as JaxImageGenerator
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.cli import ConsoleGenerator, reproduce_from_sidecar
from synt_isic_tpu_torch.generator import ImageGenerator, tf32_state

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params

STEPS = 2


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt")
    save_pth(flax_to_torch(jax_params()), str(path / "unet_MEL_best.pth"))
    save_pth(flax_to_torch(jax_params(seed=1)), str(path / "unet_MEL_distill2.pth"))
    return path


def _gen(ckpt_dir, **kw) -> ImageGenerator:
    gen = ImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY,
                         device="cpu", **kw)
    gen.set_inference_steps(STEPS)
    gen.set_generation_seed(3)
    return gen


def _reproduce(sidecar, ckpt_dir, **kw):
    return reproduce_from_sidecar(str(sidecar), str(ckpt_dir), model_config=TINY,
                                  device="cpu", **kw)


def _redo(sidecar):
    meta = json.loads(sidecar.read_text())
    original = sidecar.with_name(meta["filename"])
    return original, sidecar.with_name(f"{original.stem}_reproduced{original.suffix}")


def _generate(tmp_path, ckpt_dir, count=1, batch=1, configure=None, **kw):
    gen = _gen(ckpt_dir, **kw)
    gen.batch_size = batch
    if configure:
        configure(gen)
    assert gen.generate_images([("MEL", count)], str(tmp_path / "run"))["generated"] == count
    return sorted((tmp_path / "run" / "MEL").glob("*.json"))


def _assert_reproduces(sidecar, ckpt_dir, capsys=None, **kw):
    assert _reproduce(sidecar, ckpt_dir, **kw) == 0
    original, redo = _redo(sidecar)
    assert redo.read_bytes() == original.read_bytes()
    if capsys is not None:
        assert "byte-identical" in capsys.readouterr().out
    return json.loads(redo.with_suffix(".json").read_text())


def _edit(sidecar, tmp_path, change):
    """A copy of `sidecar` and its image in another directory, with the
    sidecar edited by `change`."""
    meta = json.loads(sidecar.read_text())
    change(meta)
    out = tmp_path / "edited"
    out.mkdir(exist_ok=True)
    shutil.copy(sidecar.with_name(meta["filename"]), out / meta["filename"])
    (out / sidecar.name).write_text(json.dumps(meta))
    return out / sidecar.name


def test_single_image_sidecar(tmp_path, ckpt_dir, capsys):
    gen = _gen(ckpt_dir)
    assert gen.generate_single_image("MEL", str(tmp_path / "one.png"), seed=17)[0]
    redo = _assert_reproduces(tmp_path / "one.json", ckpt_dir, capsys)
    assert redo["seed"] == 17 and "block" not in redo


def test_block_sidecar(tmp_path, ckpt_dir):
    sidecars = _generate(tmp_path, ckpt_dir, count=3, batch=3)
    meta = json.loads(sidecars[1].read_text())
    assert meta["block"]["index"] == 1 and len(meta["block"]["seeds"]) == 3
    assert _assert_reproduces(sidecars[1], ckpt_dir)["block"] == meta["block"]


def test_console_jpeg_sidecar(tmp_path, ckpt_dir):
    base = tmp_path / "console"
    (base / "checkpoints").mkdir(parents=True)
    shutil.copy(ckpt_dir / "unet_MEL_best.pth", base / "checkpoints")
    ConsoleGenerator(base_dir=str(base), model_config=TINY, inference_steps=STEPS,
                     batch_size=2, scheduler="ddim", seed=0, device="cpu"
                     ).generate({"MEL": 2})
    sidecar = sorted((base / "ISIC2018_Task3_synt").glob("*.json"))[1]
    redo = _assert_reproduces(sidecar, base / "checkpoints")
    assert redo["artifact"]["format"] == "jpeg" and redo["block"]["index"] == 1
    assert _redo(sidecar)[1].suffix == ".jpg"


def test_scheduler_kind_is_pinned(tmp_path, ckpt_dir):
    sidecar = _generate(tmp_path, ckpt_dir, configure=lambda g: setattr(
        g, "scheduler_kind", "ddim"))[0]
    assert json.loads(sidecar.read_text())["scheduler"]["kind"] == "ddim"
    _assert_reproduces(sidecar, ckpt_dir)
    wrong = _edit(sidecar, tmp_path, lambda m: m["scheduler"].update(kind="ddpm"))
    assert _reproduce(wrong, ckpt_dir) == 1


def test_dtype_is_pinned_and_legacy_retried(tmp_path, ckpt_dir, capsys):
    sidecar = _generate(tmp_path, ckpt_dir, compute_dtype=torch.bfloat16)[0]
    assert json.loads(sidecar.read_text())["scheduler"]["dtype"] == "bfloat16"
    _assert_reproduces(sidecar, ckpt_dir)
    legacy = _edit(sidecar, tmp_path, lambda m: m["scheduler"].pop("dtype"))
    capsys.readouterr()
    assert _reproduce(legacy, ckpt_dir) == 0
    out = capsys.readouterr()
    assert "retrying with bfloat16" in out.err and "legacy sidecar" in out.out


def test_model_variant_is_pinned(tmp_path, ckpt_dir):
    sidecar = _generate(tmp_path, ckpt_dir, model_variant="distill2")[0]
    assert json.loads(sidecar.read_text())["scheduler"]["model_variant"] == "distill2"
    _assert_reproduces(sidecar, ckpt_dir)
    best = _edit(sidecar, tmp_path, lambda m: m["scheduler"].update(model_variant="best"))
    assert _reproduce(best, ckpt_dir) == 1


def test_png_compress_level_is_pinned(tmp_path, ckpt_dir):
    sidecar = _generate(tmp_path, ckpt_dir, configure=lambda g: setattr(
        g, "png_compress_level", 1))[0]
    assert json.loads(sidecar.read_text())["scheduler"]["png_compress_level"] == 1
    assert _assert_reproduces(sidecar, ckpt_dir)["scheduler"]["png_compress_level"] == 1
    default = _edit(sidecar, tmp_path, lambda m: m["scheduler"].pop("png_compress_level"))
    assert _reproduce(default, ckpt_dir) == 1


def test_attention_fast_math_is_pinned(tmp_path, ckpt_dir, monkeypatch):
    """The flag is recorded and set again on regeneration (on the CPU the
    sampling model has no kernel, so the bytes do not depend on it; on the
    card `chip_smoke.py` shows that they do)."""
    sidecar = _generate(tmp_path, ckpt_dir, configure=lambda g: (
        g.model_manager.set_attention_tuning(heads_per_program=2, fast_math=True)))[0]
    assert json.loads(sidecar.read_text())["scheduler"]["attention_fast_math"] is True
    tuned = []
    init = ImageGenerator.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        tuned.append(self.model_manager)
    monkeypatch.setattr(ImageGenerator, "__init__", spy)
    redo = _assert_reproduces(sidecar, ckpt_dir)
    assert redo["scheduler"]["attention_fast_math"] is True
    assert tuned[-1].attention_fast_math and tuned[-1].attention_heads_per_program == 1


def test_tf32_is_recorded_for_f32_on_cuda_only(tmp_path, ckpt_dir, monkeypatch):
    """The TF32 switches change an f32 image's bytes on CUDA only: they are
    recorded there (whatever they are set to), and nowhere else."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert tf32_state(torch.device("cuda"), torch.float32) == {
        "tf32": {"cudnn": False, "matmul": True}}
    assert tf32_state(torch.device("cuda"), torch.bfloat16) == {}
    assert tf32_state(torch.device("cpu"), torch.float32) == {}
    sidecar = _generate(tmp_path, ckpt_dir)[0]
    assert "tf32" not in json.loads(sidecar.read_text())["scheduler"]


def test_recorded_tf32_is_set_for_the_regeneration_only(tmp_path, ckpt_dir, monkeypatch):
    """A sidecar's `tf32` switches are in force while its image is
    regenerated and restored afterwards; a sidecar without them leaves the
    process's switches as they are."""
    sidecar = _generate(tmp_path, ckpt_dir)[0]
    seen = []
    regenerate = ImageGenerator.regenerate_block_image
    single = ImageGenerator.generate_single_image

    def flags():
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))

    monkeypatch.setattr(ImageGenerator, "regenerate_block_image",
                        lambda self, *a, **kw: (flags(), regenerate(self, *a, **kw))[1])
    monkeypatch.setattr(ImageGenerator, "generate_single_image",
                        lambda self, *a, **kw: (flags(), single(self, *a, **kw))[1])
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    recorded = (not before[0], not before[1])
    edited = _edit(sidecar, tmp_path, lambda m: m["scheduler"].update(
        tf32={"cudnn": recorded[0], "matmul": recorded[1]}))
    _assert_reproduces(edited, ckpt_dir)
    assert seen == [recorded]
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
    _assert_reproduces(sidecar, ckpt_dir)
    assert seen == [recorded, before]


@pytest.mark.parametrize("field", ["conditional", "img2img", "dp_mesh"])
def test_later_slices_exit_2(tmp_path, ckpt_dir, field, capsys):
    """What cannot be reproduced exits 2 before any model is built: a block
    sampled over a mesh of more cards than the host has (mesh sidecars
    reproduce otherwise, `tests/test_torch_mesh_surfaces.py`), and an
    img2img run from an in-memory source (img2img sidecars with their source
    file reproduce, `tests/test_torch_img2img.py`), conditional or not."""
    sidecar = _generate(tmp_path, ckpt_dir, count=2, batch=2)[0]
    change = {"conditional": lambda m: (m["scheduler"].update(conditional=True,
                                                              guidance_scale=2.0),
                                        m.update(img2img={"strength": 0.5})),
              "img2img": lambda m: m.update(img2img={"strength": 0.5}),
              "dp_mesh": lambda m: m["block"].update(dp_mesh=64)}[field]
    edited = _edit(sidecar, tmp_path, change)
    # through the entry point: refused before any model is built; the mesh
    # block on the cards (the default device), of which no host has 64
    device = [] if field == "dp_mesh" else ["--device", "cpu"]
    assert cli.main(["--reproduce", str(edited), *device]) == 2
    said = {"conditional": "in-memory source", "img2img": "in-memory source",
            "dp_mesh": "cannot be rebuilt here"}[field]
    assert said in capsys.readouterr().err
    assert not _redo(edited)[1].exists()


@pytest.mark.parametrize("kind", ["unipc", "dpm_solver_sde", "dpm_solver"])
def test_multistep_sidecars(tmp_path, ckpt_dir, kind):
    """The multistep schedulers' sidecars reproduce byte for byte (the SDE
    from its step-noise streams), and the recorded kind is what pins them."""
    sidecar = _generate(tmp_path, ckpt_dir, configure=lambda g: (
        setattr(g, "scheduler_kind", kind), setattr(g, "timestep_spacing", "trailing")))[0]
    meta = json.loads(sidecar.read_text())
    assert (meta["scheduler"]["kind"], meta["scheduler"]["timestep_spacing"]) == (kind,
                                                                                 "trailing")
    _assert_reproduces(sidecar, ckpt_dir)
    wrong = _edit(sidecar, tmp_path, lambda m: m["scheduler"].update(kind="ddim"))
    assert _reproduce(wrong, ckpt_dir) == 1


def test_console_sde_jpeg_sidecar(tmp_path, ckpt_dir):
    base = tmp_path / "console"
    (base / "checkpoints").mkdir(parents=True)
    shutil.copy(ckpt_dir / "unet_MEL_best.pth", base / "checkpoints")
    ConsoleGenerator(base_dir=str(base), model_config=TINY, inference_steps=3,
                     batch_size=2, scheduler="dpm_solver_sde", timestep_spacing="trailing",
                     seed=0, device="cpu").generate({"MEL": 2})
    sidecar = sorted((base / "ISIC2018_Task3_synt").glob("*.json"))[1]
    redo = _assert_reproduces(sidecar, base / "checkpoints")
    assert redo["scheduler"]["kind"] == "dpm_solver_sde" and redo["block"]["index"] == 1


def test_refuses_a_jax_sidecar(tmp_path, ckpt_dir, capsys):
    """The JAX package draws its noise from other generators: the port
    recomputes the recorded seed's noise hash, refuses, and writes nothing."""
    jgen = JaxImageGenerator(checkpoints_dir=str(ckpt_dir), model_config=TINY_JAX)
    jgen.set_inference_steps(STEPS)
    jgen.set_generation_seed(3)
    assert jgen.generate_images([("MEL", 1)], str(tmp_path / "jax"))["generated"] == 1
    sidecar = tmp_path / "jax" / "MEL" / "ISIC_0000001.json"
    assert _reproduce(sidecar, ckpt_dir) == 1
    assert "MISMATCH" in capsys.readouterr().err
    assert not _redo(sidecar)[1].exists()
    # the same for a port sidecar whose hash was changed
    mine = _generate(tmp_path, ckpt_dir)[0]
    bad = _edit(mine, tmp_path, lambda m: m.update(noise_hash="deadbeef"))
    assert _reproduce(bad, ckpt_dir) == 1 and not _redo(bad)[1].exists()
