"""The port's console generator and model manager against the JAX
package's, with a tiny checkpoint on the CPU: the same file names, CSV rows
and sidecars (seeds come from the same numpy generator on both sides; the
noise hashes and the device name differ by design)."""
import json

import numpy as np
import pytest
import torch

from synt_isic_tpu.cli import ConsoleGenerator as JaxConsoleGenerator
from synt_isic_tpu.io.convert import flax_to_torch
from synt_isic_tpu.io.pth import save_pth
from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.cli import ConsoleGenerator
from synt_isic_tpu_torch.model_manager import ModelManager

from tests.torch_port_fixtures import TINY, TINY_JAX, jax_params


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "unet_MEL_best.pth"
    save_pth(flax_to_torch(jax_params()), str(path))
    return path


def _base(tmp_path, checkpoint, name):
    base = tmp_path / name
    (base / "checkpoints").mkdir(parents=True)
    (base / "checkpoints" / checkpoint.name).write_bytes(checkpoint.read_bytes())
    return base


def _artifacts(base):
    images = sorted((base / "ISIC2018_Task3_synt").glob("*.jpg"))
    sidecars = {p.name: json.loads(p.read_text())
                for p in sorted((base / "ISIC2018_Task3_synt").glob("*.json"))}
    for meta in sidecars.values():
        meta.pop("noise_hash")
        meta.pop("device")
    csv = (base / "ISIC2018_Task3_GroundTruth_synt.csv").read_text().splitlines()
    return [p.name for p in images], sidecars, csv


def test_console_generator_writes_what_jax_writes(tmp_path, checkpoint):
    port_base = _base(tmp_path, checkpoint, "port")
    jax_base = _base(tmp_path, checkpoint, "jax")
    kw = dict(inference_steps=2, batch_size=2, seed=0, scheduler="ddim")
    gen = ConsoleGenerator(base_dir=str(port_base), model_config=TINY,
                           device="cpu", **kw)
    assert gen.generate({"MEL": 3, "VASC": 1}) == {"MEL": 3, "VASC": 0}
    JaxConsoleGenerator(base_dir=str(jax_base), model_config=TINY_JAX,
                        **kw).generate({"MEL": 3, "VASC": 1})
    names, sidecars, csv = _artifacts(port_base)
    assert names == ["ISIC_0034321.jpg", "ISIC_0034322.jpg", "ISIC_0034323.jpg"]
    assert (names, sidecars, csv) == _artifacts(jax_base)
    assert csv[0] == "image,MEL,NV,BCC,AKIEC,BKL,DF,VASC"
    assert csv[1].startswith("ISIC_0034321.jpg,1.0,0.0")
    # numbering resumes across instances
    gen2 = ConsoleGenerator(base_dir=str(port_base), model_config=TINY, device="cpu", **kw)
    assert gen2.last_isic_number == 34323


def test_main_lists_classes_on_cpu(tmp_path, checkpoint, capsys):
    base = _base(tmp_path, checkpoint, "list")
    assert cli.main(["--base-dir", str(base), "--device", "cpu", "--list-classes"]) == 0
    assert capsys.readouterr().out.split() == ["MEL"]


def test_interactive_menu(tmp_path, checkpoint, capsys, monkeypatch):
    base = _base(tmp_path, checkpoint, "menu")
    gen = ConsoleGenerator(base_dir=str(base), model_config=TINY, device="cpu")
    answers = iter(["MEL:2, NV:1", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli.interactive_menu(gen) == {"MEL": 2, "NV": 1}
    assert "1. MEL" in capsys.readouterr().out
    assert cli.interactive_menu(gen) is None


def test_main_interactive(tmp_path, checkpoint, monkeypatch):
    """`--interactive` reads the counts from stdin and generates them; an
    empty line generates nothing and exits 0."""
    base = _base(tmp_path, checkpoint, "interactive")
    argv = ["--base-dir", str(base), "--device", "cpu", "--interactive",
            "--steps", "2", "--scheduler", "unipc", "--seed", "0"]
    monkeypatch.setattr(cli, "ConsoleGenerator",
                        lambda **kw: ConsoleGenerator(model_config=TINY, **kw))
    monkeypatch.setattr("builtins.input", lambda prompt="": "")
    assert cli.main(argv) == 0
    assert not (base / "ISIC2018_Task3_synt").exists()
    monkeypatch.setattr("builtins.input", lambda prompt="": "MEL:2")
    assert cli.main(argv) == 0
    names, sidecars, _ = _artifacts(base)
    assert names == ["ISIC_0034321.jpg", "ISIC_0034322.jpg"]
    assert all(m["scheduler"]["kind"] == "unipc" for m in sidecars.values())


def test_parser_takes_every_scheduler():
    for name in ("ddpm", "ddim", "dpm_solver", "dpm_solver_sde", "unipc"):
        assert cli.build_parser().parse_args(["--scheduler", name]).scheduler == name
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--scheduler", "euler"])


def test_parser_defaults_to_cuda():
    args = cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.scheduler == "ddpm" and args.steps == 1000


def test_model_manager_never_drops_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelManager()
    with pytest.raises(RuntimeError):
        cli.main(["--list-classes"])
    assert ModelManager(device="cpu").device.type == "cpu"


def test_model_manager_validates_checkpoints(tmp_path, checkpoint):
    base = _base(tmp_path, checkpoint, "mm")
    ckpt_dir = base / "checkpoints"
    # legacy diffusers attention names load through the manifest's mapping
    state = torch.load(checkpoint, weights_only=True)
    n_params = sum(v.numel() for v in state.values())
    legacy = {k.replace("to_q", "query").replace("to_out.0", "proj_attn"): v
              for k, v in state.items()}
    torch.save(legacy, ckpt_dir / "unet_NV_best.pth")
    # a checkpoint of another architecture is refused, not sampled
    state.pop("conv_in.bias")
    torch.save(state, ckpt_dir / "unet_BCC_best.pth")
    mm = ModelManager(checkpoints_dir=str(ckpt_dir), model_config=TINY, device="cpu")
    assert mm.get_available_classes() == ["BCC", "MEL", "NV"]
    assert mm.load_model("MEL") and mm.load_model("NV")
    assert not mm.load_model("BCC") and not mm.load_model("DF")
    (ckpt_dir / "unet_VASC_best.pth").write_bytes(b"not a checkpoint")
    assert not mm.load_model("VASC")
    assert mm.available_variants("MEL") == ["best"]
    assert not mm.use_fused_attention and not mm.fast_norm
    for (a, b) in zip(mm.loaded_models["MEL"].state_dict().values(),
                      mm.loaded_models["NV"].state_dict().values()):
        assert torch.equal(a, b)
    assert sum(p.numel() for p in mm.loaded_models["MEL"].parameters()) == n_params
    assert mm.model_metadata["MEL"]["device"] == "cpu"
    assert mm.create_sampler(5) is mm.create_sampler(5)
