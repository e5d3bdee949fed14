"""Smoke run of the PyTorch/CUDA port on one GPU: build, check, drive, time.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. the card (name and power limit as nvidia-smi gives them) and the TF32
     settings: PyTorch's defaults (cuDNN convolutions in TF32, matrix
     products in full f32) for the CLI run and every timing; the
     whole-network comparisons of phases 4 and 5 run their convolutions in
     full f32 on both sides, since under TF32 a 1e-6 change in an attention
     output can flip a TF32 rounding (2^-11 relative) downstream;
  2. build every hand-written kernel from the sources in the checkout;
  3. each kernel against its plain PyTorch version at the main path's
     shapes, in both layouts, then timed beside its bound, the plain
     version and one PyTorch library call that computes the same function;
  4. the full-width UNet2D (random weights from a seed), one forward with
     the kernel and one with the plain attention, f32 and bf16;
  5. the main path through its entry point: `synt_isic_tpu_torch.cli.main`
     generating 8 MEL images, batch 8, DDIM 10 steps, from a random
     full-width checkpoint; the kernel's launch count must read exactly
     6 attention calls x 10 steps;
  6. a JSON line of per-kernel numbers, then as the last line
     {"ok": true, "device": {...}}.

Imports nothing of JAX or of the JAX package. Needs one CUDA device; exits
non-zero without one.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from synt_isic_tpu_torch import cli
from synt_isic_tpu_torch.model_manager import ModelManager
from synt_isic_tpu_torch.models.unet2d import UNet2D, UNet2DConfig
from synt_isic_tpu_torch.ops import attention, native

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # f32 off the tensor cores
SFU_EXP_PER_S = 16 * 132 * 1.98e9   # exponentials: 16 per clock per SM at boost clock

# f32: the tolerance the Pallas kernel is held to against its einsum
# reference (tests/test_pallas_ops.py). bf16: the kernel and the plain
# version round the output (and the plain version the probabilities) to
# bf16 at different points, so they may differ by one bf16 ulp of the
# output, 2^-6 at |x| < 4; randn inputs give |out| < 4.
TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}
# whole UNet, kernel vs plain attention, as max|diff| / max|plain|: the
# attention outputs differ by the rounding above, which the remaining
# layers carry to the output; f32 (full-f32 convolutions) allows 1e-4, bf16
# (every layer rounds to 8 bits of mantissa) 5e-2.
UNET_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}

MAIN_SHAPES = [(8, 32, 1024, 8), (8, 32, 256, 8)]   # the UNet's 6 calls at batch 8
CLI_STEPS, CLI_BATCH = 10, 8
ATTENTION_CALLS_PER_UNET = 6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def full_f32_convolutions():
    """cuDNN convolutions in full f32 (no TF32) inside the block."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype) -> tuple[float, str, float]:
    """(bound ms, what sets it, exponential ms) for one attention call:
    q, k, v read once and out written once, against 2 contractions of
    2*B*H*T^2*D flops each at the dtype's peak."""
    b, h, t, d = shape
    itemsize = torch.empty((), dtype=dtype).element_size()
    bytes_ms = 4 * b * h * t * d * itemsize / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4 * b * h * t * t * d / PEAK_FLOPS[dtype] * 1e3
    exp_ms = b * h * t * t / SFU_EXP_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), exp_ms


def phase_card() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    return {"card": smi, "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    t0 = time.time()
    logs = native.build(["attention_fwd"])
    print(f"[build] attention_fwd in {time.time() - t0:.1f} s", flush=True)
    for line in logs.get("attention_fwd", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}", flush=True)


def phase_kernel() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = MAIN_SHAPES + [(2, 4, 64, 4)]
    report = {}
    for shape in shapes:
        b, h, t, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            want = attention.attention_reference(q, k, v).float()
            # contiguous (B, H, T, D), and the (B, T, C) projection layout
            # split into heads by a view, as the UNet hands it over
            btc = [z.transpose(1, 2).reshape(b, t, h * d) for z in (q, k, v)]
            views = [z.view(b, t, h, d).transpose(1, 2) for z in btc]
            for layout, args in (("BHTD", (q, k, v)), ("BTC", views)):
                got = attention.fused_attention(*args)
                torch.cuda.synchronize()
                check(got.stride() == args[0].stride(), f"{layout} output strides")
                err = (got.float() - want).abs()
                max_abs = err.max().item()
                max_rel = (err / want.abs().clamp_min(1e-3)).max().item()
                tol = TOL[dtype]
                ok = torch.allclose(got.float(), want, rtol=tol, atol=tol)
                print(f"[kernel] {shape} {str(dtype)[6:]:8s} {layout}: max_abs_err "
                      f"{max_abs:.3e} max_rel_err {max_rel:.3e} (atol=rtol={tol:.3g}) "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                check(ok, f"attention kernel disagrees with plain at {shape} {dtype} {layout}")
                report[(shape, dtype, layout)] = max_abs
            if shape in MAIN_SHAPES:
                kernel_ms = cuda_ms(lambda: attention.fused_attention(*views))
                plain_ms = cuda_ms(lambda: attention.attention_reference(q, k, v))
                library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                bound, bound_by, exp_ms = attention_bound_ms(shape, dtype)
                print(f"[time] attention {shape} {str(dtype)[6:]}: kernel {kernel_ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                      f"{bound:.4f} ms ({bound_by}), exponentials on the SFUs "
                      f"{exp_ms:.4f} ms", flush=True)
                report[(shape, dtype, "time")] = dict(
                    ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                    bound_ms=bound, bound_by=bound_by)
    return report


def phase_unet() -> dict:
    torch.manual_seed(0)
    state = UNet2D(UNet2DConfig()).state_dict()
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 3, 128, 128, generator=g, device="cuda")
    t = torch.tensor([999, 900, 700, 500, 300, 100, 10, 0], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        outs = {}
        for fused in (True, False):
            model = UNet2D(UNet2DConfig(), dtype=dtype, use_fused_attention=fused,
                           fast_norm=dtype != torch.float32)
            model.load_state_dict(state)
            model = model.cuda().eval()
            before = attention.LAUNCHES[attention.KERNEL]
            with torch.inference_mode(), full_f32_convolutions():
                outs[fused] = model(x, t)
            torch.cuda.synchronize()
            launched = attention.LAUNCHES[attention.KERNEL] - before
            check(launched == (ATTENTION_CALLS_PER_UNET if fused else 0),
                  f"UNet forward launched the kernel {launched} times")
        check(bool(torch.isfinite(outs[True]).all()), "UNet output not finite")
        check(outs[True].shape == x.shape, f"UNet output shape {outs[True].shape}")
        err = (outs[True] - outs[False]).abs().max().item()
        scale = outs[False].abs().max().item()
        print(f"[unet] full width, batch 8, {str(dtype)[6:]}: kernel vs plain attention "
              f"max_abs_err {err:.3e} (max |out| {scale:.3f}; allowed "
              f"{UNET_TOL[dtype]:.0e} x max |out|)", flush=True)
        check(err <= UNET_TOL[dtype] * scale, f"UNet {dtype} kernel vs plain")
    return state


def phase_cli(state: dict, card: str) -> int:
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp)
        (base / "checkpoints").mkdir()
        torch.save(state, base / "checkpoints" / "unet_MEL_best.pth")
        argv = ["--base-dir", str(base), "--class-counts", f"MEL:{CLI_BATCH}",
                "--batch", str(CLI_BATCH), "--scheduler", "ddim",
                "--steps", str(CLI_STEPS), "--seed", "0", "--device", "cuda"]
        for key in attention.LAUNCHES:
            attention.LAUNCHES[key] = 0
        t0 = time.time()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(attention.LAUNCHES)
        check(rc == 0, f"cli.main returned {rc}")
        out = base / "ISIC2018_Task3_synt"
        jpgs = sorted(out.glob("ISIC_*.jpg"))
        sidecars = sorted(out.glob("ISIC_*.json"))
        rows = (base / "ISIC2018_Task3_GroundTruth_synt.csv").read_text().splitlines()[1:]
        check(len(jpgs) == CLI_BATCH and len(sidecars) == CLI_BATCH
              and len(rows) == CLI_BATCH,
              f"CLI wrote {len(jpgs)} images, {len(sidecars)} sidecars, {len(rows)} rows")
        for p in jpgs:
            arr = np.asarray(Image.open(p))
            check(arr.shape == (128, 128, 3), f"{p.name} has shape {arr.shape}")
        meta = json.loads(sidecars[0].read_text())
        check(meta["scheduler"]["kind"] == "ddim" and meta["device"].startswith("cuda"),
              f"sidecar {meta}")
        want = ATTENTION_CALLS_PER_UNET * CLI_STEPS
        print(f"[cli] wrote {len(jpgs)} JPEGs, sidecars and CSV rows in {wall:.3f} s "
              f"(cold: model load, first-call set-up, JPEG writes included); "
              f"attention_fwd launches {launches[attention.KERNEL]} (want {want})",
              flush=True)
        check(launches[attention.KERNEL] == want,
              f"main path launched attention_fwd {launches[attention.KERNEL]} times, "
              f"not {want}")

        # the same sampler, warm, timed alone; and its output against the
        # plain attention on the same seeds
        mm = ModelManager(checkpoints_dir=str(base / "checkpoints"), device="cuda")
        check(mm.load_model("MEL"), "ModelManager.load_model")
        sampler = mm.create_sampler(CLI_STEPS, scheduler="ddim")
        seeds = np.arange(CLI_BATCH, dtype=np.uint32)
        sampler.sample(mm.loaded_models["MEL"], seeds)
        runs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.time()
            sampler.sample(mm.loaded_models["MEL"], seeds)
            torch.cuda.synchronize()
            runs.append(time.time() - t0)
        sample_s = sorted(runs)[1]
        plain_model = UNet2D(mm.config, dtype=mm.dtype, use_fused_attention=False,
                             fast_norm=mm.fast_norm)
        plain_model.load_state_dict(state)
        with full_f32_convolutions():
            fused = sampler.sample(mm.loaded_models["MEL"], seeds)["images"]
            plain = sampler.sample(plain_model.cuda().eval(), seeds)["images"]
        check(bool(torch.isfinite(fused).all()), "sampled images not finite")
        check(fused.shape == (CLI_BATCH, 128, 128, 3), f"images shape {fused.shape}")
        err = (fused - plain).abs().max().item()
        print(f"[cli] DDIM {CLI_STEPS} steps, batch {CLI_BATCH}, f32, warm, median of "
              f"3 ({', '.join(f'{r:.4f}' for r in runs)} s): "
              f"{sample_s / CLI_STEPS:.5f} s/step, {CLI_BATCH / sample_s:.2f} images/s "
              f"on {card}; images kernel vs plain attention (full-f32 convolutions) "
              f"max_abs_err {err:.3e}", flush=True)
        check(err <= 1e-3, "sampled images, kernel vs plain attention")
    return launches[attention.KERNEL]


def main() -> int:
    card = phase_card()
    phase_build()
    kernel_report = phase_kernel()
    state = phase_unet()
    launches = phase_cli(state, card["card"])

    shape, dtype = MAIN_SHAPES[0], torch.float32
    timing = kernel_report[(shape, dtype, "time")]
    line = {"kernels": [{
        "name": "attention_fwd",
        "route": "cuda",
        "source": "synt_isic_tpu_torch/csrc/attention_fwd.cu",
        "replaces": "synt_isic_tpu/ops/pallas/attention.py:28",
        "launches": launches,
        "max_abs_err": kernel_report[(shape, dtype, "BTC")],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "shape": list(shape),
        "dtype": "float32",
    }]}
    print(json.dumps(line), flush=True)
    print(card["card"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card["kind"],
                                             "count": card["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
