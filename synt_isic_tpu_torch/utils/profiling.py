"""Tracing and profiling helpers.

The port of `synt_isic_tpu/utils/profiling.py`:
  * `StepTimer`: per-phase wall timing, usable as the progress source of a
    UI (a copy);
  * `device_memory_stats`: the caching allocator's statistics of a CUDA
    device under the keys the JAX package reports (`{}` for the CPU);
  * `trace`: a context manager around `torch.profiler`, writing a trace
    that TensorBoard or Perfetto reads.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Iterator, Optional, Union

import torch


class StepTimer:
    """Accumulates per-phase timings: `with timer.phase("sample"): ...`."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_s": round(self.totals[name] / max(self.counts[name], 1), 5),
            }
            for name in self.totals
        }

    def report(self) -> str:
        lines = [f"{n}: {s['total_s']:.3f}s over {s['count']} "
                 f"({s['mean_s'] * 1000:.1f} ms each)"
                 for n, s in self.summary().items()]
        return "\n".join(lines)


def device_memory_stats(device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Bytes in use, peak and limit of a CUDA device (the current one when
    None) from PyTorch's caching allocator, with `mb_in_use` and `mb_peak`;
    `bytes_limit` is the device's total memory. `{}` for any other device."""
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    in_use = int(stats.get("allocated_bytes.all.current", 0))
    peak = int(torch.cuda.max_memory_allocated(device))
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak,
            "bytes_limit": int(total),
            "mb_in_use": round(in_use / (1024 ** 2), 1),
            "mb_peak": round(peak / (1024 ** 2), 1)}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """A `torch.profiler` trace of the block, CPU and (where there is one)
    CUDA activity, written to `log_dir` for TensorBoard or Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
