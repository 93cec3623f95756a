"""Profiling and tracing hooks (counterpart of
weatherforecastingtoolkit_tpu/training/profiling.py).

The aux-subsystem analog of the reference's observability tooling
(reference: Lightning `profiler='simple'` in ae_s2/train.py:307; scalene
CPU/IO profiles checked into pipeline/datasets/sevir/profiles/). On the card
the equivalents are:
  * `trace(...)` — a torch.profiler run (host and CUDA activity) whose
    Chrome trace lands in `log_dir`, viewable in Perfetto or
    chrome://tracing
  * `StepTimer` — per-phase wall-time accounting with a 'simple'-profiler
    style summary report
  * `device_memory_stats()` — live device memory of one CUDA device
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

from ..utils.device import DeviceLike, resolve_device


@contextlib.contextmanager
def trace(log_dir: str, host_profiling: bool = True) -> Iterator:
    """Profile the enclosed block (CUDA activity, and host activity with
    `host_profiling`) and write `log_dir/trace.json`. Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` the caller
    may read after the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_profiling:
        activities.insert(0, ProfilerActivity.CPU)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Accumulates per-phase wall times; report() prints a summary table."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sums[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def report(self) -> str:
        total = sum(self._sums.values()) or 1e-9
        lines = [f"{'phase':<24}{'calls':>8}{'total_s':>10}{'mean_ms':>10}{'%':>7}"]
        for name, s in sorted(self._sums.items(), key=lambda kv: -kv[1]):
            n = self._counts[name]
            lines.append(f"{name:<24}{n:>8}{s:>10.2f}{1000 * s / n:>10.1f}"
                         f"{100 * s / total:>6.1f}%")
        return "\n".join(lines)

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()


def device_memory_stats(device: DeviceLike = None) -> Dict[str, float]:
    """Live memory stats (bytes and counts, ``torch.cuda.memory_stats``) of
    one CUDA device; ``None`` means ``cuda``, and no GPU raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"device_memory_stats reads a CUDA device, not {dev}")
    return dict(torch.cuda.memory_stats(dev))
