"""Profiling and tracing hooks (counterpart of
weatherforecastingtoolkit_tpu/training/profiling.py).

The aux-subsystem analog of the reference's observability tooling
(reference: Lightning `profiler='simple'` in ae_s2/train.py:307; scalene
CPU/IO profiles checked into pipeline/datasets/sevir/profiles/). On the card
the equivalents are:
  * `trace(...)` — a torch.profiler run (host and CUDA activity) whose
    Chrome trace lands in `log_dir`, viewable in Perfetto or
    chrome://tracing
  * `span(name, **counts)` and `spans()` — named spans of the port's own
    layers (the rollout's `wftk.*`). A span is on only while a
    `torch.profiler` session is open: it is then a `record_function` in
    the profiler's trace and one entry of an in-memory log (`spans()`, the
    newest `SPAN_LOG_SIZE`), stamped on the profiler's host clock, so the
    log can be laid over the device trace. With no session open a span
    costs one check and records nothing.
  * `StepTimer` — per-phase host-time accounting with a 'simple'-profiler
    style summary report; each phase is a `span`
  * `device_memory_stats()` — live device memory of one CUDA device
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Deque, Dict, Iterator, List, NamedTuple

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

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


SPAN_LOG_SIZE = 1 << 20


class Span(NamedTuple):
    """One closed span. ``start_ns`` and ``end_ns`` are on the profiler's
    host clock (``time.time_ns``), taken inside the span's
    ``record_function``; spans nest as their intervals do."""
    name: str
    start_ns: int
    end_ns: int
    counts: Dict[str, int]


_LOG: Deque[Span] = deque(maxlen=SPAN_LOG_SIZE)
_OFF = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "counts", "start_ns", "rf")

    def __init__(self, name: str, counts: Dict[str, int]):
        self.name, self.counts = name, counts

    def __enter__(self) -> "_OpenSpan":
        self.rf = record_function(self.name)
        self.rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        _LOG.append(Span(self.name, self.start_ns, end_ns, self.counts))


def span(name: str, **counts: int):
    """A context manager around one piece of the port's work. On only while
    a ``torch.profiler`` session is open: it then enters
    ``record_function(name)``, yields the open span, whose ``counts`` dict
    the block may add to, and on leaving logs a ``Span``. With no session
    open it yields None and records nothing."""
    if not _profiler_enabled():
        return _OFF
    return _OpenSpan(name, counts)


def spans() -> List[Span]:
    """The newest ``SPAN_LOG_SIZE`` closed spans, in the order they closed."""
    return list(_LOG)


class StepTimer:
    """Accumulates per-phase host times; report() prints a summary table.
    A phase's time is the host's, from entering it to leaving it, with no
    synchronise: device work still queued when it ends is not in it. Each
    phase is also a ``span``, so it shows in a profiler trace."""

    def __init__(self):
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self._sums[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def report(self) -> str:
        total = sum(self._sums.values()) or 1e-9
        lines = [f"{'phase':<24}{'calls':>8}{'host_s':>10}{'mean_ms':>10}{'%':>7}"]
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
