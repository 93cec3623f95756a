"""The traced run's device trace: ``torch.profiler`` (CUPTI) over the whole
measured window, reduced straight from its raw events.

  * the window: the benchmark's ``nb.window`` span, on the profiler's clock;
  * busy_s: the union of every device operation's interval (kernels,
    copies, fills) inside the window; idle is the rest;
  * device_ops: device seconds summed by operation name;
  * span_seconds(name): device seconds of the operations that the host
    launched inside the spans of that name. The profiler lays each host
    span's launches out on the device as one interval (from the start of
    its first operation to the end of its last, the innermost span
    counting); the time of the operations inside those intervals is summed,
    so a wait for the host inside a span adds nothing;
  * idle_gaps: each stretch of the window with nothing on the device,
    named by the innermost host span or op running at its middle (the
    benchmark's ``nb.*`` spans, an aten op or a CUDA runtime call), seconds
    summed by that name.
Nothing is written to disk.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

TOP = 10
NAME_CHARS = 120


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: List[Tuple[str, int, int]] = field(default_factory=list)  # name, start, end (ns)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)  # on the device

    def span_seconds(self, name: str) -> float:
        starts = [s for _, s, _ in self.ops]
        total = 0
        for n, s0, e0 in self.spans:
            if n != name:
                continue
            i = max(bisect.bisect_left(starts, s0) - 1, 0)
            while i < len(self.ops) and self.ops[i][1] < e0:
                _, s, e = self.ops[i]
                total += max(0, min(e, e0) - max(s, s0))
                i += 1
        return total / 1e9

    def op_seconds(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for name, s, e in self.ops:
            out[name] += (e - s) / 1e9
        return dict(out)

    def breakdown(self) -> dict:
        top = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in top],
                "idle_gaps": [[n[:NAME_CHARS], s] for n, s in gaps]}


def span(name: str):
    """A named host span on the profiler's timeline."""
    return record_function(name)


def warm() -> None:
    """A profiler's first start in a process takes about a second; pay it
    in set-up."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@contextlib.contextmanager
def session():
    """Profile the body; yields a list that holds the DeviceTrace after."""
    holder: List[DeviceTrace] = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        with record_function("nb.window"):
            yield holder
        torch.cuda.synchronize()
    finally:
        prof.stop()
    holder.append(reduce(prof.profiler.kineto_results.events()))


def reduce(events) -> DeviceTrace:
    host, device, spans, lo, hi, thread = [], [], [], None, None, None
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # a host span's shadow on the device is no operation
            (spans if ev.is_user_annotation() else device).append((name, s, e))
        elif name == "nb.window":
            lo, hi, thread = s, e, ev.start_thread_id()
        else:
            host.append((s, e, name, ev.start_thread_id()))
    if lo is None:
        raise RuntimeError("the trace holds no nb.window span")
    ops = sorted(((n, max(s, lo), min(e, hi)) for n, s, e in device
                  if e > lo and s < hi), key=lambda o: o[1])
    busy, gaps, cursor = 0, [], lo
    for _, s, e in ops:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if hi > cursor:
        gaps.append((cursor, hi))
    main = sorted(((s, e, n) for s, e, n, t in host if t == thread),
                  key=lambda h: (h[0], -h[1]))
    return DeviceTrace((hi - lo) / 1e9, busy / 1e9, ops, _name_gaps(gaps, main), spans)


def _name_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost event of the window's host thread
    open at each gap's middle, in one sweep (the thread's events nest)."""
    out: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for g0, g1 in gaps:                     # in time order
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            ev = host[i]
            while stack and stack[-1][1] <= ev[0]:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        out[stack[-1][2] if stack else "host: no span"] += (g1 - g0) / 1e9
    return dict(out)
