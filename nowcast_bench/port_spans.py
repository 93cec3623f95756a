"""The port's own spans laid over a traced run's device trace.

The port logs a span (``training/profiling.py::spans``) for each piece of
its rollout while a profiler session is open, stamped on the profiler's
host clock: the call spans ``wftk.pipeline``, ``wftk.init``,
``wftk.step``, ``wftk.ensemble`` and, inside them, ``wftk.input`` (with
the ``bytes`` it took from host memory), ``wftk.encode``, ``wftk.window``,
``wftk.forecast`` and ``wftk.decode``.

Each stretch with nothing on the device between the window's first and
last operation is charged, as ``trace.py`` names its idle gaps, to the
innermost of these spans open on the host at the stretch's middle, and
so to the layer the card waited for (``LAYER``); a stretch with no port
span open is the caller's. A port without the span log gives nothing,
and every reader of these numbers then reports nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from . import trace as tr

LAYER = {
    "wftk.pipeline": "input", "wftk.init": "input", "wftk.step": "input",
    "wftk.ensemble": "input", "wftk.input": "input",
    "wftk.encode": "encode",
    "wftk.window": "forecast", "wftk.forecast": "forecast",
    "wftk.decode": "decode",
}
LAYERS = ("input", "encode", "forecast", "decode", "caller")


def log() -> Optional[list]:
    """The port's span log, or None when the port keeps none."""
    from weatherforecastingtoolkit_tpu_torch.training import profiling
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


def in_window(trace, spans) -> list:
    """The spans that overlap the trace's operations."""
    if not trace.ops:
        return []
    lo, hi = trace.ops[0][1], max(e for _, _, e in trace.ops)
    return [s for s in spans if s.end_ns > lo and s.start_ns < hi]


def gaps(ops) -> List[tuple]:
    """The stretches between the device's operations (sorted by start)."""
    out, cursor = [], None
    for _, s, e in ops:
        if cursor is not None and s > cursor:
            out.append((cursor, s))
        cursor = e if cursor is None else max(cursor, e)
    return out


def waits(trace, spans) -> Dict[str, float]:
    """Idle seconds by the layer of the innermost port span open at each
    gap's middle (``LAYERS``; "caller" where none is)."""
    host = sorted(((s.start_ns, s.end_ns, LAYER[s.name]) for s in spans
                   if s.name in LAYER), key=lambda h: (h[0], -h[1]))
    named = tr._name_gaps(gaps(trace.ops), host)
    out = {layer: named.get(layer, 0.0) for layer in LAYERS}
    out["caller"] = named.get("host: no span", 0.0)
    return out


def window_spans(run) -> Optional[list]:
    """The port's spans inside a traced run's window, or None when the run
    has no trace or the port logged none there."""
    if run.trace is None or not run.window.calls:
        return None
    spans = log()
    if spans is None:
        return None
    return in_window(run.trace, spans) or None


def wait_ms(run, layer: str) -> Optional[float]:
    """Idle milliseconds a call charged to ``layer``."""
    spans = window_spans(run)
    if spans is None:
        return None
    return 1e3 * waits(run.trace, spans)[layer] / run.window.calls
