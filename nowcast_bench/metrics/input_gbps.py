"""input_gbps.<mix kind>: the bytes the port's ``wftk.input`` spans took
from host memory to the card over the window (the span log's ``bytes``),
in GB (1e9 bytes), over the device seconds of those spans' operations (the
copy and the dequantise; as ``input_ms``). Nothing when the port logs no
such span or moved no bytes from the host."""

from nowcast_bench import port_spans


def read(run):
    spans = port_spans.window_spans(run)
    if spans is None:
        return None
    b = sum(s.counts.get("bytes", 0) for s in spans if s.name == "wftk.input")
    s = run.trace.span_seconds("wftk.input")
    return b / s / 1e9 if b > 0 and s > 0 else None
