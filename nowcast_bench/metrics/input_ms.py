"""input_ms.<mix kind>: device milliseconds a call of the operations the
port's ``wftk.input`` spans launched (``to_input``'s host-to-device copy
and the uint8 dequantise), from the trace, summed over the window and
divided by its calls. Nothing when the port has no such span."""


def read(run):
    if run.trace is None or not run.window.calls:
        return None
    s = run.trace.span_seconds("wftk.input")
    return 1e3 * s / run.window.calls if s > 0 else None
