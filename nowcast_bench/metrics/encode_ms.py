"""encode_ms.<mix kind>: device milliseconds a call of the operations that
the system's ``encode`` stage (the callable it passes to ``wrap`` under
that name) launched inside its ``nb.encode`` spans, from the trace,
summed over the window and divided by its calls. A wait for the host
inside the span adds nothing."""


def read(run):
    if run.trace is None or not run.window.calls:
        return None
    s = run.trace.span_seconds("nb.encode")
    return 1e3 * s / run.window.calls if s > 0 else None
