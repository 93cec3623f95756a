"""decode_ms.<mix kind>: as encode_ms, over the ``nb.decode`` spans around
the system's ``decode`` stage (every forecast frame of every sequence)."""


def read(run):
    if run.trace is None or not run.window.calls:
        return None
    s = run.trace.span_seconds("nb.decode")
    return 1e3 * s / run.window.calls if s > 0 else None
