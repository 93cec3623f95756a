"""dispatch_ms.<mix kind>: host milliseconds from the call into the
rollout entry to its return, before the synchronise, averaged over the
window's calls."""


def read(run):
    d = run.window.dispatch_s
    return 1e3 * sum(d) / len(d) if d else None
