"""gn_roofline.<mix kind>: the GroupNorm kernel's share of its roofline,
in %: the least time the card could take for the window's GroupNorm calls
(the call shapes and element bytes of the system module's ``call_cost``;
x read once, y written once, scale and bias read once, at the published
memory rate; costs.gn_bound_s) over the device time of the port's
GroupNorm kernels (gn_cluster, gn_stats_*, gn_combine, gn_apply_*) in the
trace. Nothing when the trace holds no such kernel, the count holds no
GroupNorm call, or the card has no row of peaks."""

import re

from nowcast_bench import costs

KERNEL = re.compile(r"(^|[\s:])gn_(cluster|stats_rows|stats_cl|combine|apply_rows|apply_cl)\b")


def read(run):
    if run.trace is None or run.peaks is None or not run.cost.gn_calls:
        return None
    t = sum(s for name, s in run.trace.op_seconds().items() if KERNEL.search(name))
    if t <= 0:
        return None
    b = run.cost.gn_elem_bytes
    bound = costs.gn_bound_s(run.cost.gn_calls, b, b, run.peaks) * run.window.calls
    return 100.0 * bound / t
