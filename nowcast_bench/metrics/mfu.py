"""mfu.<mix kind>: the whole call's share of the card's bf16 dense peak, in
%: the configuration's counted FLOPs (the system module's
``call_cost``) times the window's calls, over the window's
seconds and the published peak. The count does not depend on what
implements the call."""


def read(run):
    if run.peaks is None or run.window.seconds <= 0:
        return None
    return 100.0 * run.cost.flops * run.window.calls / run.window.seconds / run.peaks["bf16_flops"]
