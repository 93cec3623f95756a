"""tick_p95_ms (tick mixes): the 95th percentile (linear interpolation)
over every tick of the window, each timed on the card's clock from issue
to the synchronised forecast."""

import numpy as np


def read(run):
    if run.kind != "tick" or not run.window.tick_s:
        return None
    return float(np.percentile(np.asarray(run.window.tick_s) * 1e3, 95))
