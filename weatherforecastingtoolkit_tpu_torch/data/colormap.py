"""VIL radar colormap for plotting (a copy of
weatherforecastingtoolkit_tpu/data/colormap.py; reference
sevir/sevir.py:1237-1268).

The 11-color NWS-style VIL palette with BoundaryNorm levels. Matplotlib is
imported lazily so headless/metric-only runs never pay for it.
"""

from __future__ import annotations

from copy import deepcopy

VIL_COLORS = [
    [0, 0, 0],
    [0.30196078431372547, 0.30196078431372547, 0.30196078431372547],
    [0.1568627450980392, 0.7450980392156863, 0.1568627450980392],
    [0.09803921568627451, 0.5882352941176471, 0.09803921568627451],
    [0.0392156862745098, 0.4117647058823529, 0.0392156862745098],
    [0.0392156862745098, 0.29411764705882354, 0.0392156862745098],
    [0.9607843137254902, 0.9607843137254902, 0.0],
    [0.9294117647058824, 0.6745098039215687, 0.0],
    [0.9411764705882353, 0.43137254901960786, 0.0],
    [0.6274509803921569, 0.0, 0.0],
    [0.9058823529411765, 0.0, 1.0],
]

VIL_LEVELS = [0.0, 16.0, 31.0, 59.0, 74.0, 100.0, 133.0, 160.0, 181.0, 219.0, 255.0]


def vil_cmap(encoded: bool = True):
    """(cmap, norm, vmin, vmax) — same contract (and the same intentionally
    preserved off-by-one bin behavior) as the reference/MIT original."""
    from matplotlib.colors import BoundaryNorm, ListedColormap

    cols = deepcopy(VIL_COLORS)
    lev = deepcopy(VIL_LEVELS)
    nil = cols.pop(0)
    under = cols[0]
    over = cols[-1]
    cmap = ListedColormap(cols)
    cmap.set_bad(nil)
    cmap.set_under(under)
    cmap.set_over(over)
    norm = BoundaryNorm(lev, cmap.N)
    return cmap, norm, None, None
