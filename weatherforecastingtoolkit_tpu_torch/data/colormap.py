"""VIL radar colormap for plotting (counterpart of
weatherforecastingtoolkit_tpu/data/colormap.py; reference
sevir/sevir.py:1237-1268).

The 11-color NWS-style VIL palette with BoundaryNorm levels. ``vil_cmap``
keeps the matplotlib contract (matplotlib is imported when it is called).
``vil_rgb`` and ``reds_rgb`` give the same pixels with numpy alone, as
matplotlib's ``cmap(norm(x), bytes=True)`` does: ``vil_rgb`` bins with
``BoundaryNorm``'s semantics and ``vil_cmap``'s under, over and bad colors;
``reds_rgb`` looks uint8 values up in matplotlib's 256-entry ``Reds`` table
(``Normalize(0, 255)``), copied below.
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np

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

# matplotlib's "Reds" as RGB bytes, entries 0..255 (cmap(i, bytes=True))
_REDS_HEX = (
    "fff5f0fef4effef3eefef3edfef2ecfef1ebfef1eafef0e9feefe8feefe7feeee6feede5"
    "feede4feece3feebe2feebe1feeae0fee9e0fee9dffee8defee7ddfee7dcfee6dbfee5da"
    "fee5d9fee4d8fee3d7fee3d6fee2d5fee1d4fee1d3fee0d2fddfd1fdded0fdddcefddccd"
    "fddbcbfddacafdd8c8fdd7c7fdd6c5fdd5c3fdd4c2fdd3c0fdd1bffdd0bdfdcfbcfdceba"
    "fccdb9fcccb7fccab6fcc9b4fcc8b3fcc7b1fcc6affcc5aefcc3acfcc2abfcc1a9fcc0a8"
    "fcbfa6fcbea5fcbda3fcbba2fcbaa0fcb99ffcb89dfcb69cfcb59afcb499fcb297fcb196"
    "fcb094fcaf93fcad91fcac90fcab8efca98dfca88bfca78afca689fca487fca386fca284"
    "fca083fc9f81fc9e80fc9d7efc9b7dfc9a7bfc997afc9778fc9677fc9575fc9474fc9272"
    "fb9171fb9070fb8f6ffb8d6dfb8c6cfb8b6bfb8a6afb8868fb8767fb8666fb8464fb8363"
    "fb8262fb8161fb7f5ffb7e5efb7d5dfb7c5cfb7a5afb7959fb7858fb7757fb7555fb7454"
    "fb7353fb7252fb7050fb6f4ffb6e4efb6d4dfb6b4bfb6a4afa6949fa6748fa6647f96446"
    "f96345f86144f86043f85e42f75d42f75b41f75a40f6593ff6573ef5563df5543cf5533b"
    "f4513af45039f44e38f34d37f34b36f24a35f24834f24733f14532f14432f14231f04130"
    "f03f2fef3e2eef3d2def3b2cee3a2bed392bec382aea372ae93529e83429e73328e63228"
    "e53127e43027e32f27e12e26e02d26df2c25de2a25dd2924dc2824db2723d92623d82522"
    "d72422d62321d52221d42120d31f20d21e1fd01d1fcf1c1fce1b1ecd1a1ecc191dcb181d"
    "ca171cc8171cc7171cc6161cc5161bc4161bc2161bc1151bc0151abf151abe141abc141a"
    "bb1419ba1419b91319b81319b71318b51218b41218b31218b21217b11117af1117ae1117"
    "ad1116ac1016ab1016a91016a80f15a70f15a60f15a50f15a30e14a10e149f0d149d0d14"
    "9b0c13990c13970b13950b13930a12910a128f09128d09128b08118a0811880811860711"
    "8407108206108006107e05107c050f7a040f78040f76030f74030e72020e70020e6e010e"
    "6c010d6a000d68000d67000c"
)
REDS_RGB = np.frombuffer(bytes.fromhex(_REDS_HEX), dtype=np.uint8).reshape(256, 3)


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


def vil_rgb(values) -> np.ndarray:
    """(...) VIL values -> (..., 3) uint8 RGB: ``vil_cmap``'s
    ``cmap(norm(values), bytes=True)``. Bin i of ``VIL_LEVELS`` takes color
    i + 1; below the first level the under color (``VIL_COLORS[1]``), at or
    above the last the over color (``VIL_COLORS[-1]``), NaN the bad color
    (``VIL_COLORS[0]``)."""
    v = np.asarray(values, dtype=np.float64)
    rgb = (np.asarray(VIL_COLORS, dtype=np.float64) * 255).astype(np.uint8)
    # rows: under, the 10 bins, over (np.digitize: 0 below, 11 at or above)
    table = np.concatenate([rgb[1:2], rgb[1:], rgb[-1:]])
    out = table[np.digitize(v, VIL_LEVELS)]
    out[np.isnan(v)] = rgb[0]
    return out


def reds_rgb(values) -> np.ndarray:
    """(...) uint8 values -> (..., 3) uint8 RGB: matplotlib's ``Reds`` over
    ``Normalize(vmin=0, vmax=255)``, as bytes."""
    v = np.asarray(values)
    if v.dtype != np.uint8:
        raise TypeError(f"reds_rgb takes uint8 values, not {v.dtype}")
    return REDS_RGB[v]
