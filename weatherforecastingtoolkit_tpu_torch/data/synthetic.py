"""Synthetic VIL radar fields (a copy of
weatherforecastingtoolkit_tpu/data/synthetic.py::synthetic_vil_events).

Advecting gaussian blobs: smooth in time like real radar, so a latent
forecaster has signal to follow. Used as the serving input when the real
SEVIR data is absent.
"""

from __future__ import annotations

import numpy as np


def synthetic_vil_events(num_events: int, height: int, width: int, t: int,
                         seed: int = 0) -> np.ndarray:
    """(N, H, W, T) uint8 advecting-blob VIL fields."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    out = np.zeros((num_events, height, width, t), dtype=np.uint8)
    for n in range(num_events):
        n_blobs = int(rng.integers(2, 5))
        cx = rng.uniform(0, width, n_blobs)
        cy = rng.uniform(0, height, n_blobs)
        vx = rng.uniform(-1.5, 1.5, n_blobs)
        vy = rng.uniform(-1.5, 1.5, n_blobs)
        sig = rng.uniform(height / 16, height / 5, n_blobs)
        amp = rng.uniform(90, 255, n_blobs)
        grow = rng.uniform(-0.01, 0.01, n_blobs)
        for k in range(t):
            frame = np.zeros((height, width), dtype=np.float32)
            for b in range(n_blobs):
                a = amp[b] * (1.0 + grow[b] * k)
                d2 = ((xx - (cx[b] + vx[b] * k)) ** 2 +
                      (yy - (cy[b] + vy[b] * k)) ** 2)
                frame += a * np.exp(-d2 / (2 * sig[b] ** 2))
            out[n, :, :, k] = np.clip(frame, 0, 255).astype(np.uint8)
    return out
