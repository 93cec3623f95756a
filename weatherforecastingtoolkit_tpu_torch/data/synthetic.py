"""Synthetic SEVIR data (counterpart of
weatherforecastingtoolkit_tpu/data/synthetic.py).

``synthetic_vil_events``: advecting gaussian blobs, smooth in time like real
radar, so a latent forecaster has signal to follow; the serving input when
the real SEVIR data is absent.

``make_synthetic_sevir``: a structurally faithful miniature SEVIR tree
(CATALOG.csv + data/<type>/*.h5 with (N_events, H, W, T) raw-dtype datasets,
plus lght point lists), the files the JAX function writes for the same
arguments, so each package reads the other's tree. The catalog is written
with ``catalog.write_catalog`` and the HDF5 files with h5py, imported when
the function runs.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import numpy as np

from .catalog import write_catalog
from .constants import SEVIR_RAW_DTYPES


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


def make_synthetic_sevir(
    root: str,
    num_events: int = 6,
    height: int = 32,
    width: int = 32,
    raw_seq_len: int = 25,
    data_types: Sequence[str] = ("vil",),
    events_per_file: int = 3,
    seed: int = 0,
    start_date: str = "2019-01-01",
) -> str:
    """Write a miniature SEVIR tree under `root`; returns the catalog path.
    Events are 7 days apart from `start_date`."""
    import h5py

    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    rows = []
    day0 = datetime.datetime.fromisoformat(start_date)
    dates = [day0 + datetime.timedelta(days=7 * n) for n in range(num_events)]

    for t in data_types:
        tdir = os.path.join(root, "data", t)
        os.makedirs(tdir, exist_ok=True)

    file_buffers = {}  # (type, file_no) -> list of event arrays / point lists
    for n in range(num_events):
        event_id = f"S{700000 + n}"
        file_no = n // events_per_file
        file_index = n % events_per_file
        for t in data_types:
            # file_name is relative to the data dir, like real SEVIR catalogs
            fname = f"{t}/SEVIR_{t.upper()}_SYNTH_{file_no:04d}.h5"
            file_buffers.setdefault((t, file_no, fname), []).append((event_id, n))
            rows.append(dict(
                id=event_id, file_name=fname, file_index=file_index,
                img_type=t, time_utc=dates[n], pct_missing=0.0,
            ))

    for (t, _file_no, fname), entries in file_buffers.items():
        path = os.path.join(root, "data", fname)
        with h5py.File(path, "w") as f:
            if t == "lght":
                for event_id, n in entries:
                    n_pts = int(rng.integers(0, 40))
                    pts = np.zeros((n_pts, 5), dtype=SEVIR_RAW_DTYPES["lght"])
                    if n_pts:
                        pts[:, 0] = rng.integers(-7000, 7000, n_pts)
                        pts[:, 3] = rng.integers(0, 48, n_pts)
                        pts[:, 4] = rng.integers(0, 48, n_pts)
                    f.create_dataset(event_id, data=pts)
            else:
                ids = [n for _eid, n in entries]
                if t == "vil":
                    arr = synthetic_vil_events(len(ids), height, width,
                                               raw_seq_len, seed=seed + 100 + ids[0])
                else:
                    arr = rng.integers(
                        0, 4000, (len(ids), height, width, raw_seq_len)
                    ).astype(SEVIR_RAW_DTYPES[t])
                f.create_dataset(t, data=arr)
                f.create_dataset("id", data=np.array(
                    [e.encode() for e, _ in entries]))

    return write_catalog(os.path.join(root, "CATALOG.csv"), rows)
