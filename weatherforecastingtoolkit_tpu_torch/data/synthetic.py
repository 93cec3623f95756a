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

``make_synthetic_sevir_cache``: the same VIL events, at the same ids and
dates, as a tree of CATALOG.csv and the packed caches of the splits a
``SEVIRDataModule(use_cache=True)`` reads (``data/cache.py``), written with
numpy and the standard library alone: the form a machine without h5py
trains from. Which form a caller writes is the caller's choice.
"""

from __future__ import annotations

import concurrent.futures
import datetime
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


def _catalog_rows(num_events: int, data_types: Sequence[str],
                  events_per_file: int, start_date: str) -> List[dict]:
    """The catalog rows of a synthetic tree: event n is S{700000 + n}, at
    start_date + 7n days, in file n // events_per_file."""
    day0 = datetime.datetime.fromisoformat(start_date)
    rows = []
    for n in range(num_events):
        for t in data_types:
            # file_name is relative to the data dir, like real SEVIR catalogs
            rows.append(dict(
                id=f"S{700000 + n}",
                file_name=f"{t}/SEVIR_{t.upper()}_SYNTH_{n // events_per_file:04d}.h5",
                file_index=n % events_per_file, img_type=t,
                time_utc=day0 + datetime.timedelta(days=7 * n),
                pct_missing=0.0))
    return rows


def _vil_file(first: int, count: int, height: int, width: int,
              raw_seq_len: int, seed: int) -> np.ndarray:
    """The (count, H, W, T) VIL events of the file whose first event is
    `first`."""
    return synthetic_vil_events(count, height, width, raw_seq_len,
                                seed=seed + 100 + first)


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
    rows = _catalog_rows(num_events, data_types, events_per_file, start_date)

    for t in data_types:
        tdir = os.path.join(root, "data", t)
        os.makedirs(tdir, exist_ok=True)

    file_buffers = {}  # (type, file_no) -> list of event arrays / point lists
    for i, row in enumerate(rows):   # event-major, a row per data type
        n = i // len(data_types)
        file_buffers.setdefault((row["img_type"], n // events_per_file,
                                 row["file_name"]), []).append((row["id"], n))

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
                    arr = _vil_file(ids[0], len(ids), height, width,
                                    raw_seq_len, seed)
                else:
                    arr = rng.integers(
                        0, 4000, (len(ids), height, width, raw_seq_len)
                    ).astype(SEVIR_RAW_DTYPES[t])
                f.create_dataset(t, data=arr)
                f.create_dataset("id", data=np.array(
                    [e.encode() for e, _ in entries]))

    return write_catalog(os.path.join(root, "CATALOG.csv"), rows)


# threads that make the synthetic files (numpy's elementwise work runs
# outside the GIL)
_EVENT_THREADS = 8


def synthetic_sevir_events(num_events: int, height: int, width: int,
                           raw_seq_len: int = 25, events_per_file: int = 3,
                           seed: int = 0) -> Dict[str, np.ndarray]:
    """The VIL events ``make_synthetic_sevir`` writes for the same
    arguments, by event id: (H, W, T) uint8 arrays, made a file at a time in
    a pool of threads."""
    files = [(i, min(num_events, i + events_per_file))
             for i in range(0, num_events, events_per_file)]
    with concurrent.futures.ThreadPoolExecutor(_EVENT_THREADS) as pool:
        parts = list(pool.map(lambda f: _vil_file(
            f[0], f[1] - f[0], height, width, raw_seq_len, seed), files))
    return {f"S{700000 + n}": arr
            for (first, _end), part in zip(files, parts)
            for n, arr in enumerate(part, start=first)}


class EventReader:
    """``SEVIRReader.read_window``'s contract over in-memory (H, W, T) VIL
    events keyed by event id: the source the packed caches are built from
    where no HDF5 file is written."""

    def __init__(self, events: Mapping[str, np.ndarray]):
        self.events = events

    def read_window(self, event, img_type, t_slice=slice(None)):
        if img_type != "vil":
            raise KeyError(img_type)
        arr = self.events[event.event_id]
        if t_slice.stop is not None and t_slice.stop > arr.shape[-1]:
            raise IndexError(f"window {t_slice} exceeds {arr.shape[-1]}")
        return arr[:, :, t_slice]


_Date = Optional[datetime.datetime]


def make_synthetic_sevir_cache(
    root: str,
    splits: Mapping[str, Tuple[_Date, _Date]],
    num_events: int = 6,
    height: int = 32,
    width: int = 32,
    raw_seq_len: int = 25,
    events_per_file: int = 3,
    seed: int = 0,
    start_date: str = "2019-01-01",
) -> str:
    """Write under `root` the VIL events ``make_synthetic_sevir`` writes for
    the same arguments, as CATALOG.csv, an empty data/vil/ and the packed
    cache of every split in `splits` ({tag: (start, end)}, as
    ``SEVIRDataModule.split_dates`` gives them); returns the catalog path.

    Needs numpy and the standard library only. The catalog is published
    last, so a tree with a CATALOG.csv has its caches."""
    from .cache import build_cache
    from .catalog import build_event_index
    from .dataset import SEVIRDataset

    data_dir = os.path.join(root, "data")
    os.makedirs(os.path.join(data_dir, "vil"), exist_ok=True)
    catalog = os.path.join(root, "CATALOG.csv")
    staged = write_catalog(catalog + ".tmp", _catalog_rows(
        num_events, ("vil",), events_per_file, start_date))
    reader = EventReader(synthetic_sevir_events(
        num_events, height, width, raw_seq_len, events_per_file, seed))
    for tag, (start, end) in splits.items():
        ds = SEVIRDataset(
            catalog=build_event_index(staged, ("vil",), start, end),
            data_dir=data_dir, seq_len=raw_seq_len, raw_seq_len=raw_seq_len,
            stride=raw_seq_len, layout="NTCHW")
        ds.reader = reader
        build_cache(ds, os.path.join(root, "cache_packed"), split=tag,
                    verbose=False)
    os.replace(staged, catalog)
    return catalog
