"""Offline downsampled-dataset writer (counterpart of
weatherforecastingtoolkit_tpu/data/downsample_writer.py; h5py is imported
when the function runs, and the catalog is written with
``catalog.write_catalog``).

Capability parity with the reference's `save_downsampled_dataset`
(reference pipeline/datasets/sevir/sevir.py:450-493 and the fixed-append
sevire variant at sevire/sevir.py:575+; the `_old_` buggy version kept at
:526-573 is intentionally not reproduced): read every event of a dataset,
downsample (t, h, w) by max- or avg-pooling, and write a new SEVIR-shaped
HDF5 tree + catalog that the normal loaders consume unchanged.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Sequence

import numpy as np

from .catalog import write_catalog
from .constants import SEVIR_RAW_DTYPES
from .dataset import SEVIRDataset, downsample_hwt


def save_downsampled_dataset(
    dataset: SEVIRDataset,
    out_dir: str,
    factors: Dict[str, Sequence[int]],
    method: str = "max",
    events_per_file: int = 32,
    verbose: bool = True,
) -> str:
    """Write a downsampled copy of `dataset`'s events under `out_dir`.

    factors[img_type] = (t_factor, h_factor, w_factor). Returns the new
    catalog path. Raw dtypes are preserved (max pooling keeps them exactly;
    avg pooling rounds back to the raw dtype like the reference's uint8 VIL
    path).
    """
    import h5py

    os.makedirs(os.path.join(out_dir, "data"), exist_ok=True)
    rows = []
    buffers: Dict[str, list] = {t: [] for t in dataset.data_types}
    file_no = {t: 0 for t in dataset.data_types}

    def flush(t: str):
        if not buffers[t]:
            return None
        fname = f"{t}/SEVIR_{t.upper()}_DOWN_{file_no[t]:04d}.h5"
        path = os.path.join(out_dir, "data", fname)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ids = [eid for eid, _ in buffers[t]]
        arr = np.stack([a for _, a in buffers[t]])
        with h5py.File(path, "w") as f:
            f.create_dataset(t, data=arr)
            f.create_dataset("id", data=np.array([e.encode() for e in ids]))
        file_no[t] += 1
        buffers[t].clear()
        return fname

    n = len(dataset.events)
    for i in range(n):
        ev = dataset.events[i]
        for t in dataset.data_types:
            raw = dataset.reader.read_window(ev, t)  # (H, W, T) raw dtype
            tf, hf, wf = factors.get(t, (1, 1, 1))
            down = downsample_hwt(raw.astype(np.float32), tf, hf, wf,
                                  method=method)
            raw_dtype = SEVIR_RAW_DTYPES.get(t, raw.dtype)
            if np.issubdtype(raw_dtype, np.integer):
                info = np.iinfo(raw_dtype)
                down = np.clip(np.rint(down), info.min, info.max)
            down = down.astype(raw_dtype)
            idx_in_file = len(buffers[t])
            buffers[t].append((ev.event_id, down))
            time_utc = (ev.time_utc if ev.time_utc is not None
                        else datetime.datetime(2019, 1, 1)
                        + datetime.timedelta(days=i))
            rows.append(dict(
                id=ev.event_id,
                file_name=f"{t}/SEVIR_{t.upper()}_DOWN_{file_no[t]:04d}.h5",
                file_index=idx_in_file, img_type=t,
                time_utc=time_utc, pct_missing=0.0))
            if len(buffers[t]) >= events_per_file:
                flush(t)
        if verbose and (i + 1) % 100 == 0:
            print(f"[downsample] {i + 1}/{n} events")
    for t in dataset.data_types:
        flush(t)

    return write_catalog(os.path.join(out_dir, "CATALOG.csv"), rows)
