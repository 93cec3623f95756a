"""Real-SEVIR preflight: validate a sevir_dir BEFORE committing to a long run
(counterpart of weatherforecastingtoolkit_tpu/data/preflight.py; the catalog
is read with the stdlib csv module, and h5py is imported only to probe the
HDF5 files).

Every science number in this repo so far was measured on the synthetic
fixture (no egress in CI); this module de-risks first contact with the real
dataset (contract: reference pipeline/datasets/sevir/sevir.py:104-908 and the
official SEVIR layout — CATALOG.csv + data/<type>/<year>/*.h5). It checks,
without reading bulk data:

  1. CATALOG.csv exists, parses, and has every column the pipeline touches
     (id / file_name / file_index / img_type / time_utc / pct_missing) with
     usable dtypes;
  2. the catalog actually yields colocated events for the requested
     data_types (the reference silently trains on 0 events otherwise);
  3. referenced HDF5 files exist under data_dir, each exposes a dataset named
     after its img_type with (N, H, W, T) geometry (lght: per-event point
     groups), raw dtype matching SEVIR_RAW_DTYPES;
  4. probed raw_seq_len / frame geometry match the dataset preset, so
     window math (windows.py) and the packed cache won't mis-slice.

Usage:
    from weatherforecastingtoolkit_tpu_torch.data.preflight import preflight
    report = preflight("/data/sevir", dataset_name="sevirlr")   # raises on
    print(report.summary())                                     # hard fails

or from the CLI:
    python -m weatherforecastingtoolkit_tpu_torch.data.preflight /data/sevir sevirlr
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

from .catalog import build_event_index, load_catalog
from .constants import DATASET_PRESETS, SEVIR_RAW_DTYPES

#: catalog columns the pipeline reads (catalog.py / dataset.py); the real
#: catalog has ~20 columns, these are the load-bearing ones
REQUIRED_CATALOG_COLUMNS = ("id", "file_name", "file_index", "img_type",
                            "time_utc", "pct_missing")


class PreflightError(RuntimeError):
    """Raised when the sevir_dir fails a hard preflight check."""


@dataclasses.dataclass
class PreflightReport:
    sevir_dir: str
    dataset_name: str
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)
    info: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors

    def summary(self) -> str:
        lines = [f"SEVIR preflight: {self.sevir_dir} "
                 f"(preset {self.dataset_name!r}) -> "
                 f"{'OK' if self.ok else 'FAILED'}"]
        lines += [f"  [info] {m}" for m in self.info]
        lines += [f"  [warn] {m}" for m in self.warnings]
        lines += [f"  [FAIL] {m}" for m in self.errors]
        return "\n".join(lines)


def preflight(sevir_dir: str, dataset_name: str = "sevir",
              data_types: Sequence[str] = ("vil",),
              catalog_path: Optional[str] = None,
              raw_data_dir: Optional[str] = None,
              probe_events: int = 3, strict: bool = True) -> PreflightReport:
    """Validate an on-disk SEVIR tree against the pipeline's expectations.

    Raises PreflightError (with the full report in the message) when a hard
    check fails and `strict=True`; otherwise returns the report for
    inspection. Never reads more than `probe_events` events' metadata.
    """
    if dataset_name not in DATASET_PRESETS:
        raise ValueError(f"unknown dataset preset {dataset_name!r}; "
                         f"expected one of {tuple(DATASET_PRESETS)}")
    preset = DATASET_PRESETS[dataset_name]
    rep = PreflightReport(sevir_dir=sevir_dir, dataset_name=dataset_name)
    catalog_path = catalog_path or os.path.join(sevir_dir, "CATALOG.csv")
    raw_data_dir = raw_data_dir or os.path.join(sevir_dir, "data")

    # -- 1. catalog schema ---------------------------------------------------
    if not os.path.exists(catalog_path):
        rep.errors.append(f"CATALOG.csv not found at {catalog_path}")
        return _finish(rep, strict)
    try:
        with open(catalog_path, newline="") as f:
            columns = next(csv.reader(f), [])
    except (OSError, UnicodeDecodeError, csv.Error) as e:
        rep.errors.append(f"CATALOG.csv unreadable: {type(e).__name__}: {e}")
        return _finish(rep, strict)

    missing_cols = [c for c in REQUIRED_CATALOG_COLUMNS if c not in columns]
    if missing_cols:
        rep.errors.append(f"catalog missing required columns {missing_cols}; "
                          f"has {columns[:12]}...")
        return _finish(rep, strict)
    try:
        cat = load_catalog(catalog_path)
    except ValueError as e:  # a time_utc the ISO parser refuses
        rep.errors.append(f"time_utc not parseable as datetimes: {e}")
        return _finish(rep, strict)
    img_types = sorted(set(str(t) for t in cat["img_type"]))
    rep.info.append(f"catalog: {len(cat['id'])} rows, "
                    f"{len(set(cat['id']))} event ids, img_types {img_types}")

    # file_index must be a number on every non-lght row (lght rows key their
    # point groups by event id)
    non_lght = np.array([t != "lght" for t in cat["img_type"]], dtype=bool)
    bad = [v for v in np.asarray(cat["file_index"])[non_lght]
           if not _is_number(v)]
    if bad:
        rep.errors.append(
            f"{len(bad)} non-lght rows have non-integer file_index (e.g. "
            f"{bad[0]!r})")

    unknown_types = set(data_types) - set(img_types)
    if unknown_types:
        rep.errors.append(f"requested data_types {sorted(unknown_types)} "
                          "absent from the catalog")
        return _finish(rep, strict)

    # -- 2. event grouping yields usable events ------------------------------
    index = build_event_index(cat, data_types)
    if len(index) == 0:
        rep.errors.append(
            f"0 colocated events for data_types {tuple(data_types)} after "
            "the default pct_missing==0 filter — the training split would be "
            "empty")
        return _finish(rep, strict)
    rep.info.append(f"{len(index)} colocated events for {tuple(data_types)}")

    # -- 3./4. probe files: existence, dataset, geometry, dtype --------------
    if not os.path.isdir(raw_data_dir):
        rep.errors.append(f"data dir not found: {raw_data_dir}")
        return _finish(rep, strict)
    import h5py

    probe_idx = np.linspace(0, len(index) - 1,
                            min(probe_events, len(index)), dtype=int)
    seen_files = set()
    for i in probe_idx:
        ev = index[int(i)]
        for t in data_types:
            fname = ev.files[t]
            path = os.path.join(raw_data_dir, fname)
            if fname in seen_files:
                continue
            seen_files.add(fname)
            if not os.path.exists(path):
                rep.errors.append(f"referenced file missing: {path}")
                continue
            try:
                with h5py.File(path, "r") as f:
                    if t == "lght":
                        key = str(ev.indices[t])
                        if key not in f:
                            rep.errors.append(
                                f"lght file {fname} has no group for event "
                                f"id {key}")
                        continue
                    if t not in f:
                        rep.errors.append(
                            f"{fname}: no dataset named {t!r} "
                            f"(has {list(f.keys())})")
                        continue
                    ds = f[t]
                    if ds.ndim != 4:
                        rep.errors.append(
                            f"{fname}:{t} has ndim {ds.ndim}, expected 4 "
                            "(N, H, W, T)")
                        continue
                    n, h, w, tt = ds.shape
                    idx = int(ev.indices[t])
                    if idx >= n:
                        rep.errors.append(
                            f"{fname}: catalog file_index {idx} out of range "
                            f"for {n} events")
                    if (h, w) != (preset["img_height"], preset["img_width"]):
                        rep.errors.append(
                            f"{fname}:{t} frames are {h}x{w}; preset "
                            f"{dataset_name!r} expects "
                            f"{preset['img_height']}x{preset['img_width']} — "
                            "wrong preset? (sevir=384^2/49f, "
                            "sevirlr=128^2/25f)")
                    if tt != preset["raw_seq_len"]:
                        rep.errors.append(
                            f"{fname}:{t} has raw_seq_len {tt}; preset "
                            f"{dataset_name!r} expects "
                            f"{preset['raw_seq_len']} — window math and the "
                            "packed cache would mis-slice")
                    want = np.dtype(SEVIR_RAW_DTYPES[t])
                    if ds.dtype != want:
                        rep.warnings.append(
                            f"{fname}:{t} stored as {ds.dtype}, canonical "
                            f"raw dtype is {want} (rescale still works; "
                            "packed cache will be larger)")
            except OSError as e:
                rep.errors.append(f"{path} not readable as HDF5: {e}")
    rep.info.append(f"probed {len(seen_files)} file(s) across "
                    f"{len(probe_idx)} event(s)")
    return _finish(rep, strict)


def _is_number(v) -> bool:
    """True for a number, or text that parses as one and is not empty (what
    ``pandas.to_numeric(errors='coerce')`` keeps)."""
    if isinstance(v, (int, float, np.integer, np.floating)):
        return not (isinstance(v, (float, np.floating)) and v != v)
    try:
        return float(str(v)) == float(str(v))
    except ValueError:
        return False


def _finish(rep: PreflightReport, strict: bool) -> PreflightReport:
    if strict and not rep.ok:
        raise PreflightError(rep.summary())
    return rep


if __name__ == "__main__":
    import sys

    d = sys.argv[1] if len(sys.argv) > 1 else "."
    name = sys.argv[2] if len(sys.argv) > 2 else "sevir"
    types = tuple(sys.argv[3].split(",")) if len(sys.argv) > 3 else ("vil",)
    print(preflight(d, name, types, strict=False).summary())
