"""SEVIR catalog parsing and event grouping (counterpart of
weatherforecastingtoolkit_tpu/data/catalog.py), with the stdlib ``csv``
module and numpy in place of pandas.

Behavior parity with the reference's `_compute_samples`
(reference pipeline/datasets/sevir/sevir.py:273-302): filter the CATALOG.csv
to events where every requested img_type is colocated and non-missing, drop
events with duplicated rows (an upstream SEVIR data bug), and produce one
record per event holding per-type (file_name, file_index).

A loaded catalog is a dict of numpy columns, one per CSV column, in the
file's column order. Text columns hold Python ``str`` objects;
``time_utc`` is ``datetime64[us]`` (NaT where empty); ``file_index`` and
``pct_missing`` are int64 when every entry is an integer, else float64 when
every entry is a number (NaN where empty), else text: the types
``pandas.read_csv(parse_dates=["time_utc"])`` gives the columns the
pipeline reads. ``write_catalog`` writes rows as ``DataFrame.to_csv(
index=False)`` does, so a tree written by either package reads the same.
"""

from __future__ import annotations

import csv
import datetime
from dataclasses import dataclass, field
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Union)

import numpy as np

from .constants import SEVIR_DATA_TYPES

Columns = Dict[str, np.ndarray]


@dataclass
class EventRecord:
    event_id: str
    files: Dict[str, str] = field(default_factory=dict)    # img_type -> file_name
    indices: Dict[str, Union[int, str]] = field(default_factory=dict)
    # img_type -> file_index (int) or, for 'lght', the event id string key
    time_utc: Optional[datetime.datetime] = None


class EventIndex:
    """Ordered collection of colocated SEVIR events."""

    def __init__(self, events: List[EventRecord], data_types: Sequence[str]):
        self.events = events
        self.data_types = tuple(data_types)

    def __len__(self) -> int:
        return len(self.events)

    def __getitem__(self, i: int) -> EventRecord:
        return self.events[i]

    def shuffled(self, seed: int) -> "EventIndex":
        order = np.random.default_rng(seed).permutation(len(self.events))
        return EventIndex([self.events[i] for i in order], self.data_types)

    def subset(self, start: int, end: int) -> "EventIndex":
        return EventIndex(self.events[start:end], self.data_types)

    @property
    def filenames(self) -> List[str]:
        seen, out = set(), []
        for ev in self.events:
            for fn in ev.files.values():
                if fn not in seen:
                    seen.add(fn)
                    out.append(fn)
        return out


def _text(values: Sequence[str]) -> np.ndarray:
    out = np.empty(len(values), dtype=object)
    out[:] = list(values)
    return out


def _float(s: str) -> float:
    return float(s) if s.strip() else float("nan")


def _numbers(values: Sequence[str]) -> np.ndarray:
    """int64 when every entry is an integer, float64 when every entry is a
    number (empty = NaN), else the text itself."""
    try:
        return np.array([int(v) for v in values], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.array([_float(v) for v in values], dtype=np.float64)
    except ValueError:
        return _text(values)


def parse_times(values: Sequence[str]) -> np.ndarray:
    """ISO date or date-time strings -> datetime64[us]; empty -> NaT."""
    return np.array([np.datetime64(datetime.datetime.fromisoformat(v.strip()),
                                   "us") if v.strip() else np.datetime64("NaT")
                     for v in values], dtype="datetime64[us]")


def format_times(times: Sequence) -> List[str]:
    """Datetimes as ``DataFrame.to_csv`` writes a datetime column: dates
    alone when every time is midnight, else ``%Y-%m-%d %H:%M:%S`` (with
    microseconds when any has them); None -> ''."""
    ts = [None if t is None else (t if isinstance(t, datetime.datetime)
                                  else datetime.datetime.fromisoformat(str(t)))
          for t in times]
    real = [t for t in ts if t is not None]
    if all(t.time() == datetime.time() for t in real):
        fmt = "%Y-%m-%d"
    elif any(t.microsecond for t in real):
        fmt = "%Y-%m-%d %H:%M:%S.%f"
    else:
        fmt = "%Y-%m-%d %H:%M:%S"
    return ["" if t is None else t.strftime(fmt) for t in ts]


def _cell(v) -> str:
    if isinstance(v, float):
        return "" if v != v else repr(v)
    return str(v)


def write_catalog(path: str, rows: Sequence[Mapping]) -> str:
    """Write catalog rows (dicts with the same keys, in column order) as a
    CSV: the bytes ``pandas.DataFrame(rows).to_csv(path, index=False)``
    writes for the catalog's types (str, int, float, datetime)."""
    columns = list(rows[0]) if rows else []
    cells = {c: [r[c] for r in rows] for c in columns}
    for c, vals in cells.items():
        if any(isinstance(v, datetime.datetime) for v in vals):
            cells[c] = format_times(vals)
        else:
            cells[c] = [_cell(v) for v in vals]
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        w.writerows(zip(*(cells[c] for c in columns)))
    return path


def load_catalog(path_or_columns: Union[str, Mapping[str, Sequence]]
                 ) -> Columns:
    """CATALOG.csv (a path) -> dict of numpy columns. A mapping of columns
    (an already-loaded catalog) passes through as numpy arrays."""
    if isinstance(path_or_columns, Mapping):
        return {k: np.asarray(v) for k, v in path_or_columns.items()}
    with open(path_or_columns, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = list(reader)
    raw = {c: [r[i] if i < len(r) else "" for r in rows]
           for i, c in enumerate(header)}
    out: Columns = {}
    for c, vals in raw.items():
        if c == "time_utc":
            out[c] = parse_times(vals)
        elif c in ("file_index", "pct_missing"):
            out[c] = _numbers(vals)
        else:
            out[c] = _text(vals)
    return out


def _take(columns: Columns, mask: np.ndarray) -> Columns:
    mask = np.asarray(mask, dtype=bool)
    return {k: v[mask] for k, v in columns.items()}


def build_event_index(
    catalog: Union[str, Mapping[str, Sequence]],
    data_types: Optional[Sequence[str]] = None,
    start_date: Optional[datetime.datetime] = None,
    end_date: Optional[datetime.datetime] = None,
    datetime_filter: Optional[Callable] = None,
    catalog_filter: Union[str, Callable, None] = "default",
) -> EventIndex:
    """Filter the catalog and group colocated img_types per event id.

    Date semantics match the reference (sevir/sevir.py:257-267):
    keep rows with time_utc > start_date and time_utc <= end_date;
    'default' catalog filter keeps pct_missing == 0.

    ``datetime_filter(times)`` takes the ``time_utc`` column (numpy
    datetime64) and ``catalog_filter(columns)`` the dict of numpy columns;
    each returns a boolean mask over the rows (the JAX package hands them a
    pandas Series and DataFrame).
    """
    cols = load_catalog(catalog)
    data_types = tuple(data_types) if data_types else SEVIR_DATA_TYPES
    if not set(data_types).issubset(SEVIR_DATA_TYPES):
        raise ValueError(f"Unknown data types: {data_types}")

    if start_date is not None:
        cols = _take(cols, cols["time_utc"] > np.datetime64(start_date, "us"))
    if end_date is not None:
        cols = _take(cols, cols["time_utc"] <= np.datetime64(end_date, "us"))
    if datetime_filter is not None:
        cols = _take(cols, datetime_filter(cols["time_utc"]))
    if catalog_filter is not None:
        if catalog_filter == "default":
            catalog_filter = lambda c: c["pct_missing"] == 0  # noqa: E731
        cols = _take(cols, catalog_filter(cols))

    wanted = set(data_types)
    cols = _take(cols, [t in wanted for t in cols["img_type"]])

    # groupby("id", sort=False): groups in order of first appearance; rows
    # without an id (NaN to pandas) belong to no group
    groups: Dict[str, List[int]] = {}
    for row, event_id in enumerate(cols["id"]):
        if str(event_id):
            groups.setdefault(str(event_id), []).append(row)
    has_time = "time_utc" in cols
    events: List[EventRecord] = []
    for event_id, rows in groups.items():
        by_type = {str(cols["img_type"][r]): r for r in rows}
        if not wanted.issubset(by_type):
            continue  # missing a requested type
        if len(rows) != len(data_types):
            continue  # duplicated rows: upstream data bug, drop whole event
        t0 = cols["time_utc"][rows[0]] if has_time else None
        rec = EventRecord(event_id=event_id,
                          time_utc=None if t0 is None or np.isnat(t0)
                          else t0.astype(datetime.datetime))
        for t in data_types:
            r = by_type[t]
            rec.files[t] = str(cols["file_name"][r])
            rec.indices[t] = event_id if t == "lght" else \
                int(cols["file_index"][r])
        events.append(rec)
    return EventIndex(events, data_types)
