"""Sliding-window and shard index math for SEVIR event sequences (a copy
of weatherforecastingtoolkit_tpu/data/windows.py).

Pure-python/pure-function re-derivation of the reference's windowing algebra
(reference pipeline/datasets/sevir/sevir.py:104-115 docstring diagram,
:326-375 shard math, :851-908 `_idx_sample` index mapping). Kept separate from
any I/O so it is unit-testable and reusable by the host prefetcher and the
shard-aware distributed iterator.

Event frames:
    [-----------------------raw_seq_len----------------------]
    [-----seq_len-----]
    <--stride-->[-----seq_len-----]
                <--stride-->[-----seq_len-----]

Note the anti-leak rule from the reference: for test data, `stride` must not
be smaller than the prediction window, or test windows overlap targets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


def num_seq_per_event(raw_seq_len: int, seq_len: int, stride: int) -> int:
    if seq_len > raw_seq_len:
        raise ValueError(f"seq_len {seq_len} > raw_seq_len {raw_seq_len}")
    return 1 + (raw_seq_len - seq_len) // stride


def shard_event_range(total_num_event: int, num_shard: int, rank: int,
                      split_mode: str = "uneven") -> Tuple[int, int]:
    """[start, end) event indices owned by `rank`.

    split_mode:
      * 'ceil'   — every shard reports the same (max) length; early shards may
                   read past their slice into duplicated events.
      * 'floor'  — every shard has floor(total/num_shard) events; the tail is
                   dropped.
      * 'uneven' — last shard absorbs the remainder (desyncs collectives if
                   used naively; we instead pad-and-mask in the data iterator).
    """
    if split_mode not in ("ceil", "floor", "uneven"):
        raise ValueError(f"Invalid split_mode: {split_mode}")
    base = total_num_event // num_shard
    start = base * rank
    if split_mode == "ceil":
        last_start = base * (num_shard - 1)
        return start, start + (total_num_event - last_start)
    if split_mode == "floor":
        return start, base * (rank + 1)
    # uneven
    if rank == num_shard - 1:
        return start, total_num_event
    return start, base * (rank + 1)


@dataclass(frozen=True)
class WindowIndex:
    """Maps a flat sample index -> (event_idx, frame window) within a shard."""

    num_events: int
    raw_seq_len: int
    seq_len: int
    stride: int
    start_event_idx: int = 0

    @property
    def seq_per_event(self) -> int:
        return num_seq_per_event(self.raw_seq_len, self.seq_len, self.stride)

    def __len__(self) -> int:
        return self.num_events * self.seq_per_event

    def locate(self, index: int) -> Tuple[int, slice]:
        """sample index -> (absolute event idx, frame slice)."""
        if index < 0 or index >= len(self):
            raise IndexError(index)
        event_idx, seq_idx = divmod(index, self.seq_per_event)
        t0 = seq_idx * self.stride
        return self.start_event_idx + event_idx, slice(t0, t0 + self.seq_len)

    def batch_locate(self, index: int, batch_size: int) -> List[Tuple[int, slice]]:
        """Consecutive-sample batch starting at `index * batch_size`
        (the reference's `_idx_sample` batching, sevir/sevir.py:851-908)."""
        return [self.locate(index * batch_size + i)
                for i in range(batch_size)
                if index * batch_size + i < len(self)]
