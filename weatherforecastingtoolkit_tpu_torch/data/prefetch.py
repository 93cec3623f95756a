"""Host batching + device prefetch (counterpart of
weatherforecastingtoolkit_tpu/data/prefetch.py).

  dataset (map-style, numpy) --thread pool--> stacked host batches
      --pinned buffers, non_blocking copies--> device-resident batches

``collate`` and ``BatchLoader`` are numpy only and copy the JAX package's.
``device_prefetch`` keeps ``prefetch`` batches in flight: each numpy array is
wrapped without a copy, pinned, and copied with ``non_blocking=True``, so
while step N computes the copy of batch N+1 is already queued. Where the
device is the CPU it only wraps the arrays and never touches the GPU.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
from typing import Any, Callable, Dict, Iterable, Iterator, Sequence

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples at a new leading (batch) axis."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class BatchLoader:
    """Iterates batches from a map-style dataset using a thread pool.

    drop_last=True yields only full batches (the reference's `__len__ =
    total // batch_size` floor semantics, sevir/sevir.py:534-538).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 4, drop_last: bool = True,
                 collate_fn: Callable = collate):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                np.random.SeedSequence([self.seed, self._epoch])).permutation(n)
        limit = (n // self.batch_size) * self.batch_size if self.drop_last else n
        order = order[:limit]

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            # window the index stream into batches; keep ~2 batches in flight
            batches = [order[i:i + self.batch_size]
                       for i in range(0, len(order), self.batch_size)]
            pending = collections.deque()
            idx = 0

            def submit(batch_ids):
                return [pool.submit(self.dataset.__getitem__, int(i)) for i in batch_ids]

            while idx < len(batches) and len(pending) < 2:
                pending.append(submit(batches[idx])); idx += 1
            while pending:
                futs = pending.popleft()
                if idx < len(batches):
                    pending.append(submit(batches[idx])); idx += 1
                yield self.collate_fn([f.result() for f in futs])


def to_device(batch: Any, device: torch.device) -> Any:
    """Arrays and tensors of a (nested) batch onto ``device``: pinned and
    non-blocking for a CUDA device, a zero-copy wrap for the CPU."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    if device.type == "cpu":
        return batch.to(device)
    if batch.device.type == "cpu":
        batch = batch.pin_memory()
    return batch.to(device, non_blocking=True)


def device_prefetch(host_iter: Iterable, prefetch: int = 2,
                    device: DeviceLike = None) -> Iterator:
    """Wrap a host-batch iterator with asynchronous device placement,
    ``prefetch`` batches ahead. ``device=None`` means ``cuda``."""
    device = resolve_device(device)
    queue = collections.deque()
    it = iter(host_iter)

    def enqueue(n):
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            queue.append(to_device(batch, device))

    enqueue(prefetch)
    while queue:
        batch = queue.popleft()
        enqueue(1)
        yield batch
