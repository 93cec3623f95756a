"""Data-pipeline throughput harness (counterpart of
weatherforecastingtoolkit_tpu/data/benchmark.py).

The analog of the reference's loader benchmark with recorded conclusions
(reference pipeline/datasets/sevir/test.py:9-73 — ~13.3 batches/s with 8 fork
workers, 61% system time). Measures batches/sec for the HDF5-backed and
cache-backed loaders; with ``--device cuda`` (the default) the batches go
through ``device_prefetch`` onto the card, so the rate is that of batches
resident on the device. Run standalone:

    python -m weatherforecastingtoolkit_tpu_torch.data.benchmark --sevir-dir ...
"""

from __future__ import annotations

import argparse
import time

import torch

from .cache import CachedSEVIRDataset, build_cache
from .dataset import SEVIRDataset
from .prefetch import BatchLoader, device_prefetch


def _sync(batch) -> None:
    """Wait for the copies of a device batch (host batches need nothing)."""
    for v in batch.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def measure_loader(loader, max_batches: int = 200, warmup: int = 5):
    """(batches/s, samples/s) over up to `max_batches` batches after
    `warmup`; `loader` yields dicts of numpy arrays or tensors."""
    it = iter(loader)
    for _ in range(warmup):
        batch = next(it, None)
    if warmup and batch is not None:
        _sync(batch)
    t0 = time.time()
    n = 0
    seq = 0
    for batch in it:
        n += 1
        seq += next(iter(batch.values())).shape[0]
        if n >= max_batches:
            break
    if n:
        _sync(batch)
    dt = time.time() - t0
    return n / dt, seq / dt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sevir-dir", required=True)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=25)
    p.add_argument("--stride", type=int, default=12)
    p.add_argument("--raw-seq-len", type=int, default=25)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--max-batches", type=int, default=200)
    p.add_argument("--device", default="cuda",
                   help="where the batches go ('cpu': host batches only)")
    args = p.parse_args(argv)

    def feed(loader):
        if args.device == "cpu":
            return loader
        return device_prefetch(loader, device=args.device)

    ds = SEVIRDataset(
        catalog=f"{args.sevir_dir}/CATALOG.csv",
        data_dir=f"{args.sevir_dir}/data", data_types=("vil",),
        seq_len=args.seq_len, raw_seq_len=args.raw_seq_len,
        stride=args.stride, layout="NTHWC")
    loader = BatchLoader(ds, args.batch_size, shuffle=True,
                         num_workers=args.num_workers)
    bps, sps = measure_loader(feed(loader), args.max_batches)
    print(f"hdf5 loader:   {bps:7.2f} batches/s  {sps:8.1f} seq/s "
          f"to {args.device} (reference recorded ~13.3 batches/s / "
          f"~107 seq/s on the host)")

    if args.cache_dir:
        build_cache(ds, args.cache_dir, split="bench")
        cds = CachedSEVIRDataset(args.cache_dir, split="bench",
                                 seq_len=args.seq_len, stride=args.stride,
                                 layout="NTHWC")
        closer = BatchLoader(cds, args.batch_size, shuffle=True,
                             num_workers=args.num_workers)
        bps2, sps2 = measure_loader(feed(closer), args.max_batches)
        print(f"cached loader: {bps2:7.2f} batches/s  {sps2:8.1f} seq/s "
              f"({bps2 / bps:.1f}x hdf5)")


if __name__ == "__main__":
    main()
