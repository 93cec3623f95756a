"""Serving throughput of the pixel-unshuffle (no full-resolution conv) VAE
against the reference-shape VAE on the card (counterpart of
experiments/perf/fast_vae_probe.py).

The fast VAE, ``AutoencoderKL(pixel_unshuffle=4, block_out_channels=(128,
256, 512))``: a lossless 4x4 space-to-depth stem, so its shallowest conv
runs at 32x32 with 128 channels; the same 64x8x8 latent, DLinear and
12-step rollout as the reference shape. Both bf16 at B=64, random weights
(a conv's time does not depend on its weights). Prints the median call,
frames/s and the shares of the card's peak FLOP/s and memory bytes/s that
the call's counted FLOPs and bytes reach (``bench_helpers.count_cost``:
eager PyTorch's op-by-op counts, not XLA's cost model).

    python experiments_gpu/perf/fast_vae_probe.py [--batch 64]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    BATCH, T_OUT, add_common_args, build_pipeline, count_cost,
    describe_device, empty_cache, frames_for, geometry, share,
    time_pipeline, utilization)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=BATCH)
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, fast = geometry(args.narrow)
    print(f"devices: {describe_device(device)}", flush=True)
    fr = frames_for(args.batch, hw, device)
    results = {}
    for tag, kwargs in (("reference-shape", base),
                        ("fast (s2d stem)", {**base, **fast})):
        pipe, fc = build_pipeline("bfloat16", vae_kwargs=kwargs, hw=hw,
                                  device=device)
        t, c, _ = time_pipeline(pipe, fc, fr)
        flops, nbytes = count_cost(lambda: pipe(fc, fr))
        mfu, bwu = utilization(flops, nbytes, t, device=device)
        print(f"{tag}: first call {c:.1f}s median {t * 1000:.1f} ms -> "
              f"{args.batch * T_OUT / t:.1f} fps, {flops / 1e9:.1f} GFLOP "
              f"and {nbytes / 1e9:.2f} GB counted: {share(mfu)} of the card's "
              f"peak FLOP/s, {share(bwu)} of its peak bytes/s", flush=True)
        results[tag] = dict(ms=t * 1e3, flops=flops, bytes=nbytes, mfu=mfu,
                            bwu=bwu)
        del pipe
        empty_cache(device)
    return results


if __name__ == "__main__":
    main()
