"""Serving-batch sweep of the reference rollout on the card, with the SSIM
gate (counterpart of experiments/perf/batch_sweep.py).

bf16 rollout throughput (the reference-shape VAE + DLinear, 13 -> 12 frames
of 128^2) at B in {64, 96, 128}, each gated against an fp32 run of the same
frames (bench.py's 0.995 SSIM contract); the fp32 reference runs in calls of
at most 64 sequences (every op is per sample, so this equals one call).
Prints the largest batch that passes. With random weights the bf16 SSIM
depends on the draw, so a FAIL is a measurement, not a crash.

    python experiments_gpu/perf/batch_sweep.py [--batches 64,96,128]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    BATCH, GATE, T_OUT, add_common_args, build_pipeline, describe_device,
    empty_cache, fp32_reference, frame_ssim, frames_for, geometry,
    time_pipeline)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="64,96,128")
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, _ = geometry(args.narrow)
    print(f"devices: {describe_device(device)}", flush=True)
    p16, f16 = build_pipeline("bfloat16", vae_kwargs=base, hw=hw,
                              device=device)
    p32, f32 = build_pipeline("float32", vae_kwargs=base, hw=hw,
                              device=device)
    results = {}
    for b in (int(v) for v in args.batches.split(",")):
        fr = frames_for(b, hw, device)
        t16, c16, out16 = time_pipeline(p16, f16, fr)
        print(f"bf16 B={b}: first call {c16:.1f}s median {t16 * 1000:.1f} ms "
              f"-> {b * T_OUT / t16:.1f} fps", flush=True)
        s = frame_ssim(fp32_reference(p32, f32, fr, BATCH), out16)
        results[b] = (t16, s)
        print(f"  gate SSIM bf16 vs fp32 {s:.5f} "
              f"({'PASS' if s > GATE else 'FAIL'})", flush=True)
        del out16, fr
        empty_cache(device)
    best = max((b for b, (_, s) in results.items() if s > GATE),
               default=None)
    print(f"largest gate-passing batch: {best}", flush=True)
    return results


if __name__ == "__main__":
    main()
