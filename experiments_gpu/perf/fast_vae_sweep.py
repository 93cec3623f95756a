"""Fast-VAE serving roofline on the card: batch sweep and shares of the
card's peaks, bf16 and int8_static (counterpart of
experiments/perf/fast_vae_sweep.py).

The pixel-unshuffle VAE's 12-step rollout at each batch, bf16 and
``int8_static`` (calibrated on that batch, bench.py's recipe; the
hand-written int8 conv and quantize kernels), each scored against the fast
VAE's own fp32 output at that batch (computed in calls of at most 256
sequences: every op is per sample, so this equals one call), with the
shares of the card's peak FLOP/s (bf16, or int8 for int8_static) and peak
bytes/s that the call's counted FLOPs and bytes reach
(``bench_helpers.count_cost``, printed beside them). Prints a table.

    python experiments_gpu/perf/fast_vae_sweep.py [B ...]   # default 64 128 256
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    GATE, T_OUT, add_common_args, build_pipeline, count_cost,
    describe_device, empty_cache, fp32_reference, frame_ssim, frames_for,
    geometry, share, time_pipeline, utilization)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

BATCHES = (64, 128, 256)
CHUNK = 256


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("batches", nargs="*", type=int, default=list(BATCHES))
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, fast = geometry(args.narrow)
    kw = {**base, **fast}
    print(f"devices: {describe_device(device)}", flush=True)
    all_frames = frames_for(max(args.batches), hw, device)
    pipe32, fc32 = build_pipeline("float32", vae_kwargs=kw, hw=hw,
                                  device=device)
    rows = []
    for b in args.batches:
        frames = all_frames[:b]
        t0 = time.perf_counter()
        ref = fp32_reference(pipe32, fc32, frames, CHUNK)
        print(f"B={b}: fp32 reference done ({time.perf_counter() - t0:.0f}s)",
              flush=True)
        for tag, mode in (("bf16", "native"), ("int8_static", "int8_static")):
            pipe, fc = build_pipeline(
                "bfloat16", conv_mode=mode, vae_kwargs=kw, hw=hw,
                device=device,
                calib_frames=frames if mode == "int8_static" else None)
            t, c, out = time_pipeline(pipe, fc, frames)
            fps = b * T_OUT / t
            s = frame_ssim(ref, out)
            flops, nbytes = count_cost(lambda: pipe(fc, frames))
            mfu, bwu = utilization(flops, nbytes, t,
                                   "int8" if mode == "int8_static" else "bf16",
                                   device)
            gate = "PASS" if s >= GATE else "fail"
            rows.append((b, tag, t, fps, s, gate, mfu, bwu))
            print(f"B={b} {tag}: first call {c:.1f}s, {t * 1000:.1f} ms -> "
                  f"{fps:,.0f} fps, self-gate {s:.5f} {gate}, {share(mfu)} "
                  f"of the card's peak ops/s, {share(bwu)} of its peak "
                  f"bytes/s (counted {flops or 0:.6e} FLOP, {nbytes or 0:.6e} "
                  f"bytes)", flush=True)
            del pipe, out
            empty_cache(device)
        del ref

    print("\n| B | path | median | frames/s | self-gate | share of peak "
          "ops/s | share of peak bytes/s |", flush=True)
    print("|---|---|---|---|---|---|---|", flush=True)
    for b, tag, t, fps, s, gate, mfu, bwu in rows:
        print(f"| {b} | {tag} | {t * 1000:.1f} ms | {fps:,.0f} | {s:.5f} "
              f"{gate} | {share(mfu)} | {share(bwu)} |", flush=True)
    return rows


if __name__ == "__main__":
    main()
