"""int8_static on the fast VAE, on the card: do the two serving wins compose?
(counterpart of experiments/perf/int8_fast_vae.py).

The pixel-unshuffle VAE with ``conv_mode="int8_static"`` (calibrated on the
serving batch; the hand-written int8 conv and quantize kernels, the
GroupNorm kernel) at the serving batch (B=64) and at one sequence (B=1),
beside its fp32 and bf16 rollouts, each scored against the fast VAE's own
fp32 output, with the FLOPs and bytes a serving-batch call counts
(``bench_helpers.count_cost``). Prints a table.

    python experiments_gpu/perf/int8_fast_vae.py [--batch 64]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    BATCH, T_OUT, add_common_args, build_pipeline, count_cost,
    describe_device, empty_cache, frame_ssim, frames_for, geometry,
    time_pipeline)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=BATCH,
                   help="the serving batch (beside B=1)")
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, fast = geometry(args.narrow)
    kw = {**base, **fast}
    print(f"devices: {describe_device(device)}", flush=True)
    frames = frames_for(args.batch, hw, device)

    rows, outs = [], {}
    for tag, dtype, mode in (("fp32", "float32", "native"),
                             ("bf16", "bfloat16", "native"),
                             ("int8_static", "bfloat16", "int8_static")):
        t0 = time.perf_counter()
        pipe, fc = build_pipeline(
            dtype, conv_mode=mode, vae_kwargs=kw, hw=hw, device=device,
            calib_frames=frames if mode == "int8_static" else None)
        t64, c, out = time_pipeline(pipe, fc, frames)
        t1, _, _ = time_pipeline(pipe, fc, frames[:1])
        flops, nbytes = count_cost(lambda: pipe(fc, frames))
        outs[tag] = out
        rows.append((tag, t64, args.batch * T_OUT / t64, t1))
        print(f"{tag}: first call {c:.0f}s (total {time.perf_counter() - t0:.0f}"
              f"s), B={args.batch} {t64 * 1000:.1f} ms -> {rows[-1][2]:.0f} fps, "
              f"B=1 {t1 * 1000:.1f} ms; counted at B={args.batch} "
              f"{flops or 0:.6e} FLOP, {nbytes or 0:.6e} bytes", flush=True)
        del pipe
        empty_cache(device)

    ref = outs["fp32"]
    print(f"\n| path | B={args.batch} median | frames/s | B=1 latency | SSIM vs "
          f"own fp32 |", flush=True)
    print("|---|---|---|---|---|", flush=True)
    table = {}
    for tag, t64, fps, t1 in rows:
        s = frame_ssim(ref, outs[tag])
        table[tag] = dict(ms=t64 * 1e3, fps=fps, b1_ms=t1 * 1e3, ssim=s)
        print(f"| {tag} | {t64 * 1000:.1f} ms | {fps:,.0f} | {t1 * 1000:.1f} "
              f"ms | {s:.5f} |", flush=True)
    return table


if __name__ == "__main__":
    main()
