"""The one-sequence serving tick (B=1) of bench.py's quantized pipelines on
the card, where the host's launch cost bounds the call: the fast VAE in
int8_static and in bf16, and the reference VAE in int8_static, all bf16
and calibrated in fp32 on the serving batch (64 sequences), as
``experiments_gpu/perf/int8_fast_vae.py`` builds them.

Each round times every pipeline in turn (median of ``--reps`` calls between
CUDA events, after a warm-up call), so that two checkouts of the port run
one after the other on one card compare call for call. Prints one line a
pipeline and round, then one JSON object: per pipeline the round medians in
ms and the kernel launches of one call (int8 conv, quantize, GroupNorm).

    python experiments_gpu/perf/int8_b1_tick.py [--reps 50] [--rounds 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    BATCH, add_common_args, build_pipeline, calibrate_qscales,
    describe_device, frames_for, geometry, timed)
from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def launches(fn, device):
    """(int8 conv, quantize, GroupNorm) kernel launches of one fn() call."""
    int8_conv.conv_launches = int8_conv.quantize_launches = 0
    groupnorm.launches = 0
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (int8_conv.conv_launches, int8_conv.quantize_launches,
            groupnorm.launches)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=3)
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, fast = geometry(args.narrow)
    print(f"devices: {describe_device(device)}", flush=True)
    serving = frames_for(BATCH, hw, device)
    one = serving[:1]

    pipes = {}
    for name, kw, mode in (("fast int8_static", {**base, **fast},
                            "int8_static"),
                           ("fast bf16", {**base, **fast}, "native"),
                           ("reference int8_static", base, "int8_static")):
        qs = (calibrate_qscales(serving, kw) if mode == "int8_static"
              else None)
        pipe, fc = build_pipeline("bfloat16", mode, vae_kwargs=kw, hw=hw,
                                  device=device, qscales=qs)
        pipes[name] = (lambda pipe=pipe, fc=fc: pipe(fc, one))
    result = {name: {"ms": [], "launches": launches(fn, device)}
              for name, fn in pipes.items()}
    for r in range(args.rounds):
        for name, fn in pipes.items():
            med, _, _ = timed(fn, device, args.reps)
            result[name]["ms"].append(med * 1e3)
            print(f"round {r}: {name} B=1 {med * 1e3:.3f} ms a call (median "
                  f"of {args.reps}); launches int8 conv / quantize / "
                  f"GroupNorm {result[name]['launches']}", flush=True)
    for v in result.values():
        v["median_ms"] = statistics.median(v["ms"])
    print(json.dumps({"b1_tick": result}))


if __name__ == "__main__":
    main()
