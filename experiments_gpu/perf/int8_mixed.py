"""Mixed int8/float serving on the card: per-layer sensitivity sweep of the
rollout's VAE (counterpart of experiments/perf/int8_mixed.py).

Protocol:
  1. fp32 native rollout -> reference output; bf16 rollout -> bf16 fps;
  2. calibrate per-conv activation abs-max once (the scales depend on the
     architecture and the batch, not on the spec);
  3. leave-one-IN: for each conv family F, quantize only F
     (((F*, int8_static), (*, native))), SSIM vs fp32: the damage of each;
  4. greedy mix: add families in least-damage order, keeping each addition
     that still passes SSIM > 0.995 (the single families' SSIMs of stage 3
     are reused, and if none passes, no superset can and the stage stops);
  5. the winning mix's fps against bf16's.

Prints a table and the winning spec as a Python literal. The selection
(``families``, ``leave_one_in``, ``greedy_mix``) is pure logic that takes
the measurement as a callable. The int8 convs run the hand-written int8
conv and quantize kernels; with random weights the SSIMs depend on the
draw, so the verdict is a measurement of this draw.

    python experiments_gpu/perf/int8_mixed.py [--fast] [--batch N]
        [--families N]

``--fast`` sweeps the pixel-unshuffle fast VAE (3 blocks), gated against
its own fp32 output; ``--families N`` sweeps only the first N families.
The JAX script's backend retry is a TPU service with no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    BATCH, FAST_BATCH, GATE, T_OUT, VAE_CHANNELS, add_common_args,
    build_pipeline, calibrate_qscales, describe_device, empty_cache,
    frame_ssim, frames_for, geometry, time_pipeline)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def families(n_blocks):
    """Conv families of an AutoencoderKL with n_blocks enc/dec blocks.
    quant_conv/post_quant_conv are plain 1x1 convs (never quantized)."""
    return (
        ["encoder/conv_in", "encoder/mid_block", "encoder/conv_out",
         "decoder/conv_in", "decoder/mid_block", "decoder/conv_out"]
        + [f"encoder/down_blocks_{i}" for i in range(n_blocks)]
        + [f"decoder/up_blocks_{i}" for i in range(n_blocks)]
    )


def spec_of(fams):
    """The mixed spec quantizing exactly ``fams``."""
    return tuple((f + "*", "int8_static") for f in fams) + (("*", "native"),)


def leave_one_in(fams, ssim_of):
    """Stage 3: [(1 - SSIM, family)] of each family quantized alone, least
    damage first. ``ssim_of(spec, n_rep)`` measures a spec."""
    damage = []
    for fam in fams:
        t0 = time.perf_counter()
        s = ssim_of(spec_of([fam]), 2)
        damage.append((1.0 - s, fam))
        print(f"  only {fam:<28} int8 -> SSIM {s:.5f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    damage.sort()
    return damage


def greedy_mix(damage, ssim_of, gate=GATE):
    """Stage 4: (chosen families, their SSIM). The first addition reuses
    stage 3's single-family SSIMs; if no single family passes, nothing is
    chosen."""
    chosen, s_mix = [], None
    for d, fam in damage:
        s = 1.0 - d
        ok = s > gate
        print(f"  mix+{fam:<27} SSIM {s:.5f} "
              f"{'PASS' if ok else 'FAIL'} (stage-3 reuse)", flush=True)
        if ok:
            chosen, s_mix = [fam], s
            break
    for _d, fam in damage:
        if not chosen:
            break
        if fam in chosen:
            continue
        trial = chosen + [fam]
        s = ssim_of(spec_of(trial), 2)
        ok = s > gate
        print(f"  mix+{fam:<27} SSIM {s:.5f} {'PASS' if ok else 'FAIL'}",
              flush=True)
        if ok:
            chosen, s_mix = trial, s
    return chosen, s_mix


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--fast", action="store_true",
                   help="sweep the pixel-unshuffle fast VAE (self-gated)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--families", type=int, default=None,
                   help="sweep only the first N conv families")
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, base, fast = geometry(args.narrow)
    vae_kwargs = {**base, **fast} if args.fast else base
    fams = families(len(vae_kwargs.get("block_out_channels", VAE_CHANNELS)))
    fams = fams[:args.families] if args.families else fams
    batch = args.batch or (FAST_BATCH if args.fast else BATCH)

    print(f"devices: {describe_device(device)}", flush=True)
    print(f"arch: {'fast (pixel_unshuffle=4)' if args.fast else 'reference'}"
          f" shape, batch {batch}", flush=True)
    frames = frames_for(batch, hw, device)
    # calibrate once (stage 2): every spec below reuses the scales
    qscales = calibrate_qscales(frames, vae_kwargs)

    def run(dtype, mode, n_rep=10):
        pipe, fc = build_pipeline(
            dtype, conv_mode=mode, vae_kwargs=vae_kwargs, hw=hw,
            device=device, qscales=None if mode == "native" else qscales)
        t, _c, out = time_pipeline(pipe, fc, frames, n_rep=n_rep)
        del pipe
        empty_cache(device)
        return t, out

    t32, ref = run("float32", "native")
    t16, out16 = run("bfloat16", "native")
    fps16 = batch * T_OUT / t16
    print(f"bf16: {fps16:.1f} fps, SSIM vs fp32 {frame_ssim(ref, out16):.5f}",
          flush=True)
    del out16

    def ssim_of(spec, n_rep):
        return frame_ssim(ref, run("bfloat16", spec, n_rep)[1])

    damage = leave_one_in(fams, ssim_of)
    chosen, _ = greedy_mix(damage, ssim_of)
    if not chosen:
        print("RESULT: no family quantizes under the gate — mixed int8 is a "
              "measured negative on this architecture", flush=True)
        return None
    spec = spec_of(chosen)
    t_mix, out = run("bfloat16", spec)
    fps_mix = batch * T_OUT / t_mix
    s_final = frame_ssim(ref, out)
    print(f"\nRESULT: {len(chosen)}/{len(fams)} families int8, "
          f"SSIM {s_final:.5f} (gate {GATE}), "
          f"{fps_mix:.1f} fps vs bf16 {fps16:.1f} "
          f"({(fps_mix / fps16 - 1) * 100:+.1f}%)", flush=True)
    print("INT8_MIXED_SPEC =", repr(spec), flush=True)
    return spec


if __name__ == "__main__":
    main()
