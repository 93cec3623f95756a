"""Full-resolution 384^2 serving rollout: the reference-shape VAE against the
fast (pixel-unshuffle) VAE at the reference's main geometry, on the card
(counterpart of experiments/perf/full_res_serving.py).

Both map 384^2 frames to 4x48x48 latents; the 12-step rollout of each:

  * reference shape: block_out_channels (64, 128, 256, 512), 3 downsamples
    (384 -> 48), full-resolution convs; its C=64 and C=128 GroupNorms at
    384^2 take the GroupNorm kernel's two-pass path (counted and printed);
  * fast: pixel_unshuffle=4 + (128, 256), one conv downsample (96 -> 48),
    no full-resolution conv.

Each bf16 recipe is gated against its own fp32 output (the two are
different models), computed ``CHUNK`` sequences at a time: every op is per
sample, so the chunked reference equals one call. An out-of-memory error
at an (architecture, B) point is recorded as a result (the allocator's
cache emptied after it), as the JAX script records one; any other error
propagates.

    python experiments_gpu/perf/full_res_serving.py [--batches 4,8]
        [--fast-batches 4,16,64]

The JAX script's backend retry and persistent compile cache are TPU
services with no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    GATE, NARROW_VAE, T_OUT, add_common_args, build_pipeline,
    describe_device, empty_cache, fp32_reference, frame_ssim, frames_for,
    time_pipeline)
from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

# the reference's full-resolution geometry
HW = 384
REFERENCE_SHAPE = dict(block_out_channels=(64, 128, 256, 512),
                       latent_channels=4)
FAST_SHAPE = dict(pixel_unshuffle=4, block_out_channels=(128, 256),
                  latent_channels=4)
CHUNK = 4  # sequences per call of the fp32 self-gate reference
NARROW = (32, dict(NARROW_VAE, block_out_channels=(8, 16, 16, 16)),
          dict(NARROW_VAE, pixel_unshuffle=4, block_out_channels=(8, 16)))


def measure(tag, kw, b, all_frames, hw, device):
    """One (architecture, B) point: a result dict, or the OOM it met."""
    try:
        frames = all_frames[:b]
        pipe32, fc32 = build_pipeline("float32", vae_kwargs=kw, hw=hw,
                                      device=device)
        ref = fp32_reference(pipe32, fc32, frames, CHUNK)
        del pipe32
        pipe16, fc16 = build_pipeline("bfloat16", vae_kwargs=kw, hw=hw,
                                      device=device)
        gn0, two0 = groupnorm.launches, groupnorm.two_pass_launches
        t16, first_s, out16 = time_pipeline(pipe16, fc16, frames, n_rep=10)
        calls = 11   # the first call and 10 timed
        gn = (groupnorm.launches - gn0) / calls
        two = (groupnorm.two_pass_launches - two0) / calls
        s = frame_ssim(ref, out16)
        fps = b * T_OUT / t16
        print(f"{tag:<18} B={b:<3} bf16: first call {first_s:.1f}s, median "
              f"{t16 * 1000:.1f} ms -> {fps:.1f} frames/s @{hw}^2, self-gate "
              f"{s:.5f} {'PASS' if s > GATE else 'FAIL'}; GN launches "
              f"{gn:g} a call ({two:g} two-pass)", flush=True)
        return dict(ms=t16 * 1e3, fps=fps, ssim=s, gn=gn, two_pass=two)
    except torch.cuda.OutOfMemoryError as e:   # the fit IS a measurement
        msg = str(e).splitlines()
        oom = next((ln for ln in msg if "memory" in ln.lower()),
                   msg[0] if msg else repr(e))
        print(f"{tag:<18} B={b:<3} bf16: DOES NOT FIT — {oom.strip()[:160]}",
              flush=True)
        return dict(oom=oom.strip())
    finally:
        empty_cache(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="4,8",
                   help="reference-shape batch sizes")
    p.add_argument("--fast-batches", default="4,16,64",
                   help="fast-arch batch sizes (no full-res activations, "
                        "so it scales much further)")
    args = add_common_args(p).parse_args(argv)
    batches = [int(b) for b in args.batches.split(",")]
    fast_batches = [int(b) for b in args.fast_batches.split(",")]
    device = resolve_device(args.device)
    hw, ref_kw, fast_kw = (NARROW if args.narrow
                           else (HW, REFERENCE_SHAPE, FAST_SHAPE))

    print(f"devices: {describe_device(device)}", flush=True)
    if device.type == "cuda":
        free, total = torch.cuda.mem_get_info(device)
        print(f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free; the fp32 "
              f"reference runs in chunks of {CHUNK}", flush=True)
    all_frames = frames_for(max(batches + fast_batches), hw, device)
    results = {}
    for tag, kw, blist in (("reference-shape", ref_kw, batches),
                           ("fast (s2d stem)", fast_kw, fast_batches)):
        for b in blist:
            results[(tag, b)] = measure(tag, kw, b, all_frames, hw, device)
    return results


if __name__ == "__main__":
    main()
