"""Space-to-depth rewrite of the encoder's full-resolution 3x3 conv, on the
card (counterpart of experiments/perf/space_to_depth.py).

The JAX script asks whether the TPU's 128-wide lanes idle under a 64-channel
conv. On the card the question is cuDNN's: does a 3x3 64 -> 64 conv at
128^2 cost as much as the same conv with 128 output channels (2x the
FLOPs), and does an exact space-to-depth rewrite (2x2 pixels packed into
channels: per output subpixel (a, b) a 2x2 conv over the packed (H/2, W/2,
4C) input with asymmetric padding, 16/9 the original MACs) run faster? It
times, on cuDNN in ``--dtype``:

  1. ``occupancy``: the original conv against the 128-output-channel conv;
  2. ``s2d``: the rewrite on packed input, and with the packing and
     unpacking included.

Equivalence is asserted (atol 1e-4, fp32) before any timing, so the numbers
compare equal functions. The packed channel index is (u*2 + v)*C + c, as
``models/common.py::space_to_depth`` packs.

    python experiments_gpu/perf/space_to_depth.py            # on the card
    python experiments_gpu/perf/space_to_depth.py --check-only --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from experiments_gpu.perf.bench_helpers import describe_device, timed  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2); channel index (u*2 + v)*C + c."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // 2, 2, w // 2, 2)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, 4 * c, h // 2, w // 2)


def depth_to_space(y: torch.Tensor) -> torch.Tensor:
    n, c4, hh, ww = y.shape
    c = c4 // 4
    y = y.reshape(n, 2, 2, c, hh, ww)
    return y.permute(0, 3, 4, 1, 5, 2).reshape(n, c, 2 * hh, 2 * ww)


def packed_kernels(w: np.ndarray):
    """3x3 stride-1 SAME conv kernel (3, 3, C, K) -> four 2x2 packed kernels.

    For output subpixel (a, b), original tap (di, dj) with di = 2*(s + s0)
    + u - a (s in {0, 1} the packed kernel row, s0 = -1 if a == 0 else 0),
    and the packed input channel is (u*2 + v)*C + c. Returns
    {(a, b): (kernel (2, 2, 4C, K), pad_h, pad_w)}: the asymmetric packed
    padding is (1, 0) for subpixel 0 and (0, 1) for subpixel 1."""
    c, k = w.shape[2], w.shape[3]
    out = {}
    for a in (0, 1):
        for b in (0, 1):
            kp = np.zeros((2, 2, 4 * c, k), w.dtype)
            s0 = -1 if a == 0 else 0
            t0 = -1 if b == 0 else 0
            for s in (0, 1):
                for u in (0, 1):
                    di = 2 * (s + s0) + u - a
                    if not -1 <= di <= 1:
                        continue
                    for tt in (0, 1):
                        for v in (0, 1):
                            dj = 2 * (tt + t0) + v - b
                            if not -1 <= dj <= 1:
                                continue
                            kp[s, tt, (u * 2 + v) * c:(u * 2 + v + 1) * c, :] \
                                = w[di + 1, dj + 1, :, :]
            pad_h = (1, 0) if a == 0 else (0, 1)
            pad_w = (1, 0) if b == 0 else (0, 1)
            out[(a, b)] = (kp, pad_h, pad_w)
    return out


def torch_packs(w: np.ndarray, dtype, device):
    """packed_kernels as torch (K, 4C, 2, 2) weights on ``device``."""
    return {ab: (torch.from_numpy(np.ascontiguousarray(
        kp.transpose(3, 2, 0, 1))).to(device, dtype), ph, pw)
        for ab, (kp, ph, pw) in packed_kernels(w).items()}


def oihw(w: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        w.transpose(3, 2, 0, 1))).to(device, dtype)


def conv_ref(x, w):
    return F.conv2d(x, w, padding=1)


def conv_s2d(xp, packs):
    """Packed input (N, 4C, H/2, W/2) -> packed output (N, 4K, H/2, W/2)."""
    outs = [F.conv2d(F.pad(xp, (pw[0], pw[1], ph[0], ph[1])), kp)
            for _ab, (kp, ph, pw) in sorted(packs.items())]
    # packed channel order (a*2 + b)*K + k, matching space_to_depth
    return torch.cat(outs, dim=1)


def check_equivalence(seed=0, n=2, hw=32, c=8, k=8, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, c, hw, hw)).astype(
        np.float32)).to(device)
    w = rng.standard_normal((3, 3, c, k)).astype(np.float32) * 0.1
    want = conv_ref(x, oihw(w, torch.float32, device))
    got = depth_to_space(conv_s2d(space_to_depth(x),
                                  torch_packs(w, torch.float32, device)))
    err = float((got - want).abs().max())
    if not err < 1e-4:
        raise AssertionError(f"s2d rewrite NOT equivalent: max err {err}")
    print(f"equivalence OK (max abs err {err:.2e})", flush=True)
    return err


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--check-only", action="store_true")
    p.add_argument("--n", type=int, default=832,
                   help="batch (bench encode folds B*T_in = 64*13 = 832)")
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--c", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {describe_device(device)}", flush=True)

    check_equivalence(device=device)
    if args.check_only:
        return None

    dt = getattr(torch, args.dtype)
    rng = np.random.default_rng(0)
    # the activations drawn on the device (numpy would take seconds for
    # 832 x 64 x 128^2 values; a conv's time does not depend on them)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((args.n, args.hw, args.hw, args.c), generator=gen,
                    device=device).to(dt).permute(0, 3, 1, 2)  # channels_last
    w64 = rng.standard_normal((3, 3, args.c, args.c)).astype(np.float32) * 0.05
    w128 = rng.standard_normal((3, 3, args.c, 2 * args.c)
                               ).astype(np.float32) * 0.05
    packs = torch_packs(w64, dt, device)
    k64, k128 = oihw(w64, dt, device), oihw(w128, dt, device)
    xp = space_to_depth(x).contiguous(memory_format=torch.channels_last)

    def bench_variant(fn, inp, tag):
        with torch.inference_mode():
            t, _, _ = timed(lambda: fn(inp), device, args.reps)
        print(f"{tag}: {t * 1e3:.3f} ms", flush=True)
        return t

    n_pos = args.n * args.hw * args.hw
    macs64 = n_pos * 9 * args.c * args.c
    t_a = bench_variant(lambda v: conv_ref(v, k64), x,
                        f"3x3 {args.c}->{args.c} (original)")
    t_b = bench_variant(lambda v: conv_ref(v, k128), x,
                        f"3x3 {args.c}->{2 * args.c} (2x FLOPs)")
    t_c = bench_variant(lambda v: conv_s2d(v, packs), xp,
                        "s2d exact rewrite (1.78x MACs)")
    t_c_full = bench_variant(
        lambda v: depth_to_space(conv_s2d(space_to_depth(v), packs)), x,
        "s2d rewrite incl. pack/unpack")
    print(f"\nMACs original: {macs64 / 1e9:.1f} G; effective TFLOP/s: "
          f"orig {2 * macs64 / t_a / 1e12:.1f}, 2x-ch "
          f"{4 * macs64 / t_b / 1e12:.1f}, s2d "
          f"{2 * macs64 * 16 / 9 / t_c / 1e12:.1f} (useful: "
          f"{2 * macs64 / t_c / 1e12:.1f})", flush=True)
    print(f"occupancy evidence: 2x-FLOP conv costs {t_b / t_a:.2f}x the time "
          f"(1.0 == the extra output channels came free)", flush=True)
    print(f"s2d verdict: {'WIN' if t_c_full < t_a else 'LOSS'} "
          f"({t_c_full / t_a:.2f}x original conv time)", flush=True)
    return dict(orig=t_a, double=t_b, s2d=t_c, s2d_full=t_c_full)


if __name__ == "__main__":
    main()
