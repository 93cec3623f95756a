#!/usr/bin/env python
"""Time the port's kernels on one NVIDIA GPU, call shape by call shape.

    python3 kernel_timing.py [TWO_PASS_SOURCE] [--int8-parent INT8_SOURCE]
                             [--only-int8]

needs one NVIDIA GPU and nvcc. It records the GroupNorm call shapes of one
bf16 reference-shape pipeline call (B=64) and one fast-VAE call (B=256), and
the int8 conv call shapes of the int8_static reference call (B=64) and the
fast VAE under INT8_MIXED_SPEC (B=256), as chip_smoke.py does, and takes its
configurations, inputs, bounds and CUDA graph timing from there. Every time
is device time inside a CUDA graph.

- For each GroupNorm call shape, the kernel at every plan (channel run of
  32-256 bytes, clusters of 1-16 blocks holding 8-128 KB each) beside the
  plan `_plan` picks.
- The stencil kernel at the training shapes (B=2 and B=32) with bands of 1
  to 16 rows, each with every frame of the band in flight at once (ring =
  T) and with the ring schedule (ring = T - 1: one wait and one refill a
  frame pair), beside the band and ring `_band` picks.
- With TWO_PASS_SOURCE, the groupnorm_silu.cu of an earlier commit whose
  two-pass design has the kernels gn_stats_cl, gn_combine and
  gn_apply<T, VEC, true> (commit 496b5f4; unpack it with `git archive`):
  for each call shape that design with all three launches and each launch
  alone, against the kernel of this checkout, in turns (two-pass, this
  checkout, this checkout, two-pass), so both are measured on one card in
  one process.
- For each int8 conv call shape, the conv kernel at every plan of
  `int8_plans` (the im2col and the gather design, tile widths, ring depths,
  the weights streamed or resident) beside the plan `plan` picks.
- With --int8-parent, the int8_conv.cu of an earlier commit whose
  int8_conv2d_forward takes a tile id (0, 1, 2) as its last int (commit
  884415f; unpack it with `git archive`), built beside this checkout's and
  timed against it at every int8 call shape in turns (parent, this
  checkout, this checkout, parent); both must give the same bits.
- --only-int8 skips the GroupNorm and stencil measurements.

It prints one line per measurement and a JSON summary as its last line.
Without a GPU it exits 2.
"""

import argparse
import collections
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from chip_smoke import (BATCH, FAST_BATCH, FAST_VAE, HW, INT8_MIXED_SPEC,
                        REFERENCE_VAE, STENCIL_CLASSES, T_IN, T_OUT, codec,
                        gn_bound, gn_inputs, graph_ms, int8_bound, int8_codes,
                        record_gn_calls, record_int8_calls)

REPS = 20
INT8_REPS = 5
# Entry points added beside the two-pass source: its own launch sequence
# (channels_last, 16-byte vectors) with each of the three launches optional.
PHASES_CU = r"""
#include "%(source)s"
namespace {
template <typename T, int VEC>
cudaError_t phases(const void* x, void* y, const float* scale,
                   const float* bias, void* part, void* mean_rstd, int64_t n,
                   int c, int64_t hw, int groups, float eps, int silu,
                   int chunks, int mask, cudaStream_t stream) {
  using S = typename T::S;
  const S* xs = static_cast<const S*>(x);
  Stats* ps = static_cast<Stats*>(part);
  float2* mr = static_cast<float2*>(mean_rstd);
  const int64_t rows = n * groups;
  if (mask & 1) {
    const int tpr = c / VEC;
    const int per_block = tpr >= 256 ? 1 : 256 / tpr;
    const size_t smem = (2 * static_cast<size_t>(per_block) * c + per_block) *
                        sizeof(float);
    gn_stats_cl<T, VEC><<<dim3(static_cast<unsigned>(n), chunks),
                          per_block * tpr, smem, stream>>>(xs, ps, hw, c,
                                                           groups);
  }
  if (mask & 2)
    gn_combine<<<static_cast<unsigned>((rows + 255) / 256), 256, 0,
                 stream>>>(ps, mr, rows, chunks, eps);
  if (mask & 4) {
    const int64_t total = n * c * hw;
    int64_t blocks = (total / VEC + 255) / 256;
    if (blocks > 132 * 32) blocks = 132 * 32;
    gn_apply<T, VEC, true><<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
        xs, static_cast<S*>(y), mr, scale, bias, total, hw, c, groups, silu);
  }
  return cudaGetLastError();
}
}  // namespace
extern "C" int gn_phases(const void* x, void* y, const float* scale,
                         const float* bias, void* part, void* mean_rstd,
                         long long n, long long c, long long hw, int groups,
                         float eps, int silu, int chunks, int mask,
                         void* stream) {
  return phases<BF16, 8>(x, y, scale, bias, part, mean_rstd, n, (int)c, hw,
                         groups, eps, silu, chunks, mask,
                         static_cast<cudaStream_t>(stream));
}
"""


def build_two_pass(source, out_dir):
    from torch.utils.cpp_extension import CUDA_HOME

    cu = os.path.join(out_dir, "gn_two_pass_phases.cu")
    with open(cu, "w") as f:
        f.write(PHASES_CU % {"source": os.path.abspath(source)})
    so = os.path.join(out_dir, "gn_two_pass_phases.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gn_phases.argtypes = [p, p, p, p, p, p, ll, ll, ll, i, ctypes.c_float,
                              i, i, i, p]
    lib.gn_phases.restype = ctypes.c_int
    return lib


def record_calls(cfg, batch):
    """GroupNorm calls of one bf16 pipeline call at `batch`, largest first."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    vae = AutoencoderKL(**cfg, seed=0).to(torch.bfloat16)
    pipe = make_forecast_pipeline(**codec(vae, torch.bfloat16))
    frames = torch.zeros((batch, T_IN, 1, HW, HW), dtype=torch.uint8,
                         device="cuda")
    with torch.inference_mode():
        calls = record_gn_calls(
            vae, lambda: pipe(DLinear(T_IN, T_OUT, kernel_size=25), frames))
    del vae, pipe, frames
    torch.cuda.empty_cache()
    return sorted(calls.items(), key=lambda kv: -np.prod(kv[0][0]))


def bf16_inputs(shape, seed):
    """bf16 channels_last x with bf16 scale and bias, as the bf16 VAE."""
    import torch

    x, s, b = gn_inputs(shape, torch.bfloat16, True, seed)
    return x, s.to(x.dtype), b.to(x.dtype)


def two_pass_rows(lib, calls, sms):
    """Per call shape: the two-pass design (all, stats, combine, apply) and
    this checkout's kernel, in graphs, in turns."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm

    tot = collections.defaultdict(float)
    for i, ((shape, _, cl, groups, eps, silu), count) in enumerate(calls):
        if not cl:
            raise AssertionError(f"{shape}: not channels_last")
        n, c, h, w = shape
        x, s, b = bf16_inputs(shape, 1000 + i)
        s32, b32 = s.float(), b.float()
        y = torch.empty_like(x)
        # statistics blocks per sample, as the two-pass wrapper chose them
        tpr = c // 8
        rows = 1 if tpr >= 256 else 256 // tpr
        chunks = max(1, min(-(-4 * sms // n), -(-h * w // (4 * rows)), 65535))
        part = torch.empty(n * groups * chunks * 3, device="cuda")
        mean_rstd = torch.empty(n * groups * 2, device="cuda")

        def two_pass(mask):
            rc = lib.gn_phases(
                x.data_ptr(), y.data_ptr(), s32.data_ptr(), b32.data_ptr(),
                part.data_ptr(), mean_rstd.data_ptr(), n, c, h * w, groups,
                eps, int(silu), chunks, mask,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"gn_phases: CUDA error {rc}")

        def new():
            return groupnorm.group_norm_silu_cuda(x, s, b, groups, eps, silu)

        two_pass(7)
        want = groupnorm.group_norm_silu_reference(x, s, b, groups, eps, silu)
        errs = [float((got.float() - want.float()).abs().max())
                for got in (y, new())]
        del want
        t_all = [graph_ms(lambda: two_pass(7), REPS)]
        t_new = [graph_ms(new, REPS), graph_ms(new, REPS)]
        t_all.append(graph_ms(lambda: two_pass(7), REPS))
        t_ph = [graph_ms(lambda m=m: two_pass(m), REPS) for m in (1, 2, 4)]
        row = dict(all=float(np.mean(t_all)), stats=t_ph[0],
                   combine=t_ph[1], apply=t_ph[2], new=float(np.mean(t_new)),
                   bound=gn_bound(x, s, silu)[0])
        for k, v in row.items():
            tot[k] += count * v
        print(f"  {count:2d} x N={n} C={c} {h}x{w} eps={eps:g} silu={silu}: "
              f"two-pass {row['all']:.4f} ({t_all[0]:.4f}, {t_all[1]:.4f}) "
              f"= stats {t_ph[0]:.4f} + combine {t_ph[1]:.4f} + apply "
              f"{t_ph[2]:.4f}; this checkout {row['new']:.4f} "
              f"({t_new[0]:.4f}, {t_new[1]:.4f}); bound {row['bound']:.4f} "
              f"(two-pass {row['bound'] / row['all']:.0%}, this checkout "
              f"{row['bound'] / row['new']:.0%}); max abs err two-pass "
              f"{errs[0]:.3g}, this checkout {errs[1]:.3g}", flush=True)
        del x, y, part, mean_rstd
        torch.cuda.empty_cache()
    return dict(tot)


def sweep_rows(calls, smem, max_cluster):
    """Per call shape: this checkout's kernel at every plan, beside
    `_plan`'s (the plan is swapped in for the wrapper's `_plan`)."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm

    plan = groupnorm._plan
    tot = collections.defaultdict(float)
    for i, ((shape, _, _, groups, eps, silu), count) in enumerate(calls):
        n, c, h, w = shape
        hw = h * w
        x, s, b = bf16_inputs(shape, 2000 + i)

        def kernel():
            return groupnorm.group_norm_silu_cuda(x, s, b, groups, eps, silu)

        chosen = plan(n, c, hw, groups, 2, smem, max_cluster)
        run_of = c // groups * 2
        timed = {}
        try:
            for run in groupnorm.RUN_BYTES:
                k = run // run_of
                if run % run_of or groups % k:
                    continue
                for cs in (1, 2, 4, 8, 16):
                    ppb = -(-hw // cs)
                    if cs > max_cluster or not 8192 <= ppb * run <= 131072:
                        continue
                    groupnorm._plan = lambda *a, p=(k, cs, ppb, 8): p
                    try:
                        timed[(run, cs)] = graph_ms(kernel, REPS // 2)
                    except RuntimeError as e:  # a cluster the card refuses
                        print(f"    run {run} B / cluster {cs}: {e}")
        finally:
            groupnorm._plan = plan
        key = (chosen[0] * run_of, chosen[1])
        if key not in timed:
            timed[key] = graph_ms(kernel, REPS // 2)
        best = min(timed, key=timed.get)
        tot["chosen"] += count * timed[key]
        tot["best"] += count * timed[best]
        tot["bound"] += count * gn_bound(x, s, silu)[0]
        print(f"  {count:2d} x N={n} C={c} {h}x{w}: plan run {key[0]} B / "
              f"cluster {key[1]} {timed[key]:.4f} ms; best run {best[0]} B "
              f"/ cluster {best[1]} {timed[best]:.4f} ms; all: " + ", ".join(
                  f"{r}/{c_}:{t:.4f}" for (r, c_), t in sorted(timed.items())),
              flush=True)
        del x
        torch.cuda.empty_cache()
    return dict(tot)


def stencil_sweep():
    """The stencil kernel at the training shapes: bands of 1-16 rows, each
    with all frames in flight (ring T) and the ring schedule (ring T - 1);
    the band and ring are swapped in for the wrapper's `_band`."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    band = cs._band
    out = {}
    for shape in STENCIL_CLASSES[:2]:
        b, t, c, h, w = shape
        x = torch.rand(shape, device="cuda")
        u, v, k = torch.tensor([0.0, 0.0, 0.05], device="cuda")
        want = ps.advection_diffusion_loss(x, u, v, k)
        chosen = band(b, c, t, h, w)
        timed = {}
        try:
            for plan in [(r, g) for r in (1, 2, 4, 8, 16)
                         for g in (t, t - 1)] + [chosen]:
                cs._band = lambda *a, p=plan: p
                got = float(ps.advection_diffusion_loss(x, u, v, k))
                if not abs(got - float(want)) <= 1e-5 * abs(float(want)):
                    raise AssertionError(f"{shape} band and ring {plan}: "
                                         f"{got} vs {float(want)}")
                timed[plan] = min(graph_ms(
                    lambda: ps.advection_diffusion_loss(x, u, v, k), 100)
                    for _ in range(3))
        finally:
            cs._band = band
        print(f"  stencil {shape}: `_band` picks {chosen[0]} rows, ring "
              f"{chosen[1]}: {1e3 * timed[chosen]:.2f} us; min of 3 graphs, "
              f"us, all frames in flight (ring {t}) / ring schedule (ring "
              f"{t - 1}): " + ", ".join(
                  f"{r} rows {1e3 * timed[(r, t)]:.2f} / "
                  f"{1e3 * timed[(r, t - 1)]:.2f}" for r in (1, 2, 4, 8, 16)),
              flush=True)
        out[str(shape)] = {f"{r} rows ring {g}": 1e3 * ms
                           for (r, g), ms in timed.items()}
    return out


def int8_call_shapes():
    """int8 conv call shapes of one int8_static reference call (B=64) and
    one fast-VAE INT8_MIXED_SPEC call (B=256), bf16, largest first. The
    scales stay at their defaults: the shapes do not depend on them."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    out = {}
    for name, cfg, batch, mode in (
            ("int8_static reference", REFERENCE_VAE, BATCH, "int8_static"),
            ("fast int8-mixed", FAST_VAE, FAST_BATCH, INT8_MIXED_SPEC)):
        vae = AutoencoderKL(**cfg, conv_mode=mode, seed=0).to(torch.bfloat16)
        pipe = make_forecast_pipeline(**codec(vae, torch.bfloat16))
        frames = torch.zeros((batch, T_IN, 1, HW, HW), dtype=torch.uint8,
                             device="cuda")
        with torch.inference_mode():
            calls = record_int8_calls(vae, lambda: pipe(
                DLinear(T_IN, T_OUT, kernel_size=25), frames))
        out[name] = sorted(calls.items(), key=lambda kv: -np.prod(kv[0][:5]))
        del vae, pipe, frames
        torch.cuda.empty_cache()
    return out


def build_int8_parent(source, out_dir):
    """nvcc the parent's int8_conv.cu into a library of its own."""
    from torch.utils.cpp_extension import CUDA_HOME

    so = os.path.join(out_dir, "int8_conv_parent.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.abspath(source)], check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_conv2d_forward.argtypes = [p, p, p, p, p, i] + [i] * 14 + [p]
    lib.int8_conv2d_forward.restype = i
    return lib


def int8_inputs(key, seed):
    """Codes, scale and bias of one call shape, and the wrapper's arguments."""
    n, h, w, cin, cout, k, s, pad, dtype = key
    xq, wq, scale, bias = int8_codes(n, h, w, cin, cout, k, seed)
    return xq, wq, scale, bias, (xq, wq, scale, bias, (s, s), pad, dtype)


def int8_parent_rows(lib, calls):
    """Per call shape: the parent's kernel and this checkout's, in graphs,
    in turns; the same bits or fail."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    tot = collections.defaultdict(float)
    for i, (key, count) in enumerate(calls):
        n, h, w, cin, cout, k, s, pad, dtype = key
        xq, wq, scale, bias, args = int8_inputs(key, 3000 + i)
        ho, wo = ic.out_size(h, w, k, k, (s, s), pad)
        y = torch.empty((n, ho, wo, cout), dtype=dtype, device="cuda")
        tile = 0 if cout >= 128 else 1 if cout > 16 else 2

        def parent():
            rc = lib.int8_conv2d_forward(
                xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), int(dtype == torch.bfloat16),
                n, h, w, xq.shape[-1], cout, k, k, s, s, pad[0], pad[2], ho,
                wo, tile, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"parent int8_conv2d_forward: CUDA {rc}")

        def new():
            return ic.int8_conv2d_nhwc_cuda(*args)

        parent()
        if not torch.equal(y, new()):
            raise AssertionError(f"parent and this checkout differ at {key}")
        t_parent = [graph_ms(parent, INT8_REPS)]
        t_new = [graph_ms(new, INT8_REPS), graph_ms(new, INT8_REPS)]
        t_parent.append(graph_ms(parent, INT8_REPS))
        row = dict(parent=float(np.mean(t_parent)), new=float(np.mean(t_new)),
                   bound=int8_bound(n, h, w, cin, cout, k, s, pad, 2)[0])
        for name, v in row.items():
            tot[name] += count * v
        print(f"  {count:2d} x N={n} {h}x{w} {cin}->{cout} k{k} s{s}: parent "
              f"{row['parent']:.4f} ({t_parent[0]:.4f}, {t_parent[1]:.4f}); "
              f"this checkout {row['new']:.4f} ({t_new[0]:.4f}, "
              f"{t_new[1]:.4f}); bound {row['bound']:.4f} (parent "
              f"{row['bound'] / row['parent']:.0%}, this checkout "
              f"{row['bound'] / row['new']:.0%})", flush=True)
        del xq, wq, y, args
        torch.cuda.empty_cache()
    return dict(tot)


def int8_plans(cout, kh, kw, cp, out_bytes, im2col):
    """Every plan the sweep times for a conv: `plan`'s own first; the
    im2col design (where TMA's im2col mode takes the conv and Cp is a
    multiple of 64) and the gather design, at the widest tile Cout fills
    (the gather's at most 128) and 128 beside 256, with the weights
    streamed (rings of 3, 4 and the most stages that fit) and, where one
    tile spans Cout, resident (the most that fit)."""
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    k = kh * kw * cp
    plans = [ic.plan(cout, kh, kw, cp, out_bytes, im2col)]
    designs = ([ic.IM2COL] if im2col and cp % 64 == 0 else []) + [ic.GATHER]
    for design in designs:
        bk = ic.stage_k(design, cp)
        most = 8 * 128 // bk
        widths = {ic.ws_width(cout), min(ic.ws_width(cout), 128)}
        for bn in sorted(widths, reverse=True):
            if design == ic.GATHER and bn > ic.GATHER_MAX_BN:
                continue
            top = ic.plan_stages(bn, out_bytes, bk=bk, most=most)
            plans += [ic.Plan(design, bn, st, 0)
                      for st in sorted({3, 4, top}) if st <= top]
            top = ic.plan_stages(bn, out_bytes, k, 1, bk, most)
            if cout <= bn and top:
                plans.append(ic.Plan(design, bn, top, 1))
    return list(dict.fromkeys(plans))


def int8_sweep_rows(calls):
    """Per call shape: this checkout's conv kernel at every plan of
    `int8_plans` (swapped in for the wrapper's `plan`), beside `plan`'s."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    plan = ic.plan
    tot = collections.defaultdict(float)
    for i, (key, count) in enumerate(calls):
        n, h, w, cin, cout, k, s, pad, dtype = key
        xq, wq, scale, bias, args = int8_inputs(key, 4000 + i)
        cands = int8_plans(cout, k, k, xq.shape[-1], 2,
                           ic.im2col_fits(h, w, k, k, (s, s), pad))
        timed = {}
        try:
            for cand in cands:
                ic.plan = lambda *a, c=cand: c
                timed[cand] = graph_ms(
                    lambda: ic.int8_conv2d_nhwc_cuda(*args), INT8_REPS)
        finally:
            ic.plan = plan
        chosen = cands[0]
        best = min(timed, key=timed.get)
        tot["chosen"] += count * timed[chosen]
        tot["best"] += count * timed[best]
        tot["bound"] += count * int8_bound(n, h, w, cin, cout, k, s, pad, 2)[0]
        print(f"  {count:2d} x N={n} {h}x{w} {cin}->{cout} k{k} s{s}: plan "
              f"{tuple(chosen)} {timed[chosen]:.4f} ms; best {tuple(best)} "
              f"{timed[best]:.4f} ms; all (design, bn, stages): " + ", ".join(
                  f"{tuple(c)}:{t:.4f}" for c, t in timed.items()),
              flush=True)
        del xq, wq, args
        torch.cuda.empty_cache()
    return dict(tot)


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser()
    parser.add_argument("two_pass_source", nargs="?")
    parser.add_argument("--int8-parent", metavar="INT8_SOURCE")
    parser.add_argument("--only-int8", action="store_true")
    opts = parser.parse_args()

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    summary = {}
    if not opts.only_int8:
        sms, smem, max_cluster = groupnorm._device_limits(groupnorm.build(), 0)
        cs.build()
        calls = {"reference": record_calls(REFERENCE_VAE, BATCH),
                 "fast": record_calls(FAST_VAE, FAST_BATCH)}
        if opts.two_pass_source:
            lib = build_two_pass(opts.two_pass_source, tempfile.mkdtemp())
            for name, shapes in calls.items():
                print(f"{name} bf16: per call shape, graph ms", flush=True)
                tot = two_pass_rows(lib, shapes, sms)
                print(f"  per call ({sum(n for _, n in shapes)} GroupNorms): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()),
                      flush=True)
                summary[f"{name}_two_pass"] = tot
        for name, shapes in calls.items():
            print(f"{name} bf16: plans per call shape, graph ms (run B / "
                  f"cluster: ms)", flush=True)
            tot = sweep_rows(shapes, smem, max_cluster)
            print(f"  per call: " + ", ".join(
                f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
            summary[f"{name}_sweep"] = tot
        summary["stencil_us"] = stencil_sweep()

    ic.build()
    int8_calls = int8_call_shapes()
    if opts.int8_parent:
        lib = build_int8_parent(opts.int8_parent, tempfile.mkdtemp())
        for name, shapes in int8_calls.items():
            print(f"{name} bf16: int8 conv per call shape, parent vs this "
                  f"checkout, graph ms", flush=True)
            tot = int8_parent_rows(lib, shapes)
            print(f"  per call ({sum(n for _, n in shapes)} int8 convs): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()),
                  flush=True)
            summary[f"{name}_int8_parent"] = tot
    for name, shapes in int8_calls.items():
        print(f"{name} bf16: int8 conv plans per call shape, graph ms",
              flush=True)
        tot = int8_sweep_rows(shapes)
        print(f"  per call: " + ", ".join(
            f"{k} {v:.3f}" for k, v in tot.items()), flush=True)
        summary[f"{name}_int8_sweep"] = tot
    print(smi, flush=True)
    print(json.dumps({"kernel_timing_ms": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
