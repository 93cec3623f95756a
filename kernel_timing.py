#!/usr/bin/env python
"""Time the port's two kernels on one NVIDIA GPU, call shape by call shape.

    python3 kernel_timing.py [TWO_PASS_SOURCE]

needs one NVIDIA GPU and nvcc. It records the GroupNorm call shapes of one
bf16 reference-shape pipeline call (B=64) and one fast-VAE call (B=256), as
chip_smoke.py does, and takes its configurations, inputs, bound and CUDA
graph timing from there. Every time is device time inside a CUDA graph.

- For each call shape, the GroupNorm kernel at every plan (channel run of
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

It prints one line per measurement and a JSON summary as its last line.
Without a GPU it exits 2.
"""

import collections
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from chip_smoke import (BATCH, FAST_BATCH, FAST_VAE, HW, REFERENCE_VAE,
                        STENCIL_CLASSES, T_IN, T_OUT, codec, gn_bound,
                        gn_inputs, graph_ms, record_gn_calls)

REPS = 20
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    two_pass_source = sys.argv[1] if len(sys.argv) > 1 else None

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sms, smem, max_cluster = groupnorm._device_limits(groupnorm.build(), 0)
    cs.build()
    summary = {}
    calls = {"reference": record_calls(REFERENCE_VAE, BATCH),
             "fast": record_calls(FAST_VAE, FAST_BATCH)}
    if two_pass_source:
        lib = build_two_pass(two_pass_source, tempfile.mkdtemp())
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
    print(smi, flush=True)
    print(json.dumps({"kernel_timing_ms": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
