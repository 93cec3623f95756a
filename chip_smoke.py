#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (weatherforecastingtoolkit_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. the card (nvidia-smi's name and power limit line, printed again before
     the {"kernels": ...} line), torch/CUDA versions, and the
     GroupNorm+SiLU kernel's nvcc build from csrc/ (timed);
  2. the kernel against its plain PyTorch version at every GroupNorm shape
     class of the serving path, small N and N=1, NCHW and channels_last,
     fp32 and bf16, SiLU on/off, eps 1e-6/1e-5;
  3. the main path at full width: the reference-shape VAE
     (64,128,256,512,512) + DLinear(13->12) at batch 64 on synthetic VIL
     frames, fp32 and bf16; median time, frames/s, bf16-vs-fp32 SSIM
     (> SSIM_GATE), and exactly 42 kernel launches per call;
  4. the other variants in bf16: the fast VAE (pixel_unshuffle=4) at batch
     256, the autoregressive rollout at batch 64, the streaming tick at
     batch 1 (init once, then steps), each with its launch count;
  5. the serving path on two sequences, card against CPU (fp32 outputs,
     bf16-vs-fp32 SSIM), and the kernel's time, plain time, library time and
     bound at every GroupNorm call shape of one bf16 pipeline call.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a GPU it exits 2 and prints no result.
"""

import collections
import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

T_IN, T_OUT, HW = 13, 12, 128
BATCH, FAST_BATCH = 64, 256
REFERENCE_VAE = dict(in_channels=1, out_channels=1,
                     block_out_channels=(64, 128, 256, 512, 512),
                     layers_per_block=1, latent_channels=64,
                     norm_num_groups=32)
FAST_VAE = dict(REFERENCE_VAE, block_out_channels=(128, 256, 512),
                pixel_unshuffle=4)
LATENT_SHAPE = (64, 8, 8)
# (C, H, W) of every GroupNorm shape class on the serving path
GN_CLASSES = [(64, 128, 128), (128, 128, 128), (256, 64, 64), (512, 32, 32),
              (512, 16, 16), (512, 8, 8), (128, 32, 32)]
# bf16-vs-fp32 SSIM gate. With random weights the SSIM depends on the
# draw: bf16_gate_draws.py measures the spread over seeds, and
# tests/test_torch_port_reference_shape.py shows the port's bf16 error equals
# the JAX package's on the same weights. 0.98 is below that spread and far
# above what a wrong kernel or layout gives; phase 5 also holds the card's
# SSIM to the CPU path's on the same sequences.
SSIM_GATE = 0.98
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, fp32 outside tensor cores
KERNEL_SOURCE = "weatherforecastingtoolkit_tpu_torch/csrc/groupnorm_silu.cu"
REPLACES = "weatherforecastingtoolkit_tpu/ops/pallas/groupnorm.py:28"


def log(msg=""):
    print(msg, flush=True)


def within_tolerance(got, want):
    """fp32: atol 1e-4 (another reduction order). bf16: one bf16 ulp of the
    larger of the two results on top of that 1e-4, since two fp32 results
    1e-4 apart may round to bf16 values one ulp further apart; near zero,
    where (x - mean) cancels, the 1e-4 is what is left."""
    import torch

    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-4).all()), float(err.max())
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return bool((err <= ulp + 1e-4).all()), float(err.max())


def gn_inputs(shape, dtype, channels_last, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device="cuda") * 3.0 + 1.0).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    s = torch.rand(c, generator=g, device="cuda") + 0.5
    b = torch.randn(c, generator=g, device="cuda")
    return x, s, b


def event_ms(fn, reps):
    """Device time of one call, from CUDA events around `reps` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_times(fn, n):
    """Host-clock seconds of n calls, each bracketed by synchronize()."""
    import torch

    times, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, out


def codec(vae, dtype):
    """Pipeline-factory arguments for a VAE serving in `dtype` (bf16 or
    fp32 params and activations) with the latent path and DLinear in fp32,
    as bench.py builds the JAX pipeline."""

    def encode_apply(f):
        return vae.encode(f.to(dtype)).mode().float()

    def decode_apply(z):
        return vae.decode(z.to(dtype)).float()

    return dict(encode_apply=encode_apply, decode_apply=decode_apply,
                forecaster_apply=lambda m, z: m(z),
                input_frames=T_IN, pred_frames=T_OUT)


def frame_ssim(a, b):
    from weatherforecastingtoolkit_tpu_torch.ops.ssim import ssim

    return float(ssim(a.reshape(-1, 1, HW, HW), b.reshape(-1, 1, HW, HW)))


def check_frames(out, shape):
    import torch

    if tuple(out.shape) != shape:
        raise AssertionError(f"output shape {tuple(out.shape)} != {shape}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite output")


def main():
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    import weatherforecastingtoolkit_tpu_torch as port
    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline, make_streaming_forecaster)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        GroupNormSiLU)
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm

    if not os.path.abspath(port.__file__).startswith(REPO + os.sep):
        raise RuntimeError(f"imported the port from {port.__file__}, "
                           f"not from {REPO}")

    # ---------------------------------------------------------- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # fp32 runs in full fp32: cuDNN would run fp32 convs in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    groupnorm.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {groupnorm.build_seconds:.2f} s)")
    for line in groupnorm.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # -------------------------------------- 2. kernel against plain version
    log("phase 2: kernel vs plain (fp32 atol 1e-4; bf16 1 ulp + 1e-4)")
    for ci, (c, h, w) in enumerate(GN_CLASSES):
        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
        cases = 0
        for n in (4, 1):
            for dtype in errs:
                for cl in (False, True):
                    for silu, eps in ((True, 1e-6), (False, 1e-6),
                                      (True, 1e-5), (False, 1e-5)):
                        x, s, b = gn_inputs((n, c, h, w), dtype, cl,
                                            seed=ci * 97 + n)
                        got = groupnorm.group_norm_silu_cuda(
                            x, s, b, 32, eps, silu)
                        want = groupnorm.group_norm_silu_reference(
                            x, s, b, 32, eps, silu)
                        torch.cuda.synchronize()
                        ok, err = within_tolerance(got, want)
                        if not ok:
                            raise AssertionError(
                                f"kernel != plain at N={n} C={c} {h}x{w} "
                                f"{dtype} cl={cl} silu={silu} eps={eps}: "
                                f"max err {err}")
                        errs[dtype] = max(errs[dtype], err)
                        cases += 1
        log(f"  C={c} {h}x{w}: {cases} cases ok, max abs err fp32 "
            f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}")

    # --------------------------------------------------- 3. the main path
    events = synthetic_vil_events(BATCH, HW, HW, T_IN, seed=0)
    frames = torch.from_numpy(np.ascontiguousarray(
        np.transpose(events, (0, 3, 1, 2))[:, :, None])).cuda()  # uint8
    vae32 = AutoencoderKL(**REFERENCE_VAE, seed=0)
    vae16 = copy.deepcopy(vae32).to(torch.bfloat16)
    dlinear = DLinear(T_IN, T_OUT, kernel_size=25)

    def record_gn_calls(vae, fn):
        """GroupNorm call shapes of one fn() call (a warm-up), counted."""
        calls = collections.Counter()

        def hook(mod, args):
            x = args[0]
            cl = (not x.is_contiguous()
                  and x.is_contiguous(memory_format=torch.channels_last))
            calls[(tuple(x.shape), x.dtype, cl, mod.num_groups, mod.eps,
                   mod.silu)] += 1

        handles = [m.register_forward_pre_hook(hook) for m in vae.modules()
                   if isinstance(m, GroupNormSiLU)]
        fn()
        for hd in handles:
            hd.remove()
        return calls

    def run_counted(name, fn, n, per_call, batch):
        """n timed calls with the launch count set to 0 just before and read
        just after; returns the last output."""
        groupnorm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, out = wall_times(fn, n)
        launches = groupnorm.launches
        med = statistics.median(times)
        log(f"{name}: median {med * 1e3:.2f} ms over {n} calls "
            f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{batch * T_OUT / med:.1f} frames/s, GN launches {launches} "
            f"({launches / n:g}/call), peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if launches != per_call * n:
            raise AssertionError(f"{name}: {launches} GN kernel launches, "
                                 f"expected {per_call} x {n}")
        return out

    log(f"phase 3: reference-shape rollout, B={BATCH}, {T_IN}->{T_OUT} "
        f"frames of {HW}x{HW}")
    pipe32 = make_forecast_pipeline(**codec(vae32, torch.float32))
    pipe16 = make_forecast_pipeline(**codec(vae16, torch.bfloat16))
    t0 = time.perf_counter()
    check_frames(pipe32(dlinear, frames), (BATCH, T_OUT, 1, HW, HW))
    log(f"fp32 first call {time.perf_counter() - t0:.2f} s")
    out32 = run_counted("fp32 rollout", lambda: pipe32(dlinear, frames),
                        5, 42, BATCH)
    t0 = time.perf_counter()
    gn_calls = record_gn_calls(vae16, lambda: pipe16(dlinear, frames))
    log(f"bf16 first call {time.perf_counter() - t0:.2f} s")
    out16 = run_counted("bf16 rollout", lambda: pipe16(dlinear, frames),
                        10, 42, BATCH)
    main_launches = groupnorm.launches
    check_frames(out32, (BATCH, T_OUT, 1, HW, HW))
    check_frames(out16, (BATCH, T_OUT, 1, HW, HW))
    s16 = frame_ssim(out32, out16)
    s16_first = frame_ssim(out32[:2], out16[:2])
    log(f"bf16 vs fp32 SSIM {s16:.5f} (gate > {SSIM_GATE}); sequences 0-1: "
        f"{s16_first:.5f}")
    if not s16 > SSIM_GATE:
        raise AssertionError(f"bf16 vs fp32 SSIM {s16} <= {SSIM_GATE}")
    if sum(gn_calls.values()) != 42:
        raise AssertionError(f"{sum(gn_calls.values())} GroupNorm calls, not 42")

    # ------------------------------------------------- 4. the other variants
    log("phase 4: variants (bf16)")
    ar16 = make_forecast_pipeline(autoregressive=True,
                                  **codec(vae16, torch.bfloat16))
    check_frames(ar16(dlinear, frames), (BATCH, T_OUT, 1, HW, HW))
    out_ar = run_counted("autoregressive rollout",
                         lambda: ar16(dlinear, frames), 5, 42, BATCH)
    check_frames(out_ar, (BATCH, T_OUT, 1, HW, HW))
    log(f"autoregressive vs one-shot SSIM {frame_ssim(out16, out_ar):.5f}")
    del out_ar

    # streaming tick, B=1: init once, then one frame per step
    init, step = make_streaming_forecaster(latent_shape=LATENT_SHAPE,
                                           **codec(vae16, torch.bfloat16))
    seq = frames[:1]
    n_steps = T_IN - 1
    ticks = torch.cat([seq, seq.flip(1)], dim=1)          # 26 frames
    groupnorm.launches = 0
    state = init(ticks[:, :T_IN])
    torch.cuda.synchronize()
    if groupnorm.launches != 16:
        raise AssertionError(f"streaming init: {groupnorm.launches} launches")
    step(dlinear, state, ticks[:, T_IN])                   # warm-up tick
    state = init(ticks[:, :T_IN])
    groupnorm.launches = 0
    step_times = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, fcast = step(dlinear, state, ticks[:, T_IN + i])
        torch.cuda.synchronize()
        step_times.append(time.perf_counter() - t0)
    launches = groupnorm.launches
    med = statistics.median(step_times)
    log(f"streaming tick B=1: median {med * 1e3:.2f} ms over {n_steps} steps "
        f"(min {min(step_times) * 1e3:.2f}, max {max(step_times) * 1e3:.2f}),"
        f" GN launches {launches} ({launches / n_steps:g}/step; init 16)")
    if launches != 42 * n_steps:
        raise AssertionError(f"streaming: {launches} launches")
    check_frames(fcast, (1, T_OUT, 1, HW, HW))
    window = ticks[:, n_steps:n_steps + T_IN]
    s_tick = frame_ssim(fcast, pipe16(dlinear, window))
    log(f"streaming tick vs batch pipeline on its window: SSIM {s_tick:.5f}")
    if not s_tick > 0.99:
        raise AssertionError(f"streaming tick vs batch SSIM {s_tick}")

    del out32, out16, pipe32, ar16
    torch.cuda.empty_cache()

    # fast serving VAE, B=256
    fast_events = synthetic_vil_events(FAST_BATCH, HW, HW, T_IN, seed=0)
    fast_frames = torch.from_numpy(np.ascontiguousarray(
        np.transpose(fast_events, (0, 3, 1, 2))[:, :, None])).cuda()
    fvae32 = AutoencoderKL(**FAST_VAE, seed=0)
    fvae16 = copy.deepcopy(fvae32).to(torch.bfloat16)
    fast16 = make_forecast_pipeline(**codec(fvae16, torch.bfloat16))
    fast_gn_calls = record_gn_calls(fvae16,
                                    lambda: fast16(dlinear, fast_frames))
    out_f16 = run_counted(f"fast-VAE rollout B={FAST_BATCH}",
                          lambda: fast16(dlinear, fast_frames), 10, 30,
                          FAST_BATCH)
    check_frames(out_f16, (FAST_BATCH, T_OUT, 1, HW, HW))
    fast32 = make_forecast_pipeline(**codec(fvae32, torch.float32))
    out_f32 = fast32(dlinear, fast_frames)
    s_fast = frame_ssim(out_f32, out_f16)
    log(f"fast-VAE bf16 vs its own fp32 SSIM {s_fast:.5f} "
        f"(gate > {SSIM_GATE})")
    if not s_fast > SSIM_GATE:
        raise AssertionError(f"fast-VAE bf16 vs fp32 SSIM {s_fast}")
    del out_f16, out_f32, fast16, fast32, fvae32, fvae16, fast_frames
    torch.cuda.empty_cache()

    # -------------------- 5. card against CPU, and the kernel's own times
    vae_cpu = AutoencoderKL(**REFERENCE_VAE, seed=0, device="cpu")
    dl_cpu = DLinear(T_IN, T_OUT, kernel_size=25, device="cpu")
    cpu32 = make_forecast_pipeline(device="cpu", **codec(
        vae_cpu, torch.float32))(dl_cpu, frames[:2].cpu())
    cpu16 = make_forecast_pipeline(device="cpu", **codec(
        copy.deepcopy(vae_cpu).to(torch.bfloat16), torch.bfloat16))(
        dl_cpu, frames[:2].cpu())
    pipe32 = make_forecast_pipeline(**codec(vae32, torch.float32))
    err = float((pipe32(dlinear, frames[:2]).cpu() - cpu32).abs().max())
    s_cpu = frame_ssim(cpu32, cpu16)
    log(f"sequences 0-1 on the CPU (plain GroupNorm): fp32 card vs CPU max "
        f"abs err {err:.3g} (atol 2e-3); bf16 vs fp32 SSIM {s_cpu:.5f}, "
        f"card {s16_first:.5f} (within 0.005)")
    if not err <= 2e-3:
        raise AssertionError(f"card vs CPU max abs err {err}")
    if not abs(s_cpu - s16_first) <= 0.005:
        raise AssertionError(f"bf16 SSIM card {s16_first} vs CPU {s_cpu}")
    del vae32, vae16, pipe32, pipe16, init, step
    torch.cuda.empty_cache()

    def time_gn_calls(calls, title):
        log(f"{title}: per GroupNorm call shape, device ms "
            f"(kernel / plain / F.group_norm+F.silu / bound)")
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0)
        err = 0.0
        for i, ((shape, dtype, cl, groups, eps, silu), count) in enumerate(
                sorted(calls.items(), key=lambda kv: -np.prod(kv[0][0]))):
            x, s, b = gn_inputs(shape, dtype, cl, seed=1000 + i)
            got = groupnorm.group_norm_silu_cuda(x, s, b, groups, eps, silu)
            want = groupnorm.group_norm_silu_reference(x, s, b, groups, eps,
                                                       silu)
            ok, e = within_tolerance(got, want)
            if not ok:
                raise AssertionError(f"kernel != plain at {shape}: {e}")
            err = max(err, e)
            del got, want
            sx, bx = s.to(dtype), b.to(dtype)

            def library():
                y = F.group_norm(x, groups, sx, bx, eps)
                return F.silu(y) if silu else y

            ms = event_ms(lambda: groupnorm.group_norm_silu_cuda(
                x, s, b, groups, eps, silu), 20)
            plain = event_ms(lambda: groupnorm.group_norm_silu_reference(
                x, s, b, groups, eps, silu), 3)
            lib = event_ms(library, 20)
            nbytes = 2 * x.numel() * x.element_size() + 2 * 4 * shape[1]
            ops = (10 if silu else 7) * x.numel()
            bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
            ops_ms = 1e3 * ops / FP32_OPS_PER_S
            bound = max(bytes_ms, ops_ms)
            log(f"  {count:2d} x N={shape[0]} C={shape[1]} "
                f"{shape[2]}x{shape[3]} {str(dtype)[6:]} "
                f"{'channels_last' if cl else 'NCHW'} eps={eps:g} "
                f"silu={silu}: {ms:.4f} / {plain:.4f} / {lib:.4f} / "
                f"{bound:.4f} ({bound / ms:.0%} of bound)")
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", bound), ("bytes_ms", bytes_ms),
                         ("ops_ms", ops_ms)):
                tot[k] += count * v
            del x
            torch.cuda.empty_cache()
        log(f"  per pipeline call ({sum(calls.values())} GroupNorms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()))
        return tot, err

    fast_tot, _ = time_gn_calls(fast_gn_calls,
                                f"fast-VAE bf16 B={FAST_BATCH}")
    tot, err = time_gn_calls(gn_calls, f"reference-shape bf16 B={BATCH}")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "group_norm_silu", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches,
        "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": tot["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
