#!/usr/bin/env python
"""Drive the PyTorch/CUDA port (weatherforecastingtoolkit_tpu_torch) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. the card (nvidia-smi's name and power limit line, printed again before
     the {"kernels": ...} line), torch/CUDA versions, and the nvcc builds of
     the three kernel sources from csrc/ (in parallel, timed; ptxas's
     registers, spills and shared memory), and the count of GMMA (wgmma)
     instructions in the int8 conv library's SASS, which must be above 0;
  2. the GroupNorm kernel against its plain PyTorch version at every
     GroupNorm shape class of the serving paths, small N and N=1, NCHW and
     channels_last, fp32 and bf16, fp32 and bf16 scale/bias, SiLU on/off,
     eps 1e-6/1e-5, and at the edges of its plan (C=128/256 at 128x128,
     N=1 and 3, a ragged 130x97, C not a multiple of the 16-byte vector);
     the same bits on two runs everywhere;
  3. the main path at full width: the reference-shape VAE
     (64,128,256,512,512) + DLinear(13->12) at batch 64 on synthetic VIL
     frames, fp32 and bf16; median time, frames/s, bf16-vs-fp32 SSIM
     (> SSIM_GATE), and exactly 42 kernel launches per call;
  4. the other variants in bf16: the fast VAE (pixel_unshuffle=4) at batch
     256, the autoregressive rollout at batch 64, the streaming tick at
     batch 1 (init once, then steps), each with its launch count;
  5. the serving path on two sequences, card against CPU (fp32 outputs,
     bf16-vs-fp32 SSIM); the kernel's time (in a CUDA graph, and with the
     wrapper's host time), plain time, library time and bound at every
     GroupNorm call shape of one bf16 pipeline call; then, in a fresh
     process (chip_smoke.py --profile, since torch.profiler sessions came
     back empty late in this one), one GroupNormSiLU forward (fp32/bf16 x
     and parameters) and one stencil call = one operation on the card (by
     the profiler), and the serving profile
     of a reference-shape, a fast-VAE and an int8_static reference-shape
     bf16 call (kernels per call, device-busy share, top five kernels);
  6. the advection-diffusion stencil kernel against its plain version
     (loss rel 1e-5 at the training shapes B=2 and B=32, odd sizes, C > 1,
     T = 2, 3x3 frames and a non-contiguous view; the same bits on two runs,
     on two replays of a CUDA graph, and on graphs replayed on several
     streams at once beside eager calls;
     gradients for x, u, v and kappa equal to the plain version's autograd);
  7. Earthformer training with the physics prior at the full width of
     experiments/earthformer/config.yaml through Trainer.fit on synthetic
     VIL batches: 20 steps at the config's batch of 2 (finite losses, the
     prior logged, one stencil launch per step), card against CPU on the
     first 3 batches (TF32 off, losses rel 1e-4), resume (4 steps, a new
     Trainer(resume=True), 2 more) equal to 6 straight steps (1e-6, cuDNN
     deterministic), and step time, samples/s and peak memory at B=2 and
     B=32 beside the stencil kernel's time, plain time and bound;
  8. latent_forecast_task (Path-B training) on the reference-shape frozen
     VAE + DLinear at B=8: 3 steps with finite losses and the encoder's
     GroupNorm launches, forward only, on every step; then one
     Trainer.validate (decoded pixels, calc_metrics keys, no panels);
  9. the int8 conv and quantize kernels against their plain versions (a
     float64 conv of the same codes; the same bits, twice) at every int8
     conv call shape of the two int8 serving calls (at N=4, and at the
     serving N while timing) and at the edges (N=1, Cin=1, Cout=1, 13x17,
     stride 2 with (0, 1) padding, Cin not a multiple of 16, K not a
     multiple of 128 bytes, Cout not a multiple of the tile, an M tail of
     one row), fp32 and bf16 out, with and without bias; CUDA graphs of the
     conv (both designs) replayed on three streams beside eager calls, the
     eager calls' bits; per call shape the kernel's time in a CUDA graph,
     its plain time, its bound and, as context only, the bf16 cuDNN conv of
     that shape;
 10. quantized serving at full width: the reference VAE calibrated in fp32
     on the B=64 serving batch (bench.py's recipe), the int8_static bf16
     reference call at B=64 (median ms, frames/s, SSIM vs fp32, exactly
     56 int8 convs + 56 quantize passes + 42 GroupNorms a call) and the fast
     VAE under INT8_MIXED_SPEC in bf16 at B=256 (4 + 4 + 30 a call, SSIM vs
     its own fp32); card against CPU on two sequences with the CPU's
     calibration carried across: every int8 conv of the call gives the
     CPU plain version's bits on the card's own input, and both int8 SSIMs
     lie within 5e-3 of the CPU's;
 11. the ensemble rollout (reference VAE, B=8, 8 members): sigma=0 members
     equal, bit for bit in fp32 and bf16, to the deterministic pipeline
     on the batch tiled 8 times with the sequences encoded once; against
     the deterministic call at B=8, SSIM >= 0.999 in fp32 (in bf16
     printed, beside the deterministic call's own reading on the tiled
     batch: the bf16 VAE is not batch-invariant to the last bit), sigma >
     0 spread and time in bf16;
     calibrate_noise_std over {0, 0.05, 0.1} on two batches, and
     evaluate_protocol (with the VAE ceiling) on two B=16 batches of 25
     frames, both tables printed; card against CPU on one B=2 batch in fp32
     (continuous keys rel 1e-4, CSI/HSS abs 1e-3);
 12. in a fresh process (chip_smoke.py --train, run after phase 8), GAN
     training at bench.py::bench_train's shapes: PosAwareAE(latent_dim=
     2048) + NLayerDiscriminator(1, 64, 3) through make_vae_gan_task, fp32
     (TF32 off) at B x T = 4 x 4 and bf16 mixed precision at 4, 8 and 16 x
     4: median ms/step over 10 steps after 2 warm-up steps, steps/s,
     frames/s, peak memory, the device's busy share (torch.profiler),
     losses finite on every step; the first fp32 step's rec_loss, g_loss
     and disc_loss (rel 1e-4), d_weight and grad_norm (rel 1e-2) against
     the CPU's at full width, both beside the card's float64 step; a
     resumed Trainer.fit equal to a straight one at small width;
 13. in the same process, the fast VAE's GAN step
     (experiments_gpu/perf/fast_vae_train.py::build_step(FAST_SHAPE), bf16,
     16 x 4; bench.py::bench_fast_vae_train), with remat off and on: ms/step,
     steps/s, peak memory, GN kernel launches a step (one a forward
     GroupNormSiLU call, and again for each recomputed block), the GN
     kernel's time, bound and F.group_norm+F.silu's at the step's call
     shapes, the GN backward's device time (the plain version's autograd)
     and its share of the step, and the kernel's gradient at one training
     shape against the plain version's autograd;
 14. in a fresh process (chip_smoke.py --zoo, run after phase 13),
     AlphaPre + the physics prior at experiments/alphapre/config.yaml's
     widths (dim 32, 3 AmpCells, spec_num 20, 13->12 frames of 128^2, B=2,
     prior switched on): before training the card against the CPU on the
     same weights and batch, fp32, each beside a float64 forward on the
     card (xt, xps, xas and the input amplitudes atol 1e-2, the four losses
     rel 1e-4; ALPHAPRE_ATOL says why); the input phase at the real bins
     and on an all-zero frame equal to the CPU's; the port's irfft2 of
     spectra that are not Hermitian within 1e-5 of numpy's definition
     (torch.fft.irfft2's distance printed);
     10 Trainer.fit steps (finite losses, the prior logged, one stencil
     launch a step), step time, busy share, kernels a step, peak memory;
     the stencil at the step's shape against its plain version (rel 1e-5)
     and timed;
 15. CustomAutoencoderKL at its default width (64x8x8 latent, timeseries
     2048), card vs CPU at B=2 (fp32), the forward (posterior mode) at
     B=64 in fp32 and bf16: ms, frames/s, peak memory, 42 GN launches a
     forward, one kernel a call at every call shape (CUDA-graph nodes), the
     kernel against its plain version and timed per call shape (graph,
     plain, F.group_norm+F.silu, bound);
 16. token_vit at experiments/token_vit/config.yaml's widths (frozen
     random ViTAE, TokenSequenceForecaster), 3 Trainer.fit steps at B=2,
     one eval_fn call, step time;
 17. one reconstruction_task step (experiments_gpu/ae_recon) for each of
     vit_ae, structured_conv_ae, conv_autoencoder and attention_charged_ae
     at the registry's default widths (2 x 2 frames, 2 steps each);
 and, after phase 9, the int8 modes' gradients on the card against the
 CPU's (rel 1e-5).
The kernels build in parallel (one nvcc per source). fp32 runs with TF32
off throughout. The line before the last is {"kernels": [...]}; the last line
is {"ok": true, "device": {...}}. Without a GPU it exits 2 and prints no
result.
"""

import collections
import concurrent.futures
import copy
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# (C, H, W) of every GroupNorm shape class on the serving paths (the fast
# VAE's (128,32,32), (256,16,16) and (512,8,8) among them)
GN_CLASSES = [(64, 128, 128), (128, 128, 128), (256, 64, 64), (512, 32, 32),
              (512, 16, 16), (512, 8, 8), (128, 32, 32), (256, 16, 16)]
# cases at the edges of the kernel's plan, (N, C, H, W, groups): wider
# channels at 128x128 (one slab over 16 blocks), a ragged frame, and C not a
# multiple of the 16-byte vector (the two-pass path)
GN_EDGE_CASES = [(n, c, 128, 128, 32) for c in (128, 256) for n in (1, 3)] + [
    (2, 64, 130, 97, 32), (3, 18, 5, 7, 6), (2, 40, 9, 9, 8)]
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
STENCIL_SOURCE = "weatherforecastingtoolkit_tpu_torch/csrc/advection_stencil.cu"
STENCIL_REPLACES = "weatherforecastingtoolkit_tpu/ops/pallas/stencil.py:62"
# The int8 kernels replace XLA ops of int8_conv_static, not TPU kernels
INT8_SOURCE = "weatherforecastingtoolkit_tpu_torch/csrc/int8_conv.cu"
INT8_CONV_REPLACES = "weatherforecastingtoolkit_tpu/ops/quant.py:161"
QUANTIZE_REPLACES = "weatherforecastingtoolkit_tpu/ops/quant.py:151"
INT8_OPS_PER_S = 1979e12       # H100 SXM data sheet, dense int8
# bench.py:52, the JAX bench's fast-VAE mixed spec
INT8_MIXED_SPEC = (("encoder/mid_block*", "int8_static"), ("*", "native"))
# (N, H, W, Cin, Cout, k, stride, (top, bottom, left, right)): N=1, Cin=1,
# Cout=1, an odd 13x17 frame, stride 2 with the VAE's (0, 1) padding, Cin
# not a multiple of 16, the widest conv; K not a multiple of 128 bytes
# (48 channels x 9 taps, the gather), Cout not a multiple of the tile (200
# over two 128-wide tiles, im2col in 64-byte stages), an M tail of one row
# (3x43 = 129 output pixels)
INT8_EDGE_CASES = [(1, 13, 17, 1, 64, 3, 1, (1, 1, 1, 1)),
                   (4, 13, 17, 64, 1, 3, 1, (1, 1, 1, 1)),
                   (4, 13, 17, 64, 128, 3, 2, (0, 1, 0, 1)),
                   (3, 9, 7, 48, 24, 1, 1, (0, 0, 0, 0)),
                   (1, 16, 16, 512, 512, 3, 1, (1, 1, 1, 1)),
                   (2, 9, 11, 48, 40, 3, 1, (1, 1, 1, 1)),
                   (2, 9, 11, 192, 200, 3, 1, (1, 1, 1, 1)),
                   (1, 3, 43, 64, 64, 3, 1, (1, 1, 1, 1)),
                   (1, 3, 43, 16, 64, 3, 1, (1, 1, 1, 1))]
ENSEMBLE_BATCH, ENSEMBLE_MEMBERS, EVAL_BATCH = 8, 8, 16
NOISE_STDS = (0.0, 0.05, 0.1)
EF_CONFIG = os.path.join(REPO, "experiments", "earthformer", "config.yaml")
EF_STEPS, EF_SEQ = 20, 25          # training steps at the config's batch
TIMED_BATCHES = (2, 32)
LATENT_BATCH = 8
# bench.py::bench_train (bench.py:454-546): PosAwareAE(latent_dim=2048) +
# NLayerDiscriminator(1, 64, 3) on B x T frames of 128^2; (bf16, B) runs
GAN_AE = dict(latent_dim=2048)
GAN_PARAMS = (80_750_017, 2_755_905)     # the JAX modules' counts
GAN_T, GAN_STEPS = 4, 10
ALPHAPRE_CONFIG = os.path.join(REPO, "experiments", "alphapre", "config.yaml")
TOKEN_VIT_CONFIG = os.path.join(REPO, "experiments", "token_vit",
                                "config.yaml")
AE_RECON_CONFIG = os.path.join(REPO, "experiments", "ae_recon", "config.yaml")
ALPHAPRE_STEPS = 10
# AlphaPre card vs CPU, max abs error of each forward output checked: the
# frames (xt, xps, xas, about [0, 1]) 1e-2, the input amplitudes (up to
# about 8e3 at DC) 1e-2. fp32 itself puts xt 1.7e-3 (CPU) and 3.7e-3 (card)
# from a float64 forward on the card: the phase of a bin whose value is
# rounding noise is arbitrary (the predicted phase pha_t differs by up to
# 8.45 rad between fp32 and float64 on both devices, so it is printed, not
# checked), and the mixer weights that phase by the amplitudes of AmpliNet's
# frames. The four losses: rel 1e-4.
ALPHAPRE_OUTPUTS = ("xt", "xps", "xas", "pha_t", "amps")
ALPHAPRE_ATOL = {"xt": 1e-2, "xps": 1e-2, "xas": 1e-2, "amps": 1e-2}
CAKL_BATCH = 64
CAKL_GN_CALLS = 42    # as the reference-shape VAE: the same block counts
ZOO_RECON = ("vit_ae", "structured_conv_ae", "conv_autoencoder",
             "attention_charged_ae")
GAN_RUNS = ((False, 4), (True, 4), (True, 8), (True, 16))
# card vs CPU on the first fp32 step, relative: the losses to 1e-4; the
# scalars made from gradients (the adaptive weight, the gradient norm) to
# 1e-2, since fp32 itself puts them about 2e-3 from a float64 evaluation of
# the same step (phase 12 prints the card's float64 step beside both)
GAN_CPU_RTOL = {"rec_loss": 1e-4, "g_loss": 1e-4, "disc_loss": 1e-4,
                "d_weight": 1e-2, "grad_norm": 1e-2}
# the resume check's width: tests/test_gan.py's PosAwareAE on 32^2 frames
GAN_SMALL_AE = dict(enc_channels=(8, 16), dec_channels=(16, 8, 8),
                    num_blocks=1, latent_hw=8, latent_channels=4,
                    latent_dim=32)
FAST_TRAIN_BATCH = 16   # bench.py::bench_fast_vae_train: B x T = 16 x 4
# (B, T, C, H, W) stencil classes: the training shapes, odd sizes with C > 1
# and T = 2, and 3x3 frames (one interior element)
STENCIL_CLASSES = [(2, 12, 1, 128, 128), (32, 12, 1, 128, 128),
                   (3, 2, 4, 130, 97), (1, 5, 2, 3, 3)]


def log(msg=""):
    print(msg, flush=True)


def sass_count(library, opcode):
    """Lines of cuobjdump -sass of `library` that hold `opcode`."""
    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                           "-sass", library], capture_output=True, text=True,
                          check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


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


def graph_ms(fn, reps):
    """Device time of one call without the host's launch overhead: `reps`
    calls captured in one CUDA graph, replayed between CUDA events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def record_gn_calls(vae, fn):
    """GroupNorm calls of one fn() call (a warm-up) through vae, counted by
    (shape, dtype, channels_last, groups, eps, silu)."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        GroupNormSiLU)

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


def gn_bound(x, scale, silu):
    """Least time for one GroupNorm call: read x and the parameters once,
    write y once, against its fp32 operations. Returns (ms, bytes ms,
    operations ms)."""
    nbytes = (2 * x.numel() * x.element_size()
              + 2 * scale.element_size() * x.shape[1])
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * (10 if silu else 7) * x.numel() / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def time_gn_calls(calls, title):
    """The GroupNorm kernel at each call shape of `calls` (from
    ``record_gn_calls``; parameters in x's dtype): its bits against the plain
    version, its device time in a CUDA graph and with the wrapper's host
    time (events), the plain version's and F.group_norm+F.silu's, and the
    bound; returns the totals weighted by the counts and the largest
    error."""
    import torch
    import torch.nn.functional as F

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm

    log(f"{title}: per GroupNorm call shape (parameters in x's dtype, as "
        f"the VAE holds them), device ms: kernel in a CUDA graph / kernel "
        f"with the wrapper (events) / plain / F.group_norm+F.silu / bound")
    tot = dict(ms=0.0, event_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    err = 0.0
    for i, ((shape, dtype, cl, groups, eps, silu), count) in enumerate(
            sorted(calls.items(), key=lambda kv: -np.prod(kv[0][0]))):
        x, s, b = gn_inputs(shape, dtype, cl, seed=1000 + i)
        s, b = s.to(dtype), b.to(dtype)

        def kernel():
            return groupnorm.group_norm_silu_cuda(x, s, b, groups, eps,
                                                  silu)

        got, again = kernel(), kernel()
        want = groupnorm.group_norm_silu_reference(x, s, b, groups, eps,
                                                   silu)
        ok, e = within_tolerance(got, want)
        if not ok or not torch.equal(got, again):
            raise AssertionError(f"kernel != plain at {shape}: {e}, or "
                                 f"two runs differ")
        err = max(err, e)
        del got, again, want

        def library():
            y = F.group_norm(x, groups, s, b, eps)
            return F.silu(y) if silu else y

        ms = graph_ms(kernel, 20)
        call_ms = event_ms(kernel, 20)
        plain = event_ms(lambda: groupnorm.group_norm_silu_reference(
            x, s, b, groups, eps, silu), 3)
        lib = event_ms(library, 20)
        bound, bytes_ms, ops_ms = gn_bound(x, s, silu)
        log(f"  {count:2d} x N={shape[0]} C={shape[1]} "
            f"{shape[2]}x{shape[3]} {str(dtype)[6:]} "
            f"{'channels_last' if cl else 'NCHW'} eps={eps:g} "
            f"silu={silu}: {ms:.4f} / {call_ms:.4f} / {plain:.4f} / "
            f"{lib:.4f} / {bound:.4f} ({bound / ms:.0%} of bound)")
        for k, v in (("ms", ms), ("event_ms", call_ms),
                     ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", bound), ("bytes_ms", bytes_ms),
                     ("ops_ms", ops_ms)):
            tot[k] += count * v
        del x
        torch.cuda.empty_cache()
    log(f"  summed over the calls ({sum(calls.values())} GroupNorms): "
        f"kernel {tot['ms']:.3f} ms in CUDA graphs, {tot['event_ms']:.3f} "
        f"ms with the wrapper; bound {tot['bound_ms']:.3f} ms "
        f"({tot['bound_ms'] / tot['ms']:.1%} of the graph time); "
        + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()))
    return tot, err


def profile_step(step, n):
    """torch.profiler over n steps: device kernel ms per step, the wall ms
    per step (profiler on), kernels launched per step, and the five kernels
    with the most device time. Fails when it recorded no kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler recorded no kernel on the card")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    count = sum(e.count for e in kernels) / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return busy_ms, wall_ms, count, [
        (e.key[:60], e.self_device_time_total / 1e3 / n) for e in top]


def device_ops(fn):
    """(name, count) of every operation that ran on the card during one
    fn() call after a first one (kernels, copies and fills alike), from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                         # one-time set-up (a ticket pool) outside
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


def one_kernel(name, fn):
    """Fail unless fn() runs exactly one operation on the card."""
    ops = device_ops(fn)
    if sum(count for _, count in ops) != 1:
        raise AssertionError(f"{name}: {ops} on the card, expected one kernel")
    return ops[0][0]


def log_profile(title, call):
    """Log kernels per call, the device's busy share and the top five
    kernels of two calls under torch.profiler."""
    busy, wall, count, top = profile_step(call, 2)
    log(f"{title} (torch.profiler, 2 calls): device busy {busy:.2f} ms of "
        f"{wall:.2f} ms a call ({busy / wall:.0%}, profiler on), "
        f"{count:.0f} kernels a call; top: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in top))


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


def stencil_bound(shape, elem_bytes=4):
    """Least time for the stencil: read x once against 14 fp32 flops per
    interior element and frame pair. Returns (ms, "bytes"|"operations")."""
    b, t, c, h, w = shape
    bytes_ms = 1e3 * (b * t * c * h * w * elem_bytes + 16) / HBM_BYTES_PER_S
    ops_ms = 1e3 * 14 * b * c * (t - 1) * (h - 2) * (w - 2) / FP32_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def stencil_streams_check(x, params, rounds=20):
    """CUDA graphs of one stencil call replayed on three streams at once
    while eager calls run on the capture stream of one of them. Two graphs
    are captured on torch.cuda.graph's own capture stream, one on the eager
    calls' stream; each capture has a ticket counter of its own. Every
    launch reads another of `rounds` inputs (x scaled) copied into its
    stream's buffer first, so a launch that took a ticket of another would
    sum stale partials or leave its output unwritten. Each result must have
    the bits of the eager call on its input, and every ticket counter must
    be back at zero. All the work is queued behind a long sleep kernel, so
    that the streams' launches then run at the same time. Returns the
    number of results compared."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    inputs = [x * (1.0 + 0.01 * r) for r in range(rounds)]
    want = [cs.advection_stencil_cuda(xi, params) for xi in inputs]
    cap = torch.cuda.Stream()
    streams = [torch.cuda.Stream() for _ in range(3)]
    bufs = {st: torch.empty_like(x) for st in [cap] + streams}
    for st in [cap] + streams:
        st.wait_stream(torch.cuda.current_stream())
    graphs, outs = [], []
    for capture, st in zip((cap, None, None), streams):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            outs.append(cs.advection_stencil_cuda(bufs[st], params))
        graphs.append(graph)
    torch.cuda.synchronize()
    gate = torch.cuda.Event()
    torch.cuda._sleep(100_000_000)          # tens of ms: the host queues all
    gate.record()
    for st in [cap] + streams:
        st.wait_event(gate)
    got = []
    for r in range(rounds):
        for k, (graph, out, st) in enumerate(zip(graphs, outs, streams)):
            i = (r + k + 1) % rounds
            with torch.cuda.stream(st):
                bufs[st].copy_(inputs[i])
                graph.replay()
                got.append((i, out.clone()))
        with torch.cuda.stream(cap):
            bufs[cap].copy_(inputs[r])
            got.append((r, cs.advection_stencil_cuda(bufs[cap], params)))
    torch.cuda.synchronize()
    bad = [(i, float(v), float(want[i])) for i, v in got
           if not torch.equal(v, want[i])]
    left = int(cs._counters[x.device.index].count_nonzero())
    if bad or left:
        raise AssertionError(f"stencil on concurrent streams: {len(bad)} of "
                             f"{len(got)} results differ from the eager "
                             f"calls' (input, got, want) {bad[:5]}; "
                             f"{left} ticket counters not at zero")
    return len(got)


def stencil_phase():
    """Phase 6: the kernel against its plain version. Returns the largest
    absolute error of the loss."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    def plain(x, p):
        b, t, c, h, w = x.shape
        return ps.advection_diffusion_residual_reference(
            x.transpose(1, 2).reshape(b * c, t, h, w), p[0], p[1], p[2])

    log("phase 6: stencil kernel vs plain (loss rel 1e-5, same bits twice "
        "and on graph replay, one kernel a call, gradients rel 1e-5; fp32 "
        "and bf16 x)")
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(shape, torch.rand(shape, generator=g, device="cuda"))
             for shape in STENCIL_CLASSES]
    base = torch.rand((2, 12, 3, 128, 128), generator=g, device="cuda")
    view = base[:, :, 1:2]                 # (2, 12, 1, 128, 128), strided
    if view.is_contiguous():
        raise AssertionError("the view case must not be contiguous")
    cases.append(("(2,12,1,128,128) channel-slice view", view))
    err = 0.0
    for name, x in cases:
        for coeffs in ((0.0, 0.0, 0.05), (0.3, -0.2, 0.1)):
            p = torch.tensor(coeffs, device="cuda")
            got = cs.advection_stencil_cuda(x, p)
            again = cs.advection_stencil_cuda(x, p)
            want = plain(x, p)
            e = abs(float(got) - float(want))
            if not e <= 1e-5 * abs(float(want)):
                raise AssertionError(f"stencil {name} {coeffs}: kernel "
                                     f"{float(got)} vs plain {float(want)}")
            if not torch.equal(got, again):
                raise AssertionError(f"stencil {name}: two runs differ")
            err = max(err, e)
        log(f"  {name}: loss {float(got):.6g}, abs err {e:.3g}, "
            f"same bits twice")
    x = cases[0][1]
    coeffs = torch.tensor([0.3, -0.2, 0.05], device="cuda")
    eager = cs.advection_stencil_cuda(x, coeffs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cs.advection_stencil_cuda(x, coeffs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = cs.advection_stencil_cuda(x, coeffs)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    if not (torch.equal(first, out) and torch.equal(out, eager)):
        raise AssertionError(f"stencil graph replays {float(first)}, "
                             f"{float(out)} vs eager {float(eager)}")
    log("  a CUDA graph of one call replayed twice gives the eager call's "
        "bits (one kernel a call: phase 5's profile process)")
    n = stencil_streams_check(x, coeffs)
    log(f"  three graphs replayed on three streams while eager calls run on "
        f"one's capture stream: {n} results, all the eager call's bits")
    for shape in ((2, 12, 1, 128, 128), (3, 2, 4, 130, 97)):
        x = torch.rand(shape, generator=g, device="cuda")
        leaves = [x.clone().requires_grad_()] + [
            torch.tensor(c, device="cuda", requires_grad=True)
            for c in (0.3, -0.2, 0.05)]
        ps.advection_diffusion_prior(*leaves).backward()
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        plain(ref[0], ref[1:]).backward()
        for name, a, b in zip(("x", "u", "v", "kappa"), leaves, ref):
            torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-9,
                                       msg=lambda m: f"grad {name} {shape}: {m}")
        log(f"  gradients x, u, v, kappa at {shape}: equal to the plain "
            f"autograd (rel 1e-5)")
    # bf16 x: bf16 differences, fp32 residual, as the JAX kernel
    for shape in ((2, 12, 1, 128, 128), (32, 12, 1, 128, 128),
                  (3, 2, 4, 130, 97)):
        x = (torch.rand(shape, generator=g, device="cuda") * 4 - 2).to(
            torch.bfloat16)
        p = torch.tensor((0.3, -0.2, 0.05), device="cuda")
        got = cs.advection_stencil_cuda(x, p)
        want = plain(x, p)
        e = abs(float(got) - float(want))
        if not (e <= 1e-5 * abs(float(want))
                and torch.equal(got, cs.advection_stencil_cuda(x, p))):
            raise AssertionError(f"stencil bf16 {shape}: kernel {float(got)} "
                                 f"vs plain {float(want)}, or two runs differ")
        msg = f"  bf16 {shape}: loss {float(got):.6g}, rel err {e / float(want):.3g}"
        if shape[0] != 3:
            ms = graph_ms(lambda: cs.advection_stencil_cuda(x, p), 100)
            bound, _ = stencil_bound(shape, 2)
            msg += (f"; kernel {ms * 1e3:.2f} us (CUDA graph), plain "
                    f"{graph_ms(lambda: plain(x, p), 20) * 1e3:.2f} us, bound "
                    f"{bound * 1e3:.3f} us ({bound / ms:.1%})")
        log(msg + "; same bits twice")
    return err


def vil_batches(n, batch, seed):
    """n uint8 VIL batches {"vil": (batch, 25, 1, 128, 128)} (host numpy)."""
    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)

    ev = synthetic_vil_events(n * batch, HW, HW, EF_SEQ, seed=seed)
    vil = np.ascontiguousarray(np.transpose(ev, (0, 3, 1, 2))[:, :, None])
    return [{"vil": vil[batch * i:batch * (i + 1)]} for i in range(n)]


def earthformer_phase(tmp):
    """Phase 7: Earthformer + physics prior through Trainer.fit at the
    config's full width. Returns the stencil's launches on the 20-step run,
    its timing at the config batch and the largest kernel-vs-plain error
    at the timed shapes."""
    import torch

    from experiments_gpu.earthformer.train import build_task
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import to_device
    from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        read_jsonl_metrics)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        Trainer, derive_steps)
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    base = Config.load(EF_CONFIG)
    m = base.model

    def config(name, n_batches, batch):
        cfg = base.merge({"experiment_path": os.path.join(tmp, name),
                          "dataset": {"batch_size": batch},
                          "trainer": {"max_epochs": 1},
                          "logging": {"log_every_n_steps": 1}})
        return derive_steps(cfg, n_batches, 0)

    def train(name, batches, n_total, device=None, resume=False):
        cfg = config(name, n_total, len(batches[0]["vil"]))
        tr = Trainer(cfg, build_task(cfg), device=device, resume=resume)
        state = tr.fit(batches, state=tr.init_state())
        tr.close()
        return state, [r for r in read_jsonl_metrics(tr.run_dir)
                       if "train_loss" in r]

    batch = base.dataset.batch_size
    log(f"phase 7: Earthformer (dim {m.dim}, depth {m.depth}, heads "
        f"{m.num_heads}, patch {m.patch}, window {list(m.window)}, "
        f"{m.t_in}->{m.t_out} frames of {HW}x{HW}) + prior (weight "
        f"{base.physics_prior.weight}, kappa {base.physics_prior.kappa}) "
        f"through Trainer.fit, fp32, TF32 off")
    batches = vil_batches(EF_STEPS, batch, seed=7)
    cs.launches = 0
    groupnorm.launches = 0
    t0 = time.perf_counter()
    state, recs = train("fit", batches, EF_STEPS)
    torch.cuda.synchronize()
    launches, gn = cs.launches, groupnorm.launches
    n_params = sum(p.numel() for p in state.params.parameters())
    losses = [r["train_loss"] for r in recs]
    log(f"  {EF_STEPS} steps at B={batch} in {time.perf_counter() - t0:.2f} s "
        f"({n_params} params): loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
        f"prior {recs[-1].get('train_physics_prior', float('nan')):.4g}; "
        f"stencil launches {launches} ({launches / EF_STEPS:g}/step), "
        f"GroupNorm {gn}")
    if len(recs) != EF_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"losses: {losses}")
    if not all("train_physics_prior" in r for r in recs):
        raise AssertionError("physics_prior missing from the logged aux")
    if launches != EF_STEPS or gn != 0:
        raise AssertionError(f"stencil launches {launches} (expected one per "
                             f"step, forward only), GroupNorm {gn}")
    del state

    # card against CPU on the same weights (one seed) and the first 3 batches
    _, card = train("vs_cpu_card", batches[:3], 3)
    _, cpu = train("vs_cpu_cpu", batches[:3], 3, device="cpu")
    rel = max(abs(a["train_loss"] - b["train_loss"]) / abs(b["train_loss"])
              for a, b in zip(card, cpu))
    log(f"  card vs CPU, 3 steps: losses {[r['train_loss'] for r in card]} vs "
        f"{[r['train_loss'] for r in cpu]}, max rel diff {rel:.3g} (rel 1e-4)")
    if len(card) != 3 or len(cpu) != 3 or not rel <= 1e-4:
        raise AssertionError(f"card vs CPU losses differ by {rel}")

    # resume: 4 steps, a new Trainer(resume=True), 2 more == 6 straight
    torch.backends.cudnn.deterministic = True
    straight, _ = train("straight", batches[:6], 6)
    train("resumed", batches[:4], 6)
    resumed, _ = train("resumed", batches[4:6], 6, resume=True)
    torch.backends.cudnn.deterministic = False
    diff = max(float((a - b).abs().max()) for a, b in zip(
        straight.params.state_dict().values(),
        resumed.params.state_dict().values()))
    log(f"  resume at step 4 + 2 steps vs 6 straight: steps {resumed.step} "
        f"and {straight.step}, max param diff {diff:.3g} (1e-6)")
    if resumed.step != 6 or not diff <= 1e-6:
        raise AssertionError(f"resumed run differs from straight: {diff}")
    del straight, resumed

    # step time, throughput and memory; the stencil at the step's shape
    timing, err = {}, 0.0
    for b in TIMED_BATCHES:
        cfg = config(f"timed_b{b}", 13, b)
        tr = Trainer(cfg, build_task(cfg))
        state = tr.init_state()
        batch_b = to_device(vil_batches(1, b, seed=8)[0], tr.device)
        for _ in range(3):
            tr._train_step(state, batch_b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, _ = wall_times(lambda: tr._train_step(state, batch_b), 10)
        med = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, wall, count, top = profile_step(
            lambda: tr._train_step(state, batch_b), 3)
        tr.close()
        del tr, state, batch_b
        torch.cuda.empty_cache()
        shape = (b, m.t_out, m.in_channels, HW, HW)
        x = torch.rand(shape, device="cuda")
        p = torch.tensor([base.physics_prior.u, base.physics_prior.v,
                          base.physics_prior.kappa], device="cuda")
        err = max(err, abs(float(cs.advection_stencil_cuda(x, p))
                           - float(ps._frames_reference(x, *p))))
        # device time inside a CUDA graph; the wrapper's host time aside
        ms = graph_ms(lambda: cs.advection_stencil_cuda(x, p), 100)
        plain_ms = graph_ms(lambda: ps._frames_reference(x, *p), 20)
        call_ms = event_ms(lambda: cs.advection_stencil_cuda(x, p), 200)
        bound, bound_by = stencil_bound(shape)
        timing[b] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=bound_by)
        log(f"  B={b}: median step {med * 1e3:.2f} ms over 10 (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{1 / med:.2f} steps/s, {b / med:.1f} samples/s, peak mem "
            f"{peak:.2f} GiB")
        log(f"    profiler, 3 steps: device busy {busy:.2f} ms of {wall:.2f} "
            f"ms a step ({busy / wall:.0%}, profiler on), {count:.0f} kernels "
            f"a step; top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
        log(f"    stencil at {shape}: kernel {ms * 1e3:.2f} us (CUDA graph; "
            f"{call_ms * 1e3:.2f} us a call with the wrapper's host time), "
            f"plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
            f"({bound_by}, {bound / ms:.1%} of bound)")
        del x
    return launches, timing[batch], err


def latent_phase(tmp):
    """Phase 8: Path-B training (latent_forecast_task) on the frozen
    reference-shape VAE + DLinear; GroupNorm launches forward only; then
    Trainer.validate with the decoded frames' metrics."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        GroupNormSiLU)
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        read_jsonl_metrics)
    from weatherforecastingtoolkit_tpu_torch.training.tasks import (
        latent_forecast_task)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    steps = 3
    vae = AutoencoderKL(**REFERENCE_VAE, seed=0)
    per_encode = sum(isinstance(mod, GroupNormSiLU)
                     for mod in vae.encoder.modules())
    task = latent_forecast_task(lambda f, rng: vae.encode(f).mode(),
                                DLinear(T_IN, T_OUT, kernel_size=25),
                                T_IN, T_OUT, LATENT_SHAPE,
                                decode_apply=vae.decode)
    cfg = Config({"experiment_name": "latent_forecast", "seed": 0,
                  "experiment_path": os.path.join(tmp, "latent"),
                  "optim": {"schedule": "constant", "lr": 1e-3},
                  "trainer": {"total_train_steps": steps, "max_epochs": 1},
                  "logging": {"log_every_n_steps": 1}})
    batches = vil_batches(steps, LATENT_BATCH, seed=9)
    log(f"phase 8: latent_forecast_task, reference-shape frozen VAE (fp32) + "
        f"DLinear({T_IN}->{T_OUT}), B={LATENT_BATCH}, {steps} steps")
    tr = Trainer(cfg, task)
    groupnorm.launches = 0
    cs.launches = 0
    t0 = time.perf_counter()
    state = tr.fit(batches)
    torch.cuda.synchronize()
    gn, st = groupnorm.launches, cs.launches
    t1 = time.perf_counter()
    val = tr.validate(state, vil_batches(1, LATENT_BATCH, seed=10), steps,
                      log_images=False)
    log(f"  Trainer.validate, one batch of {LATENT_BATCH} (decoded), "
        f"{time.perf_counter() - t1:.2f} s: loss {val['loss']:.5f}, SSIM "
        f"{val['SSIM']:.4f}, CSI-M {val['paper_CSI_M_POOL1']:.4f}, "
        f"{len(val)} keys")
    if not ("paper_HSS_POOL16" in val and all(np.isfinite(list(val.values())))):
        raise AssertionError(f"Trainer.validate returned {sorted(val)}")
    tr.close()
    losses = [r["train_loss"] for r in read_jsonl_metrics(tr.run_dir)
              if "train_loss" in r]
    log(f"  {steps} steps in {time.perf_counter() - t0:.2f} s: losses "
        f"{losses}; GroupNorm launches {gn} ({gn / steps:g}/step, encoder "
        f"{per_encode} per call), stencil {st}")
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"latent forecast losses {losses}")
    if gn != steps * per_encode or st != 0:
        raise AssertionError(f"GroupNorm launches {gn}, expected {steps} x "
                             f"{per_encode}; stencil {st}")
    if any(p.grad is not None for p in vae.parameters()):
        raise AssertionError("the frozen VAE received gradients")
    return gn


def record_int8_calls(vae, fn):
    """int8 conv calls of one fn() call (a warm-up) through vae, counted by
    (N, H, W, Cin, Cout, k, stride, padding, dtype)."""
    from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv

    calls = collections.Counter()

    def hook(mod, args):
        if mod.resolved in ("int8", "int8_static"):
            n, c, h, w = args[0].shape
            calls[(n, h, w, c, mod.weight.shape[0], mod.weight.shape[2],
                   mod.stride[0], mod.pad, args[0].dtype)] += 1

    handles = [m.register_forward_pre_hook(hook) for m in vae.modules()
               if isinstance(m, QConv)]
    fn()
    for hd in handles:
        hd.remove()
    return calls


def int8_convs_match_cpu(card_vae, cpu_vae, fn):
    """fn() (a call through card_vae) with every int8 conv of card_vae held
    to the same conv of cpu_vae (the same weights and scales, the plain
    version) on the card's own input: the same bits or fail. Returns (the
    convs checked, fn()'s output)."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv

    cpu_convs = {m.path: m for m in cpu_vae.modules() if isinstance(m, QConv)}
    checked = []

    def hook(mod, args, out):
        with torch.no_grad():
            want = cpu_convs[mod.path](args[0].cpu())
        got = out.cpu()
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"int8 conv {mod.path}: card != CPU on the "
                                 f"card's input, max abs err {err}")
        checked.append(mod.path)

    handles = [m.register_forward_hook(hook) for m in card_vae.modules()
               if isinstance(m, QConv)
               and m.resolved in ("int8", "int8_static")]
    try:
        out = fn()
    finally:
        for hd in handles:
            hd.remove()
    return len(checked), out


def int8_codes(n, h, w, cin, cout, k, seed):
    """Random int8 codes (N, H, W, Cp), weight codes (Cout, k, k, Cp), zero
    past Cin, and an fp32 scale and bias, on the card."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    g = torch.Generator(device="cuda").manual_seed(seed)
    cp = ic.padded_channels(cin)
    xq = torch.randint(-127, 128, (n, h, w, cp), generator=g, device="cuda",
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, k, k, cp), generator=g,
                       device="cuda", dtype=torch.int8)
    xq[..., cin:] = 0
    wq[..., cin:] = 0
    scale = torch.rand(cout, generator=g, device="cuda") * 1e-4
    bias = torch.randn(cout, generator=g, device="cuda")
    return xq, wq, scale, bias


def int8_bound(n, h, w, cin, cout, k, stride, pad, out_bytes):
    """Least time for one int8 conv: the codes (Cin channels) and weights
    read once, scale and bias read once, y written once, against
    2*M*Cout*K int8 operations (K = k*k*Cin). The zero channels the kernel
    pads Cin with are its own cost, not the function's. Returns (ms, bytes
    ms, operations ms)."""
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    ho, wo = ic.out_size(h, w, k, k, (stride, stride), pad)
    nbytes = n * h * w * cin + cout * k * k * cin + 8 * cout + \
        n * ho * wo * cout * out_bytes
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * 2 * n * ho * wo * cout * k * k * cin / INT8_OPS_PER_S
    return max(bytes_ms, ops_ms), bytes_ms, ops_ms


def once_ms(fn):
    """Device time of one fn() call (a large one), from CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def int8_bits(n, h, w, cin, cout, k, stride, pad, seed):
    """The conv kernel twice and its plain version on the same random codes,
    fp32 and bf16 out, with and without bias: the same bits or fail. The
    quantize kernel on x of the input's shape, per channel and per tensor,
    fp32 and bf16: the plain version's bits or fail."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    xq, wq, scale, bias = int8_codes(n, h, w, cin, cout, k, seed)
    name = f"N={n} {h}x{w} {cin}->{cout} k{k} s{stride} pad {pad}"
    for out in (torch.float32, torch.bfloat16):
        for b in (bias, None):
            got = ic.int8_conv2d_nhwc_cuda(xq, wq, scale, b, (stride,) * 2,
                                           pad, out)
            again = ic.int8_conv2d_nhwc_cuda(xq, wq, scale, b,
                                             (stride,) * 2, pad, out)
            want = ic.int8_conv2d_nhwc_plain(xq, wq, scale, b, (stride,) * 2,
                                             pad, out)
            if not (torch.equal(got, want) and torch.equal(got, again)):
                err = float((got.float() - want.float()).abs().max())
                raise AssertionError(f"int8 conv kernel != plain at {name} "
                                     f"{out} bias={b is not None}: max abs "
                                     f"err {err}, or two runs differ")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randn((n, h, w, cin), generator=g, device="cuda") * 3.0
    per_channel = torch.rand(cin, generator=g, device="cuda") / 40 + 1e-3
    for dtype in (torch.float32, torch.bfloat16):
        for s in (per_channel, per_channel.max()):
            got = ic.quantize_nhwc_cuda(x.to(dtype), s)
            if not torch.equal(got, ic.quantize_nhwc_plain(x.to(dtype), s)):
                raise AssertionError(f"quantize kernel != plain at {name} "
                                     f"{dtype} scales {tuple(s.shape)}")


def int8_streams_check(cases, rounds=8):
    """CUDA graphs of int8 convs replayed on three streams at once while
    eager calls of the same convs run on a fourth, for each case (N, H, W,
    Cin, Cout, k, stride, pad). Each graph reads its own buffer, refilled
    with another of `rounds` inputs before each replay; every result must
    have the bits of the eager call on its input. All the work is queued
    behind a long sleep kernel, so that the streams' launches run at the
    same time. Returns the number of results compared."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    compared = 0
    for c, (n, h, w, cin, cout, k, s, pad) in enumerate(cases):
        xq, wq, scale, bias = int8_codes(n, h, w, cin, cout, k, 3100 + c)
        g = torch.Generator(device="cuda").manual_seed(3200 + c)
        inputs = [torch.randint(-127, 128, xq.shape, generator=g,
                                device="cuda", dtype=torch.int8)
                  for _ in range(rounds)]
        for x in inputs:
            x[..., cin:] = 0

        def conv(x):
            return ic.int8_conv2d_nhwc_cuda(x, wq, scale, bias, (s, s), pad,
                                            torch.bfloat16)

        want = [conv(x) for x in inputs]
        eager = torch.cuda.Stream()
        streams = [torch.cuda.Stream() for _ in range(3)]
        bufs = {st: torch.empty_like(xq) for st in streams}
        for st in [eager] + streams:
            st.wait_stream(torch.cuda.current_stream())
        graphs, outs = [], []
        for st in streams:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs.append(conv(bufs[st]))
            graphs.append(graph)
        torch.cuda.synchronize()
        gate = torch.cuda.Event()
        torch.cuda._sleep(100_000_000)       # tens of ms: the host queues all
        gate.record()
        for st in [eager] + streams:
            st.wait_event(gate)
        got = []
        for r in range(rounds):
            for j, (graph, out, st) in enumerate(zip(graphs, outs, streams)):
                i = (r + j + 1) % rounds
                with torch.cuda.stream(st):
                    bufs[st].copy_(inputs[i])
                    graph.replay()
                    got.append((i, out.clone()))
            with torch.cuda.stream(eager):
                got.append((r, conv(inputs[r])))
        torch.cuda.synchronize()
        bad = [i for i, v in got if not torch.equal(v, want[i])]
        if bad:
            raise AssertionError(f"int8 conv on concurrent streams, N={n} "
                                 f"{h}x{w} {cin}->{cout}: {len(bad)} of "
                                 f"{len(got)} results differ from the eager "
                                 f"calls'")
        compared += len(got)
        del xq, wq, inputs, want, bufs, graphs, outs, got
    return compared


def int8_kernel_phase(ref_calls, fast_calls):
    """Phase 9: the int8 kernels' bits at every call shape (at N=4) and at
    the edges."""
    log("phase 9: int8 conv and quantize kernels vs plain (float64 conv of "
        "the same codes): the same bits, twice, fp32/bf16 out, with and "
        "without bias; the quantize pass per channel and per tensor")
    shapes = sorted({key[1:8] for key in list(ref_calls) + list(fast_calls)})
    cases = [(4,) + shape for shape in shapes] + INT8_EDGE_CASES
    for i, case in enumerate(cases):
        int8_bits(*case, seed=900 + i)
    log(f"  {len(shapes)} call shapes of the two int8 serving calls at N=4 "
        f"and {len(INT8_EDGE_CASES)} edge cases: the same bits as the plain "
        f"version, twice")
    # both designs (im2col with resident weights, 64-byte stages; the gather
    # with streamed weights) in CUDA graphs on three streams beside eager calls
    streams = [(16, 32, 32, 64, 64, 3, 1, (1, 1, 1, 1)),
               (16, 16, 16, 48, 256, 3, 2, (0, 1, 0, 1))]
    log(f"  CUDA graphs of the conv on three streams beside eager calls: "
        f"{int8_streams_check(streams)} results, the eager calls' bits")


def time_int8_calls(calls, title):
    """Per int8 conv call shape at the serving N: the conv kernel in a CUDA
    graph, the plain version (one call; its result must have the kernel's
    bits), the bound, the bf16 cuDNN conv of that shape (context only: a
    different function), and the quantize kernel, its plain version and
    bound. Returns the per-call sums."""
    import torch
    import torch.nn.functional as F

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    log(f"{title}: per int8 conv call shape (bf16 out, as the calls run), "
        f"device ms: conv kernel in a CUDA graph / plain / bound (share) | "
        f"bf16 cuDNN conv (context) | quantize kernel / plain / bound")
    keys = ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms", "cudnn_ms",
            "q_ms", "q_plain_ms", "q_bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    for i, ((n, h, w, cin, cout, k, s, pad, dtype), count) in enumerate(
            sorted(calls.items(), key=lambda kv: -np.prod(kv[0][:5]))):
        xq, wq, scale, bias = int8_codes(n, h, w, cin, cout, k, 2000 + i)
        args = (xq, wq, scale, bias, (s, s), pad, dtype)
        ms = graph_ms(lambda: ic.int8_conv2d_nhwc_cuda(*args), 10)
        got = ic.int8_conv2d_nhwc_cuda(*args)
        want = []
        plain = once_ms(lambda: want.append(ic.int8_conv2d_nhwc_plain(*args)))
        if not torch.equal(got, want[0]):
            raise AssertionError(f"int8 conv kernel != plain at the serving "
                                 f"shape N={n} {h}x{w} {cin}->{cout}")
        del got, want
        bound, bytes_ms, ops_ms = int8_bound(n, h, w, cin, cout, k, s, pad, 2)
        x16 = torch.randn((n, cin, h, w), device="cuda", dtype=dtype
                          ).contiguous(memory_format=torch.channels_last)
        w16 = torch.randn((cout, cin, k, k), device="cuda", dtype=dtype
                          ).contiguous(memory_format=torch.channels_last)
        t, b, l, r = pad
        cudnn = graph_ms(lambda: F.conv2d(
            F.pad(x16, (l, r, t, b)) if (t, l) != (b, r) else x16, w16, None,
            s, 0 if (t, l) != (b, r) else (t, l)), 10)
        del w16
        x = x16.permute(0, 2, 3, 1)
        sv = torch.rand(cin, device="cuda") / 40 + 1e-3
        q_ms = graph_ms(lambda: ic.quantize_nhwc_cuda(x, sv), 10)
        q_plain = event_ms(lambda: ic.quantize_nhwc_plain(x, sv), 2)
        # x read, its Cin codes written (not the padding), the scales read
        q_bound = 1e3 * (x.numel() * (x.element_size() + 1) + 4 * cin
                         ) / HBM_BYTES_PER_S
        log(f"  {count:2d} x N={n} {h}x{w} {cin}->{cout} k{k} s{s}: "
            f"{ms:.4f} / {plain:.2f} / {bound:.4f} ({bound / ms:.0%}, "
            f"{'ops' if ops_ms >= bytes_ms else 'bytes'}) | {cudnn:.4f} | "
            f"{q_ms:.4f} / {q_plain:.4f} / {q_bound:.4f} "
            f"({q_bound / q_ms:.0%})")
        for key, v in zip(keys, (ms, plain, bound, bytes_ms, ops_ms, cudnn,
                                 q_ms, q_plain, q_bound)):
            tot[key] += count * v
        del xq, wq, x16, x
        torch.cuda.empty_cache()
    log(f"  per call ({sum(calls.values())} int8 convs): conv kernel "
        f"{tot['ms']:.3f} ms in CUDA graphs, plain {tot['plain_ms']:.2f}, "
        f"bound {tot['bound_ms']:.3f} ({tot['bound_ms'] / tot['ms']:.1%} of "
        f"the graph time; bytes {tot['bytes_ms']:.3f}, operations "
        f"{tot['ops_ms']:.3f}); bf16 cuDNN {tot['cudnn_ms']:.3f}; quantize "
        f"{tot['q_ms']:.3f}, plain {tot['q_plain_ms']:.3f}, bound "
        f"{tot['q_bound_ms']:.3f} ({tot['q_bound_ms'] / tot['q_ms']:.1%})")
    return tot


def calibrate_vae(cfg, frames):
    """bench.py's calibration recipe for a VAE of `cfg` (seed 0 weights):
    encode the frames (fp32, conv_mode 'calibrate'), decode the mode."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.ops.quant import calibrate

    device = frames.device
    cvae = AutoencoderKL(**cfg, conv_mode="calibrate", seed=0, device=device)
    flat = frames.reshape((-1,) + tuple(frames.shape[2:])).to(
        torch.float32) * (1.0 / 255.0)
    return calibrate(lambda m, f: m.decode(m.encode(f).mode()), cvae, [flat])


def int8_serving_phase(frames, fast_frames, dlinear, out32, out_f32):
    """Phase 10: quantized serving at full width, card against CPU. Returns
    (the two calls' int8 conv shapes, the counted launches)."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    def int8_vae(cfg, mode, qscales, device=None):
        vae = AutoencoderKL(**cfg, conv_mode=mode, seed=0, device=device)
        vae.load_qscales(qscales)
        return vae.to(torch.bfloat16)

    def counted(name, fn, n, per_call, batch):
        ic.conv_launches = ic.quantize_launches = groupnorm.launches = 0
        times, out = wall_times(fn, n)
        got = (ic.conv_launches, ic.quantize_launches, groupnorm.launches)
        med = statistics.median(times)
        log(f"{name}: median {med * 1e3:.2f} ms over {n} calls (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{batch * T_OUT / med:.1f} frames/s; launches int8 conv "
            f"{got[0]}, quantize {got[1]}, GroupNorm {got[2]} "
            f"({'/'.join(f'{v / n:g}' for v in got)} a call)")
        if got != tuple(n * c for c in per_call):
            raise AssertionError(f"{name}: launches {got}, expected "
                                 f"{per_call} a call")
        return out, got

    log(f"phase 10: quantized serving, calibrated in fp32 on the serving "
        f"batch (bench.py's recipe)")
    t0 = time.perf_counter()
    qs = calibrate_vae(REFERENCE_VAE, frames)
    log(f"  reference VAE calibrated on {BATCH * T_IN} frames in "
        f"{time.perf_counter() - t0:.2f} s ({len(qs)} convs)")
    vae8 = int8_vae(REFERENCE_VAE, "int8_static", qs)
    pipe8 = make_forecast_pipeline(**codec(vae8, torch.bfloat16))
    ref_calls = record_int8_calls(vae8, lambda: pipe8(dlinear, frames))
    out8, launches = counted(f"int8_static bf16 reference call B={BATCH}",
                             lambda: pipe8(dlinear, frames), 10, (56, 56, 42),
                             BATCH)
    check_frames(out8, (BATCH, T_OUT, 1, HW, HW))
    s8 = frame_ssim(out32, out8)
    log(f"  int8_static vs fp32 SSIM {s8:.5f} (printed, no gate)")
    del out8

    qf = calibrate_vae(FAST_VAE, fast_frames)
    fmix = int8_vae(FAST_VAE, INT8_MIXED_SPEC, qf)
    pipe_m = make_forecast_pipeline(**codec(fmix, torch.bfloat16))
    fast_calls = record_int8_calls(fmix, lambda: pipe_m(dlinear, fast_frames))
    out_m, fast_launches = counted(
        f"fast VAE INT8_MIXED_SPEC bf16 B={FAST_BATCH}",
        lambda: pipe_m(dlinear, fast_frames), 10, (4, 4, 30), FAST_BATCH)
    check_frames(out_m, (FAST_BATCH, T_OUT, 1, HW, HW))
    s_mix = frame_ssim(out_f32, out_m)
    log(f"  int8-mixed vs its own fp32 SSIM {s_mix:.5f} (printed, no gate)")
    del out_m
    torch.cuda.empty_cache()

    # card against CPU on two sequences, the CPU's calibration on both
    dl_cpu = DLinear(T_IN, T_OUT, kernel_size=25, device="cpu")
    t0 = time.perf_counter()
    for cfg, mode, card_vae, pipe, seqs, ref in (
            (REFERENCE_VAE, "int8_static", vae8, pipe8, frames[:2], out32[:2]),
            (FAST_VAE, INT8_MIXED_SPEC, fmix, pipe_m, fast_frames[:2],
             out_f32[:2])):
        q_cpu = calibrate_vae(cfg, seqs.cpu())
        vae_cpu = AutoencoderKL(**cfg, seed=0, device="cpu")
        cpu32 = make_forecast_pipeline(device="cpu", **codec(
            vae_cpu, torch.float32))(dl_cpu, seqs.cpu())
        vae8_cpu = int8_vae(cfg, mode, q_cpu, "cpu")
        cpu8 = make_forecast_pipeline(device="cpu", **codec(
            vae8_cpu, torch.bfloat16))(dl_cpu, seqs.cpu())
        card_vae.load_qscales(q_cpu)
        n_convs, out = int8_convs_match_cpu(card_vae, vae8_cpu,
                                            lambda: pipe(dlinear, seqs))
        s_card = frame_ssim(ref, out)
        s_cpu = frame_ssim(cpu32, cpu8)
        name = "int8_static reference" if isinstance(mode, str) else \
            "fast int8-mixed"
        log(f"  {name}, sequences 0-1, CPU calibration: each of the call's "
            f"{n_convs} int8 convs gave the CPU's bits on the card's own "
            f"input; SSIM vs fp32 card {s_card:.5f}, CPU {s_cpu:.5f} (within "
            f"5e-3)")
        if n_convs != (56 if isinstance(mode, str) else 4):
            raise AssertionError(f"{name}: {n_convs} int8 convs checked")
        if not abs(s_card - s_cpu) <= 5e-3:
            raise AssertionError(f"{name} SSIM card {s_card} vs CPU {s_cpu}")
    log(f"  card vs CPU checks in {time.perf_counter() - t0:.2f} s")
    return ref_calls, fast_calls, launches, fast_launches


def _metric_gap(card, cpu):
    """(largest rel diff of the continuous keys, largest abs diff of the
    CSI/HSS keys) between two metric dicts."""
    cont, count = 0.0, 0.0
    for k, v in cpu.items():
        d = abs(card[k] - v)
        if k.startswith(("CSI", "HSS", "paper_CSI", "paper_HSS")):
            count = max(count, d)
        else:
            cont = max(cont, d / max(abs(v), 1e-12))
    return cont, count


def ensemble_eval_phase(frames, dlinear):
    """Phase 11: the ensemble rollout, calibrate_noise_std and
    evaluate_protocol on the card, and evaluate_protocol card vs CPU."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.evaluation import (
        evaluate_protocol)
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        calibrate_noise_std, make_ensemble_eval_fn, make_ensemble_pipeline,
        make_eval_fn, make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    vae32 = AutoencoderKL(**REFERENCE_VAE, seed=0)
    vae16 = copy.deepcopy(vae32).to(torch.bfloat16)
    a32, args = codec(vae32, torch.float32), codec(vae16, torch.bfloat16)
    pipe16 = make_forecast_pipeline(**args)
    ens = make_ensemble_pipeline(n_members=ENSEMBLE_MEMBERS, **args)
    x = frames[:ENSEMBLE_BATCH]
    log(f"phase 11: ensemble rollout, reference VAE, B={ENSEMBLE_BATCH}, "
        f"{ENSEMBLE_MEMBERS} members")

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def members(out):  # (N*B, ...) member-major -> (B, N, ...)
        return out.reshape((ENSEMBLE_MEMBERS, ENSEMBLE_BATCH)
                           + tuple(out.shape[1:])).transpose(0, 1)

    def encode_once(a):
        # the deterministic pipeline on the frames tiled N times, with the
        # B sequences encoded once and their latents tiled, as the
        # ensemble does
        def encode(f):
            z = a["encode_apply"](f[:f.shape[0] // ENSEMBLE_MEMBERS])
            return z.repeat((ENSEMBLE_MEMBERS,) + (1,) * (z.ndim - 1))
        return dict(a, encode_apply=encode)

    tiled = x.repeat((ENSEMBLE_MEMBERS, 1, 1, 1, 1))
    worst, self_ssim = {}, {}
    for name, a in (("fp32", a32), ("bf16", args)):
        out0 = make_ensemble_pipeline(n_members=ENSEMBLE_MEMBERS, **a)(
            dlinear, x, gen(0), 0.0)
        check_frames(out0, (ENSEMBLE_BATCH, ENSEMBLE_MEMBERS, T_OUT, 1, HW,
                            HW))
        same = members(make_forecast_pipeline(**encode_once(a))(dlinear,
                                                                 tiled))
        if not torch.equal(out0, same):
            raise AssertionError(f"{name}: the sigma=0 members are not the "
                                 f"deterministic path's bits")
        det = make_forecast_pipeline(**a)(dlinear, x)
        worst[name] = min(frame_ssim(out0[:, m], det)
                          for m in range(ENSEMBLE_MEMBERS))
        det64 = members(make_forecast_pipeline(**a)(dlinear, tiled))
        self_ssim[name] = min(frame_ssim(det64[:, m], det)
                              for m in range(ENSEMBLE_MEMBERS))
        del out0, same, det, det64
    log(f"  sigma=0: the members equal, bit for bit, the deterministic "
        f"pipeline on the batch tiled {ENSEMBLE_MEMBERS} times with the "
        f"sequences encoded once (fp32 and bf16). Every member vs the "
        f"deterministic call at B={ENSEMBLE_BATCH}: SSIM >= "
        f"{worst['fp32']:.6f} in fp32 (gate 0.999), >= {worst['bf16']:.5f} "
        f"in bf16 (printed: the deterministic call itself on the tiled "
        f"batch reads >= {self_ssim['bf16']:.5f} against it in bf16, "
        f"{self_ssim['fp32']:.6f} in fp32; the VAE's kernels are not batch-"
        f"invariant to the last bit)")
    if not worst["fp32"] >= 0.999:
        raise AssertionError(f"sigma=0 member SSIM {worst}")
    times, out1 = wall_times(lambda: ens(dlinear, x, gen(1), 0.1), 5)
    spread = float(out1.float().std(dim=1).mean())
    med = statistics.median(times)
    log(f"  sigma=0.1: member spread (mean std) {spread:.5f}; median "
        f"{med * 1e3:.2f} ms over 5 calls, "
        f"{ENSEMBLE_BATCH * ENSEMBLE_MEMBERS * T_OUT / med:.1f} member "
        f"frames/s")
    if not spread > 0:
        raise AssertionError("sigma > 0 gave no member spread")
    del out1

    seqs = [b["vil"] for b in vil_batches(2, ENSEMBLE_BATCH, seed=11)]
    best, table = calibrate_noise_std(
        make_ensemble_eval_fn(ens, T_IN, T_OUT), dlinear, seqs, NOISE_STDS,
        seed=0)
    log(f"  calibrate_noise_std, 2 batches of {ENSEMBLE_BATCH}: CRPS by noise "
        "std "
        + ", ".join(f"{k:g}: {v:.6f}" for k, v in table.items())
        + f"; best {best:g}")
    if best != min(table, key=table.get):
        raise AssertionError(f"calibrate_noise_std picked {best} of {table}")

    def protocol(pipe, a, batches, device=None):
        def roundtrip(m, target):
            b, t = target.shape[:2]
            flat = target.reshape((b * t,) + tuple(target.shape[2:]))
            return a["decode_apply"](a["encode_apply"](flat)).reshape(
                target.shape)

        return evaluate_protocol(make_eval_fn(pipe, T_IN, T_OUT, device=device),
                                 dlinear if device is None else dl_cpu,
                                 batches, roundtrip_fn=roundtrip)

    dl_cpu = DLinear(T_IN, T_OUT, kernel_size=25, device="cpu")
    evals = [b["vil"] for b in vil_batches(2, EVAL_BATCH, seed=12)]
    t0 = time.perf_counter()
    report = protocol(pipe16, args, evals)
    log(f"  evaluate_protocol, bf16, 2 batches of {EVAL_BATCH} x {EF_SEQ} "
        f"frames, in {time.perf_counter() - t0:.2f} s:")
    for line in report.format_table("eval").splitlines():
        log(f"    {line}")
    del vae16, pipe16, ens
    torch.cuda.empty_cache()

    vae_cpu = AutoencoderKL(**REFERENCE_VAE, seed=0, device="cpu")
    a_cpu = codec(vae_cpu, torch.float32)
    one = [evals[0][:2]]
    card = protocol(make_forecast_pipeline(**a32), a32, one)
    cpu = protocol(make_forecast_pipeline(device="cpu", **a_cpu), a_cpu, one,
                   device="cpu")
    gaps = [_metric_gap(getattr(card, k), getattr(cpu, k))
            for k in ("model", "persistence", "ceiling")]
    cont, count = max(g[0] for g in gaps), max(g[1] for g in gaps)
    log(f"  evaluate_protocol card vs CPU, fp32, one batch of 2: continuous "
        f"keys max rel diff {cont:.3g} (1e-4), CSI/HSS max abs diff "
        f"{count:.3g} (1e-3); wins {card.wins} and {cpu.wins}")
    if not (cont <= 1e-4 and count <= 1e-3):
        raise AssertionError(f"card vs CPU metrics differ: {cont}, {count}")


def int8_grad_check():
    """The int8 modes' gradients on the card (the conv kernel forward, the
    plain version's autograd backward) against the CPU's on the same
    inputs: x, kernel and bias within rel 1e-5 of their largest magnitude
    (sums in another order), for int8_conv, int8_conv_static and QConv in
    int8 mode."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops import quant as tq
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

    def grads(mode, arrays, device):
        x, k, b, absmax = (torch.tensor(a, device=device) for a in arrays)
        for t in (x, k, b):
            t.requires_grad_()
        if mode == "QConv":
            conv = tq.QConv(k.shape[2], k.shape[3], k.shape[0], padding=1,
                            mode="int8").to(device)
            with torch.no_grad():
                conv.weight.copy_(k.permute(3, 2, 0, 1))
                conv.bias.copy_(b)
            y = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            torch.sum(y ** 2).backward()
            return [x.grad, conv.weight.grad.permute(2, 3, 1, 0),
                    conv.bias.grad]
        if mode == "int8":
            y = tq.int8_conv(x, k, b, (1, 1), 1)
        else:
            y = tq.int8_conv_static(x, k, b, (1, 1), 1, absmax)
        torch.sum(y ** 2).backward()
        return [torch.zeros_like(t) if t.grad is None else t.grad
                for t in (x, k, b)]

    worst = 0.0
    before = ic.conv_launches
    for i, (n, h, w, cin, cout) in enumerate(((4, 32, 32, 128, 128),
                                               (2, 13, 17, 48, 24))):
        rng = np.random.default_rng(4000 + i)
        x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
        arrays = (x, (rng.standard_normal((3, 3, cin, cout)) * 0.1
                      ).astype(np.float32),
                  (rng.standard_normal(cout) * 0.1).astype(np.float32),
                  (np.abs(x).max(axis=(0, 1, 2)) * 0.8).astype(np.float32))
        for mode in ("int8", "int8_static", "QConv"):
            want = grads(mode, arrays, "cpu")
            got = grads(mode, arrays, "cuda")
            for name, a, b in zip(("x", "kernel", "bias"), got, want):
                scale = float(b.abs().max())
                err = float((a.cpu() - b).abs().max())
                worst = max(worst, err / scale if scale else err)
                if not err <= 1e-5 * scale:
                    raise AssertionError(f"int8 gradient card vs CPU, {mode} "
                                         f"{name} at {(n, h, w, cin, cout)}: "
                                         f"{err} (scale {scale})")
    if ic.conv_launches == before:
        raise AssertionError("the int8 gradients did not launch the kernel")
    log(f"  int8 gradients on the card (int8_conv, int8_conv_static, QConv "
        f"int8; x, kernel, bias) equal the CPU's: max err {worst:.3g} of the "
        f"largest magnitude (rel 1e-5), {ic.conv_launches - before} conv "
        f"launches (forward, and fp32(acc) again in each backward)")


def gan_bench_task(mixed, ae=GAN_AE, ndf=64, n_layers=3):
    """bench.py::bench_train's task on the port: PosAwareAE + PatchGAN,
    disc Adam(4.5e-5, 0.5, 0.9), disc_weight 0.5, disc_start 0, and the
    generator's clip 1.0 + AdamW(1e-4, weight decay 1e-4: optax's
    default)."""
    from weatherforecastingtoolkit_tpu_torch.models.conv_ae import PosAwareAE
    from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (
        NLayerDiscriminator)
    from weatherforecastingtoolkit_tpu_torch.training.gan import (
        make_vae_gan_task)
    from weatherforecastingtoolkit_tpu_torch.training.optim import adam, adamw

    task = make_vae_gan_task(
        name="bench_gan", generator_apply=lambda g, f, r: (g(f)[0], None),
        gen_init=lambda s, d: PosAwareAE(**ae, device=d, seed=s),
        disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: NLayerDiscriminator(1, ndf, n_layers,
                                                   device=d, seed=s),
        disc_tx=adam(4.5e-5, b1=0.5, b2=0.9), last_layer_path="dec_out.weight",
        disc_weight=0.5, disc_start=0, mixed_precision=mixed)
    return task, adamw(1e-4, weight_decay=1e-4, grad_clip=1.0)


def gan_state(task, tx, device, seed=0):
    import torch

    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        TrainState)

    params = task.init_params(seed, device)
    return TrainState(step=0, params=params,
                      opt_state=tx.init(list(params.parameters())),
                      rng=torch.Generator(device=device).manual_seed(seed),
                      extra=task.init_extra(seed, params))


def check_gan_aux(aux, where):
    bad = {k: float(v) for k, v in aux.items() if not np.isfinite(float(v))}
    if bad:
        raise AssertionError(f"{where}: non-finite {bad}")


def timed_steps(step, n):
    """n steps, each bracketed by synchronize(): (host seconds, auxes)."""
    import torch

    times, auxes = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, aux = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        auxes.append(aux)
    return times, auxes


def gan_bench_phase(tmp):
    """Phase 12: bench.py::bench_train on the port (fp32 with TF32 off,
    and bf16 mixed precision at 4x4, 8x4 and 16x4)."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.training.optim import (
        count_params)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    log(f"phase 12: GAN training at bench.py::bench_train's shapes, "
        f"PosAwareAE(latent_dim=2048) + NLayerDiscriminator(1, 64, 3), "
        f"B x {GAN_T} frames of {HW}x{HW}; median of {GAN_STEPS} steps after "
        f"2 warm-up steps")
    for mixed, b in GAN_RUNS:
        tag = f"{'bf16' if mixed else 'fp32'} {b}x{GAN_T}"
        task, tx = gan_bench_task(mixed)
        state = gan_state(task, tx, torch.device("cuda"))
        counts = (count_params(state.params),
                  count_params(state.extra["disc_params"]))
        if counts != GAN_PARAMS:
            raise AssertionError(f"parameter counts {counts} != {GAN_PARAMS}")
        vil = np.random.default_rng(0).random((b, GAN_T, 1, HW, HW),
                                              np.float32)
        batch = {"vil": torch.from_numpy(vil).cuda()}

        def step():
            return task.custom_train_step(state, batch, tx)

        groupnorm.launches = 0
        t0 = time.perf_counter()
        _, first = step()
        first = {k: float(v) for k, v in first.items()}
        first_s = time.perf_counter() - t0
        check_gan_aux(first, f"{tag} step 0")
        step()
        torch.cuda.reset_peak_memory_stats()
        times, auxes = timed_steps(step, GAN_STEPS)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, aux in enumerate(auxes):
            check_gan_aux(aux, f"{tag} step {i + 2}")
        med = statistics.median(times)
        busy, wall, count, top = profile_step(step, 3)
        if groupnorm.launches:
            raise AssertionError(f"{groupnorm.launches} GN kernel launches: "
                                 f"PosAwareAE's GroupNorms are F.group_norm")
        log(f"  {tag}: median {med * 1e3:.2f} ms/step (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}; first step "
            f"{first_s:.2f} s), {1 / med:.2f} steps/s, "
            f"{b * GAN_T / med:.1f} frames/s, peak mem {peak:.2f} GiB; "
            f"profiler, 3 steps: device busy {busy:.2f} of {wall:.2f} ms "
            f"({busy / wall:.0%}, profiler on), {count:.0f} kernels a step; "
            f"top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
        log(f"    losses step 0 -> {GAN_STEPS + 1}: loss {first['loss']:.5f} -> "
            f"{float(auxes[-1]['loss']):.5f}, d_weight "
            f"{float(auxes[-1]['d_weight']):.4g}, disc_loss "
            f"{float(auxes[-1]['disc_loss']):.5f}; all finite")
        del state, batch
        torch.cuda.empty_cache()
        if mixed:
            continue
        # the first fp32 step against the CPU, same seed and batch, and
        # against float64 on the card
        ref = {}
        for device, dtype in (("cpu", torch.float32), ("cuda", torch.float64)):
            task, tx = gan_bench_task(False)
            ref_state = gan_state(task, tx, torch.device(device))
            for mod in (ref_state.params, ref_state.extra["disc_params"]):
                mod.to(dtype)
            ref_state.opt_state = tx.init(list(ref_state.params.parameters()))
            ref_state.extra["disc_opt_state"] = tx.init(
                list(ref_state.extra["disc_params"].parameters()))
            t0 = time.perf_counter()
            _, aux = task.custom_train_step(ref_state, {"vil": torch.from_numpy(
                vil).to(device=device, dtype=dtype)}, tx)
            ref[dtype] = {k: float(aux[k]) for k in GAN_CPU_RTOL}
            log(f"    first step, {device} {str(dtype)[6:]} "
                f"({time.perf_counter() - t0:.1f} s): "
                + ", ".join(f"{k} {v:.7g}" for k, v in ref[dtype].items()))
            del ref_state
        cpu, f64 = ref[torch.float32], ref[torch.float64]

        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        log(f"    first fp32 step, card vs CPU: "
            + ", ".join(f"{k} {first[k]:.7g} / {cpu[k]:.7g} (rel "
                        f"{rel(first[k], cpu[k]):.2g}, tol {tol:g})"
                        for k, tol in GAN_CPU_RTOL.items())
            + "; against the card's float64 step, card fp32 / CPU fp32: "
            + ", ".join(f"{k} {rel(first[k], f64[k]):.2g} / "
                        f"{rel(cpu[k], f64[k]):.2g}" for k in GAN_CPU_RTOL))
        for k, tol in GAN_CPU_RTOL.items():
            if not abs(first[k] - cpu[k]) <= tol * abs(cpu[k]) + 1e-7:
                raise AssertionError(f"card vs CPU {k}: {first[k]} vs "
                                     f"{cpu[k]}")
        torch.cuda.empty_cache()

    # resume == straight, through Trainer.fit, at small width (bf16)
    def fit(name, batches, total, resume=False):
        cfg = Config({"experiment_name": "gan_resume", "seed": 0,
                      "experiment_path": os.path.join(tmp, name),
                      "optim": {"schedule": "constant", "lr": 1e-4,
                                "weight_decay": 1e-4, "grad_clip": 1.0},
                      "trainer": {"total_train_steps": total,
                                  "max_epochs": 1, "async_checkpoint": False,
                                  "save_every_n_steps": 0.5},
                      "logging": {"log_every_n_steps": 1}})
        task, _ = gan_bench_task(True, GAN_SMALL_AE, ndf=8, n_layers=2)
        tr = Trainer(cfg, task, resume=resume)
        state = tr.fit(batches, state=tr.init_state())
        tr.close()
        return state

    torch.backends.cudnn.deterministic = True
    batches = [{"vil": np.random.default_rng(i).random(
        (2, 2, 1, 32, 32)).astype(np.float32)} for i in range(4)]
    straight = fit("straight", batches, 4)
    fit("resumed", batches[:2], 4)
    resumed = fit("resumed", batches[2:], 4, resume=True)
    torch.backends.cudnn.deterministic = False

    def tensors(st):
        return (list(st.params.state_dict().values())
                + list(st.extra["disc_params"].state_dict().values())
                + st.opt_state["mu"] + st.opt_state["nu"]
                + st.extra["disc_opt_state"]["mu"]
                + st.extra["disc_opt_state"]["nu"])

    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tensors(straight), tensors(resumed)))
    log(f"  resume (bf16, small width): 2 steps, Trainer(resume=True), 2 more "
        f"vs 4 straight: steps {resumed.step} and {straight.step}, max diff "
        f"over both models and both Adam states {diff:.3g} (1e-6)")
    if resumed.step != 4 or not diff <= 1e-6:
        raise AssertionError(f"resumed GAN run differs from straight: {diff}")


def fast_vae_train_phase():
    """Phase 13: experiments_gpu/perf/fast_vae_train.py::build_step
    (FAST_SHAPE, bf16) at B x T = 16 x 4, bench.py::bench_fast_vae_train;
    the GroupNorm kernel inside the trained VAE."""
    import torch

    from experiments_gpu.perf.fast_vae_train import FAST_SHAPE, build_step
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda.groupnorm import (
        GroupNormSiLUFunction, group_norm_silu_reference)

    b = FAST_TRAIN_BATCH
    log(f"phase 13: fast-VAE GAN training (experiments_gpu/perf/"
        f"fast_vae_train.py::build_step(FAST_SHAPE), bf16 mixed precision), "
        f"B x T = {b} x {GAN_T}")
    batch = {"vil": torch.from_numpy(np.random.default_rng(0).random(
        (b, GAN_T, 1, HW, HW), np.float32)).cuda()}
    result = {}
    for remat in (False, True):
        step_fn, state, n_params = build_step(dict(FAST_SHAPE, remat=remat))

        def step():
            return step_fn(state, batch)

        calls = record_gn_calls(state.params.gen, step)
        per_step = sum(calls.values())
        step()
        groupnorm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, auxes = timed_steps(step, GAN_STEPS)
        launches = groupnorm.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        for i, aux in enumerate(auxes):
            check_gan_aux(aux, f"fast VAE remat={remat} step {i + 2}")
        med = statistics.median(times)
        if not per_step or launches != per_step * GAN_STEPS:
            raise AssertionError(f"fast VAE remat={remat}: {launches} GN "
                                 f"launches in {GAN_STEPS} steps, expected "
                                 f"{per_step} a step")
        busy, wall, count, top = profile_step(step, 3)
        log(f"  remat={remat} ({n_params} generator parameters): median "
            f"{med * 1e3:.2f} ms/step (min {min(times) * 1e3:.2f}, max "
            f"{max(times) * 1e3:.2f}), {1 / med:.2f} steps/s, "
            f"{b * GAN_T / med:.1f} frames/s, peak mem {peak:.2f} GiB; GN "
            f"kernel launches {launches} ({launches / GAN_STEPS:g} a step, one "
            f"a GroupNormSiLU forward call{', recomputed blocks included' if remat else ''}); "
            f"profiler, 3 steps: device busy {busy:.2f} of {wall:.2f} ms "
            f"({busy / wall:.0%}, profiler on), {count:.0f} kernels a step; "
            f"top: " + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
        result[remat] = dict(ms=med, busy=busy, launches=launches,
                             calls=calls)
        del state, step_fn
        torch.cuda.empty_cache()
    if not result[True]["launches"] > result[False]["launches"]:
        raise AssertionError("remat did not recompute the GroupNorm kernel")

    calls = result[False]["calls"]
    tot, _ = time_gn_calls(calls, f"  fast-VAE GAN training bf16 {b}x{GAN_T}, "
                                  f"forward GroupNorms of one step")
    # the backward: the autograd of the plain version, by shape, device time
    bwd_ms, err = 0.0, 0.0
    for i, ((shape, dtype, cl, groups, eps, silu), count) in enumerate(
            sorted(calls.items(), key=lambda kv: -np.prod(kv[0][0]))):
        x, sc, bi = gn_inputs(shape, dtype, cl, seed=1100 + i)
        leaves = [t.to(dtype).requires_grad_() for t in (x, sc, bi)]
        y = GroupNormSiLUFunction.apply(*leaves, groups, eps, silu)
        g = torch.randn(y.shape, device="cuda").to(dtype)
        if i == 0:   # the kernel's gradient against the plain version's
            want = torch.autograd.grad(group_norm_silu_reference(
                *leaves, groups, eps, silu), leaves, g)
            got = torch.autograd.grad(y, leaves, g, retain_graph=True)
            for a, w in zip(got, want):
                ok, e = within_tolerance(a, w)
                err = max(err, e)
                if not ok:
                    raise AssertionError(f"GN gradient at {shape}: {e}")
        ms = profile_step(lambda: torch.autograd.grad(
            y, leaves, g, retain_graph=True), 3)[0]
        bwd_ms += count * ms
        log(f"    {count:2d} x {shape} {str(dtype)[6:]}: backward (plain "
            f"version's autograd) {ms:.4f} ms device time")
        del x, y, g, leaves
    share = bwd_ms / result[False]["busy"]
    log(f"  GN kernel gradient at {sorted(calls, key=lambda k: -np.prod(k[0]))[0][0]} "
        f"(bf16 x, scale, bias) equals the plain version's autograd: max err "
        f"{err:.3g} (bf16: 1 ulp + 1e-4)")
    log(f"  per step: GN forward kernel {tot['ms']:.3f} ms (CUDA graphs; "
        f"bound {tot['bound_ms']:.3f} ms, {tot['bound_ms'] / tot['ms']:.1%} "
        f"of it; F.group_norm+F.silu {tot['library_ms']:.3f} ms; plain "
        f"{tot['plain_ms']:.3f} ms); GN backward {bwd_ms:.3f} ms device "
        f"time, {share:.1%} of the step's {result[False]['busy']:.2f} ms "
        f"device busy ({bwd_ms / (result[False]['ms'] * 1e3):.1%} of its "
        f"{result[False]['ms'] * 1e3:.2f} ms)")


def graph_kernels(fn):
    """cudaGraphNodeType of every node of a CUDA graph that captures one
    fn() call, after a warm-up call outside the capture (0 is a kernel):
    what the call puts on the card."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with open("/proc/self/maps") as maps:
        path = next(line.split()[-1] for line in maps
                    if "libcudart.so" in line)
    rt = ctypes.CDLL(path)
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cudaGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kinds.append(kind.value)
    return kinds


def step_timing(tr, state, batch, title, n=10):
    """Median host ms of n Trainer steps (after 3 warm-up steps), peak
    memory, and the profiler's busy share and kernels a step; logged."""
    import torch

    for _ in range(3):
        tr._train_step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, _ = wall_times(lambda: tr._train_step(state, batch), n)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, wall, count, top = profile_step(lambda: tr._train_step(state, batch),
                                          3)
    log(f"  {title}: median step {med * 1e3:.2f} ms over {n} (min "
        f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
        f"{1 / med:.2f} steps/s, peak mem {peak:.2f} GiB; profiler, 3 steps: "
        f"device busy {busy:.2f} ms of {wall:.2f} ms a step ({busy / wall:.0%}"
        f", profiler on), {count:.0f} kernels a step; top: "
        + "; ".join(f"{k} {v:.2f} ms" for k, v in top))
    return med


def device_ms_by_op(fn, ops):
    """Device ms of one fn() call (after a warm-up) spent under each aten
    op of ``ops`` (the kernels it launches itself), from torch.profiler,
    and the call's total kernel ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA) / 1e3
    return {e.key: e.self_device_time_total / 1e3 for e in events
            if e.key in ops}, total


def alphapre_phase(tmp):
    """Phase 14: AlphaPre + the physics prior at experiments/alphapre/
    config.yaml's widths through Trainer.fit; before training the card
    against the CPU on the same weights and batch. Returns the stencil's
    launches in the counted run and its timing at the step's shape."""
    import torch

    from experiments_gpu.alphapre.train import build_task
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import to_device
    from weatherforecastingtoolkit_tpu_torch.models import alphapre as ap
    from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        read_jsonl_metrics)
    from weatherforecastingtoolkit_tpu_torch.training.tasks import dequantize
    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        Trainer, derive_steps)
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    base = Config.load(ALPHAPRE_CONFIG).merge(
        {"physics_prior": {"enabled": True}})
    m, prior = base.model, base.physics_prior
    batch = base.dataset.batch_size

    def config(name, n_batches, b):
        cfg = base.merge({"experiment_path": os.path.join(tmp, name),
                          "dataset": {"batch_size": b},
                          "trainer": {"max_epochs": 1,
                                      "async_checkpoint": False},
                          "logging": {"log_every_n_steps": 1}})
        return derive_steps(cfg, n_batches, 0)

    log(f"phase 14: AlphaPre (dim {m.dim}, n_layers {m.n_layers}, spec_num "
        f"{m.spec_num}, {m.T_in}->{m.T_out} frames of {HW}x{HW}) + prior "
        f"(weight {prior.weight}, kappa {prior.kappa}) through Trainer.fit, "
        f"B={batch}, fp32, TF32 off")
    batches = vil_batches(ALPHAPRE_STEPS, batch, seed=14)
    task = build_task(config("x", 1, batch))

    # the card against the CPU (same seed, so the same numpy-drawn weights),
    # each beside a float64 forward on the card
    outs, losses = {}, {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cuda", torch.float64)):
        model = task.init_params(0, torch.device(dev)).to(dtype)
        x = dequantize(torch.from_numpy(batches[0]["vil"]).to(dev)).to(dtype)
        seen = []
        hook = model.register_forward_hook(lambda mod, a, out: seen.append(out))
        with torch.no_grad():
            _, loss = model.predict(x[:, :m.T_in], x[:, m.T_in:],
                                    compute_loss=True, step=0)
        hook.remove()
        outs[dev, dtype] = [t.double().cpu() for t in seen[0]]
        losses[dev, dtype] = {k: float(v) for k, v in loss.items()}
        del model
    card, cpu = ("cuda", torch.float32), ("cpu", torch.float32)
    f64 = ("cuda", torch.float64)
    bad, msg = [], []
    for i, name in enumerate(ALPHAPRE_OUTPUTS):
        a, b, r = outs[card][i], outs[cpu][i], outs[f64][i]
        err = float((a - b).abs().max())
        atol = ALPHAPRE_ATOL.get(name)
        msg.append(f"{name} {err:.3g} (card / CPU from float64 "
                   f"{float((a - r).abs().max()):.3g} / "
                   f"{float((b - r).abs().max()):.3g}; "
                   + (f"atol {atol:g})" if atol else "not checked)"))
        if atol is not None and not err <= atol:
            bad.append(name)
    for k, v in losses[cpu].items():
        rel = abs(losses[card][k] - v) / abs(v)
        r = losses[f64][k]
        msg.append(f"{k} rel {rel:.3g} (card / CPU from float64 "
                   f"{abs(losses[card][k] - r) / abs(r):.3g} / "
                   f"{abs(v - r) / abs(r):.3g}; rel 1e-4)")
        if not rel <= 1e-4:
            bad.append(k)
    log("  card vs CPU before training, same weights and batch, fp32, max "
        "abs err: " + "; ".join(msg))
    if bad:
        raise AssertionError(f"AlphaPre card vs CPU: {bad}")

    # the input phase (torch.angle of rfft2) at the real bins and on
    # all-zero frames, and irfft2 of spectra that are not Hermitian in both
    # of the port's layouts, against the CPU and numpy's definition
    x = dequantize(torch.from_numpy(batches[0]["vil"]))[:, :m.T_in]
    x[0, 0] = 0.0                                        # an all-zero frame
    card = torch.angle(torch.fft.rfft2(x.cuda())).cpu()
    cpu = torch.angle(torch.fft.rfft2(x))
    real = [(0, 0), (0, HW // 2), (HW // 2, 0), (HW // 2, HW // 2)]
    real_err = max(float((card[..., i, j] - cpu[..., i, j]).abs().max())
                   for i, j in real)
    jumps = int(((card - cpu).abs() > np.pi).sum())
    g = torch.Generator(device="cuda").manual_seed(14)
    errs, c2r = [], []
    for shape, dim in (((2, 12, 1, HW, HW // 2 + 1), (-2, -1)),
                       ((2, 32, HW, HW // 2 + 1, 12), (2, 3))):
        amps = torch.rand(shape, generator=g, device="cuda")
        pha = (torch.rand(shape, generator=g, device="cuda") - 0.5) * 6.3
        spec = amps * torch.exp(1j * pha)
        want = torch.from_numpy(np.fft.irfft2(
            spec.cpu().numpy().astype(np.complex128), s=(HW, HW), axes=dim))
        for out, fn in ((errs, lambda: ap.irfft2(spec, (HW, HW), dim=dim)),
                        (c2r, lambda: torch.fft.irfft2(spec, s=(HW, HW),
                                                       dim=dim))):
            out.append(float((fn().cpu().double() - want).abs().max()))
    log(f"  input phase on the card: the CPU's at the real bins (max err "
        f"{real_err:.3g}), all-zero frame {float(card[0, 0].abs().max()):g}; "
        f"{jumps} of {card.numel()} bins 2*pi from the CPU's (rounding-noise "
        f"bins near the negative real axis); irfft2 of spectra not "
        f"Hermitian, (B, T, C, H, W_f) and (B, C, H, W_f, T), from numpy's "
        f"definition in float64: the port's {errs[0]:.3g} and {errs[1]:.3g} "
        f"(1e-5), torch.fft.irfft2 (cuFFT's 2-D C2R) {c2r[0]:.3g} and "
        f"{c2r[1]:.3g}")
    if real_err != 0.0 or card[0, 0].any() or not max(errs) <= 1e-5:
        raise AssertionError(f"input phase or irfft2 on the card: "
                             f"{real_err}, {errs}")

    # training: the stencil's launches, losses finite, the prior logged
    cs.launches = 0
    groupnorm.launches = 0
    t0 = time.perf_counter()
    cfg = config("fit", ALPHAPRE_STEPS, batch)
    tr = Trainer(cfg, build_task(cfg))
    state = tr.fit(batches, state=tr.init_state())
    torch.cuda.synchronize()
    launches, gn = cs.launches, groupnorm.launches
    tr.close()
    recs = [r for r in read_jsonl_metrics(tr.run_dir) if "train_loss" in r]
    losses = [r["train_loss"] for r in recs]
    n_params = sum(p.numel() for p in state.params.parameters())
    log(f"  {ALPHAPRE_STEPS} steps at B={batch} in "
        f"{time.perf_counter() - t0:.2f} s ({n_params} params): loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}, prior "
        f"{recs[-1].get('train_physics_prior', float('nan')):.4g}, phase "
        f"{recs[-1].get('train_phase_loss', float('nan')):.4g}; stencil "
        f"launches {launches} ({launches / ALPHAPRE_STEPS:g}/step), "
        f"GroupNorm {gn}")
    if len(recs) != ALPHAPRE_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"AlphaPre losses: {losses}")
    if not all("train_physics_prior" in r for r in recs):
        raise AssertionError("physics_prior missing from the logged aux")
    if launches != ALPHAPRE_STEPS or gn != 0:
        raise AssertionError(f"stencil launches {launches} (expected one per "
                             f"step), GroupNorm {gn}")

    # step time, and the step's kernel time by aten op; the stencil at the
    # step's shape
    batch_dev = to_device(batches[0], tr.device)
    step_timing(tr, state, batch_dev, f"B={batch}")
    by_op, total = device_ms_by_op(
        lambda: tr._train_step(state, batch_dev),
        ("aten::convolution_backward", "aten::cudnn_convolution",
         "aten::native_group_norm", "aten::native_group_norm_backward",
         "aten::mm", "aten::_fft_r2c", "aten::_fft_c2c", "aten::_fft_c2r"))
    log(f"  one step's {total:.2f} ms of kernels by aten op: "
        + ", ".join(f"{k[6:]} {v:.2f}" for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])))
    del state, tr
    torch.cuda.empty_cache()
    shape = (batch, m.T_out, m.img_channels, HW, HW)
    x = torch.rand(shape, device="cuda")
    p = torch.tensor([prior.u, prior.v, prior.kappa], device="cuda")
    got = float(cs.advection_stencil_cuda(x, p))
    want = float(ps._frames_reference(x, *p))
    err = abs(got - want)
    if not err <= 1e-5 * abs(want):
        raise AssertionError(f"stencil at {shape}: {got} vs plain {want}")
    ms = graph_ms(lambda: cs.advection_stencil_cuda(x, p), 100)
    plain_ms = graph_ms(lambda: ps._frames_reference(x, *p), 20)
    bound, bound_by = stencil_bound(shape)
    log(f"  stencil at {shape}: kernel vs plain rel err "
        f"{err / abs(want):.3g} (1e-5); kernel {ms * 1e3:.2f} us (CUDA "
        f"graph), plain {plain_ms * 1e3:.2f} us, bound {bound * 1e3:.3f} us "
        f"({bound_by}, {bound / ms:.1%} of bound)")
    return launches


def custom_akl_phase():
    """Phase 15: CustomAutoencoderKL at its default width (64x8x8 latent,
    timeseries 2048), the forward (posterior mode) at B=CAKL_BATCH in fp32
    and bf16: GroupNorm launches a forward, one kernel a call at every call
    shape, the kernel against its plain version and timed per call shape;
    the card against the CPU at B=2 in fp32."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)
    from weatherforecastingtoolkit_tpu_torch.models.vae.custom_akl import (
        CustomAutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm

    ev = synthetic_vil_events(CAKL_BATCH, HW, HW, 1, seed=15)
    frames = torch.from_numpy(np.ascontiguousarray(np.transpose(
        ev, (0, 3, 1, 2)))).cuda().float() / 255.0        # (B, 1, H, W)
    vae32 = CustomAutoencoderKL(seed=0)
    n_params = sum(p.numel() for p in vae32.parameters())
    log(f"phase 15: CustomAutoencoderKL (128,256,512,512,512), 64x8x8 latent, "
        f"timeseries 2048 ({n_params} params), forward (posterior mode) at "
        f"B={CAKL_BATCH}")
    cpu = CustomAutoencoderKL(seed=0, device="cpu")
    with torch.no_grad():
        want, want_z, _ = cpu(frames[:2].cpu())
        got, got_z, _ = vae32(frames[:2])
    err = float((got.cpu() - want).abs().max())
    zerr = float((got_z.cpu() - want_z).abs().max() / want_z.abs().max())
    log(f"  card vs CPU fp32, B=2: recon max abs err {err:.3g} (2e-3), "
        f"z_timeseries {zerr:.3g} of its largest (1e-4)")
    if not (err <= 2e-3 and zerr <= 1e-4):
        raise AssertionError(f"CustomAutoencoderKL card vs CPU: {err}, {zerr}")
    del cpu
    for dtype in (torch.float32, torch.bfloat16):
        vae = vae32 if dtype == torch.float32 else \
            copy.deepcopy(vae32).to(dtype)
        x = frames.to(dtype)

        def fwd():
            with torch.inference_mode():
                return vae(x)

        calls = record_gn_calls(vae, fwd)
        per_call = sum(calls.values())
        groupnorm.launches = 0
        torch.cuda.reset_peak_memory_stats()
        times, (recon, z_ts, _) = wall_times(fwd, 5)
        launches = groupnorm.launches
        med = statistics.median(times)
        tag = str(dtype)[6:]
        log(f"  {tag}: median {med * 1e3:.2f} ms a forward over 5 (min "
            f"{min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}), "
            f"{CAKL_BATCH / med:.1f} frames/s, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; GN "
            f"launches {launches} ({launches / 5:g} a forward, "
            f"{per_call} GroupNormSiLU calls)")
        check_frames(recon.float(), (CAKL_BATCH, 1, HW, HW))
        if tuple(z_ts.shape) != (CAKL_BATCH, 2048):
            raise AssertionError(f"z_timeseries {tuple(z_ts.shape)}")
        if per_call != CAKL_GN_CALLS or launches != 5 * per_call:
            raise AssertionError(f"{launches} GN launches in 5 forwards, "
                                 f"{per_call} calls a forward; expected "
                                 f"{CAKL_GN_CALLS} each")
        kernels = {}
        for shape, cdtype, cl, groups, eps, silu in calls:
            xs, s, b = gn_inputs(shape, cdtype, cl, seed=15)
            s, b = s.to(cdtype), b.to(cdtype)
            nodes = graph_kernels(lambda: groupnorm.group_norm_silu_cuda(
                xs, s, b, groups, eps, silu))
            kernels[(shape, silu)] = nodes
            if nodes != [0]:
                raise AssertionError(f"GN at {shape}: graph nodes {nodes}, "
                                     f"expected one kernel")
        log(f"  one kernel a GroupNorm call (CUDA-graph nodes) at each of "
            f"{len(kernels)} call shapes: "
            + ", ".join(f"{s[1]}x{s[2]}x{s[3]}" for s, _ in sorted(
                kernels, key=lambda k: -np.prod(k[0]))))
        del recon, z_ts
        torch.cuda.empty_cache()
        time_gn_calls(calls, f"  CustomAutoencoderKL {tag} B={CAKL_BATCH}")
        del vae
        torch.cuda.empty_cache()


def token_vit_phase(tmp):
    """Phase 16: the token-sequence Path-B task at experiments/token_vit/
    config.yaml's widths (frozen random ViTAE, TokenSequenceForecaster)
    through Trainer.fit, B=2, fp32; step time; one eval_fn call."""
    from experiments_gpu.token_vit.train import build_task
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import to_device
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        read_jsonl_metrics)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        Trainer, derive_steps)
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    base = Config.load(TOKEN_VIT_CONFIG)
    v, fc = base.vit_ae, base.forecaster
    batch = base.dataset.batch_size
    cfg = derive_steps(base.merge({
        "experiment_path": os.path.join(tmp, "token_vit"),
        "trainer": {"max_epochs": 1, "async_checkpoint": False},
        "logging": {"log_every_n_steps": 1}}), 3, 0)
    log(f"phase 16: token_vit (frozen ViTAE {v.img_size}^2, patch {v.patch}, "
        f"d_token {v.d_token}, d_latent {v.d_latent}, depth "
        f"{v.depth_enc}/{v.depth_dec}, heads {v.heads}; forecaster depth "
        f"{fc.depth}, heads {fc.num_heads}) through Trainer.fit, B={batch}, "
        f"fp32")
    batches = vil_batches(3, batch, seed=16)
    task = build_task(cfg)
    groupnorm.launches = 0
    tr = Trainer(cfg, task)
    state = tr.fit(batches, state=tr.init_state())
    tr.close()
    losses = [r["train_loss"] for r in read_jsonl_metrics(tr.run_dir)
              if "train_loss" in r]
    log(f"  3 steps: losses {losses}")
    if len(losses) != 3 or not all(np.isfinite(losses)):
        raise AssertionError(f"token_vit losses {losses}")
    batch_dev = to_device(batches[0], tr.device)
    pred, gt = task.eval_fn(state.params, batch_dev, None)
    check_frames(pred, tuple(gt.shape))
    med = step_timing(tr, state, batch_dev, f"B={batch}")
    if groupnorm.launches:
        raise AssertionError("token_vit launched the GroupNorm kernel")
    return med


def registry_phase(tmp):
    """Phase 17: one reconstruction_task step (experiments_gpu/ae_recon's
    build_task) for each of ZOO_RECON at the registry's default widths,
    B x T = 2 x 2 frames of 128^2, through Trainer.fit (2 steps)."""
    import torch

    from experiments_gpu.ae_recon.train import build_task
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        read_jsonl_metrics)
    from weatherforecastingtoolkit_tpu_torch.training.optim import (
        count_params)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        Trainer, derive_steps)
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    log(f"phase 17: reconstruction_task (experiments_gpu/ae_recon) at the "
        f"registry's default widths, B x T = 2 x 2 frames of {HW}x{HW}, 2 "
        f"steps each")
    batches = [{"vil": np.ascontiguousarray(b["vil"][:, :2])}
               for b in vil_batches(2, 2, seed=17)]
    base = Config.load(AE_RECON_CONFIG)
    for name in ZOO_RECON:
        cfg = derive_steps(base.merge({
            "experiment_path": os.path.join(tmp, name),
            "trainer": {"max_epochs": 1, "async_checkpoint": False},
            "logging": {"log_every_n_steps": 1}}), 2, 0)
        cfg.model = Config({"name": name})
        t0 = time.perf_counter()
        tr = Trainer(cfg, build_task(cfg))
        state = tr.fit(batches, state=tr.init_state())
        torch.cuda.synchronize()
        tr.close()
        losses = [r["train_loss"] for r in read_jsonl_metrics(tr.run_dir)
                  if "train_loss" in r]
        log(f"  {name} ({count_params(state.params)} params): losses "
            f"{losses}, {time.perf_counter() - t0:.2f} s with the build")
        if len(losses) != 2 or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: losses {losses}")
        del state, tr
        torch.cuda.empty_cache()


def zoo_phase():
    """Phases 14-17 in a fresh process (``chip_smoke.py --zoo``): AlphaPre
    with the prior, CustomAutoencoderKL, token_vit and the registry's
    frame AEs. The stencil's and GroupNorm's launches on their new paths
    are checked inside the phases."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # one nvcc each
        for fut in [pool.submit(k.build) for k in (groupnorm, stencil)]:
            fut.result()
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_zoo_")
    try:
        alphapre_phase(tmp)
        custom_akl_phase()
        token_vit_phase(tmp)
        registry_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phases 14-17: {time.perf_counter() - t0:.1f} s")
    return 0


def train_phase():
    """Phases 12-13 in a fresh process (``chip_smoke.py --train``): the
    profiler then sees the card, and the serving phases' memory is gone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gan_")
    try:
        gan_bench_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fast_vae_train_phase()
    return 0


def profile_phase():
    """Phase 5's torch.profiler checks, run as ``chip_smoke.py --profile`` in
    a fresh process: one GroupNormSiLU forward and one stencil call are each
    exactly one operation on the card (torch.profiler); the
    serving profile of one reference-shape bf16 call (B=64), one fast-VAE
    bf16 call (B=256) and one int8_static reference-shape bf16 call (B=64,
    calibrated on its batch): kernels per call, the device's busy share
    and the top five kernels."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        GroupNormSiLU)
    from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    names = set()
    for dtype in (torch.bfloat16, torch.float32):
        for pdt in (torch.bfloat16, torch.float32):
            mod = GroupNormSiLU(128, 32).to(device="cuda", dtype=pdt)
            x, _, _ = gn_inputs((4, 128, 64, 64), dtype, True, seed=7)
            with torch.inference_mode():
                names.add(one_kernel(f"GroupNormSiLU x {dtype} params {pdt}",
                                     lambda: mod(x)))
    log(f"phase 5 (profile process): one GroupNormSiLU forward = one kernel "
        f"on the card, by torch.profiler (x and parameters fp32/bf16): "
        f"{sorted(n[:40] for n in names)}")
    x = torch.rand((2, 12, 1, HW, HW), device="cuda")
    coeffs = torch.tensor([0.3, -0.2, 0.05], device="cuda")
    u, v, k = coeffs
    name = one_kernel("advection_stencil_cuda",
                      lambda: cs.advection_stencil_cuda(x, coeffs))
    one_kernel("advection_diffusion_prior",
               lambda: ps.advection_diffusion_prior(x, u, v, k))
    log(f"  one stencil call = one kernel on the card ({name[:40]}; "
        f"advection_stencil_cuda and advection_diffusion_prior)")
    dlinear = DLinear(T_IN, T_OUT, kernel_size=25)
    for cfg, batch, title, mode in (
            (REFERENCE_VAE, BATCH, "reference-shape", "native"),
            (FAST_VAE, FAST_BATCH, "fast-VAE", "native"),
            (REFERENCE_VAE, BATCH, "reference-shape int8_static",
             "int8_static")):
        events = synthetic_vil_events(batch, HW, HW, T_IN, seed=0)
        frames = torch.from_numpy(np.ascontiguousarray(
            np.transpose(events, (0, 3, 1, 2))[:, :, None])).cuda()
        vae = AutoencoderKL(**cfg, conv_mode=mode, seed=0)
        if mode == "int8_static":
            vae.load_qscales(calibrate_vae(cfg, frames))
        vae = vae.to(torch.bfloat16)
        pipe = make_forecast_pipeline(**codec(vae, torch.bfloat16))
        check_frames(pipe(dlinear, frames), (batch, T_OUT, 1, HW, HW))
        log_profile(f"  serving profile, {title} bf16 B={batch}",
                    lambda: pipe(dlinear, frames))
        del vae, pipe, frames
        torch.cuda.empty_cache()
    return 0


def main():
    import torch

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
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import (
        stencil as stencil_cuda)

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
    kernels = (groupnorm, stencil_cuda, int8_conv)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:  # one nvcc each
        for fut in [pool.submit(k.build) for k in kernels]:
            fut.result()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s in parallel (nvcc "
        f"groupnorm_silu.cu {groupnorm.build_seconds:.2f} s, "
        f"advection_stencil.cu {stencil_cuda.build_seconds:.2f} s, "
        f"int8_conv.cu {int8_conv.build_seconds:.2f} s)")
    for kernel in kernels:
        for line in kernel.build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {kernel.SOURCE.name}: {line.strip()}")
    gmma = sass_count(int8_conv.build()._name, "GMMA")
    log(f"int8_conv.cu: {gmma} GMMA (wgmma) instructions in cuobjdump -sass "
        f"of the built library")
    if not gmma > 0:
        raise AssertionError("no wgmma instruction in the int8 conv library")

    # -------------------------------------- 2. kernel against plain version
    log("phase 2: kernel vs plain (fp32 atol 1e-4; bf16 1 ulp + 1e-4), the "
        "same bits on two runs, fp32 and bf16 scale/bias")

    def gn_case(shape, groups, dtype, cl, silu, eps, param_dtype, seed):
        x, s, b = gn_inputs(shape, dtype, cl, seed)
        s, b = s.to(param_dtype), b.to(param_dtype)
        got = groupnorm.group_norm_silu_cuda(x, s, b, groups, eps, silu)
        again = groupnorm.group_norm_silu_cuda(x, s, b, groups, eps, silu)
        want = groupnorm.group_norm_silu_reference(x, s, b, groups, eps, silu)
        torch.cuda.synchronize()
        ok, err = within_tolerance(got, want)
        name = (f"N={shape[0]} C={shape[1]} {shape[2]}x{shape[3]} G={groups} "
                f"{dtype} cl={cl} silu={silu} eps={eps} params {param_dtype}")
        if not ok:
            raise AssertionError(f"kernel != plain at {name}: max err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"two runs differ at {name}")
        return err

    dtypes = (torch.float32, torch.bfloat16)
    for ci, (c, h, w) in enumerate(GN_CLASSES):
        errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
        cases = 0
        for n in (4, 1):
            for dtype in dtypes:
                for cl in (False, True):
                    for silu, eps in ((True, 1e-6), (False, 1e-6),
                                      (True, 1e-5), (False, 1e-5)):
                        for pdt in dtypes:
                            errs[dtype] = max(errs[dtype], gn_case(
                                (n, c, h, w), 32, dtype, cl, silu, eps, pdt,
                                seed=ci * 97 + n))
                            cases += 1
        log(f"  C={c} {h}x{w}: {cases} cases ok, max abs err fp32 "
            f"{errs[torch.float32]:.3g}, bf16 {errs[torch.bfloat16]:.3g}")
    for i, (n, c, h, w, groups) in enumerate(GN_EDGE_CASES):
        err, cases = 0.0, 0
        for dtype in dtypes:
            for cl in (False, True):
                for pdt in dtypes:
                    err = max(err, gn_case((n, c, h, w), groups, dtype, cl,
                                           True, 1e-6, pdt, seed=500 + i))
                    cases += 1
        log(f"  edge N={n} C={c} {h}x{w} G={groups}: {cases} cases ok, max "
            f"abs err {err:.3g}")

    # --------------------------------------------------- 3. the main path
    events = synthetic_vil_events(BATCH, HW, HW, T_IN, seed=0)
    frames = torch.from_numpy(np.ascontiguousarray(
        np.transpose(events, (0, 3, 1, 2))[:, :, None])).cuda()  # uint8
    vae32 = AutoencoderKL(**REFERENCE_VAE, seed=0)
    vae16 = copy.deepcopy(vae32).to(torch.bfloat16)
    dlinear = DLinear(T_IN, T_OUT, kernel_size=25)

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

    del out16, pipe32, ar16
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
    del out_f16, fast16, fast32, fvae32, fvae16
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

    fast_tot, _ = time_gn_calls(fast_gn_calls,
                                f"fast-VAE bf16 B={FAST_BATCH}")
    tot, err = time_gn_calls(gn_calls, f"reference-shape bf16 B={BATCH}")
    torch.cuda.empty_cache()

    # torch.profiler in a fresh process: in this one, after the phases
    # above, its sessions came back empty on the card
    subprocess.run([sys.executable, os.path.abspath(__file__), "--profile"],
                   check=True)

    # ------------------------------------------ 6.-8. the training slice
    stencil_err = stencil_phase()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        stencil_launches, st, fit_err = earthformer_phase(tmp)
        latent_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------- 12.-13. GAN training, a fresh process
    subprocess.run([sys.executable, os.path.abspath(__file__), "--train"],
                   check=True)
    # ---------------------------------- 14.-17. the model zoo, a fresh process
    subprocess.run([sys.executable, os.path.abspath(__file__), "--zoo"],
                   check=True)

    # ------------------------------ 9.-11. quantized serving, verification
    ref_calls, fast_calls, int8_launches, _ = int8_serving_phase(
        frames, fast_frames, dlinear, out32, out_f32)
    del out32, out_f32, fast_frames
    torch.cuda.empty_cache()
    int8_kernel_phase(ref_calls, fast_calls)
    int8_grad_check()
    time_int8_calls(fast_calls, f"fast VAE INT8_MIXED_SPEC bf16 B={FAST_BATCH}")
    i8 = time_int8_calls(ref_calls, f"int8_static reference bf16 B={BATCH}")
    ensemble_eval_phase(frames, dlinear)

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "group_norm_silu", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches,
        "max_abs_err": err, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations",
        "library_ms": tot["library_ms"]}, {
        "name": "advection_stencil", "route": "cuda",
        "source": STENCIL_SOURCE, "replaces": STENCIL_REPLACES,
        "launches": stencil_launches,
        "max_abs_err": max(stencil_err, fit_err), "ms": st["ms"],
        "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"], "library_ms": None}, {
        "name": "int8_conv2d", "route": "cuda", "source": INT8_SOURCE,
        "replaces": INT8_CONV_REPLACES, "launches": int8_launches[0],
        "max_abs_err": 0.0, "ms": i8["ms"], "plain_ms": i8["plain_ms"],
        "bound_ms": i8["bound_ms"],
        "bound_by": "bytes" if i8["bytes_ms"] >= i8["ops_ms"] else "operations",
        "library_ms": None}, {
        "name": "quantize_nhwc", "route": "cuda", "source": INT8_SOURCE,
        "replaces": QUANTIZE_REPLACES, "launches": int8_launches[1],
        "max_abs_err": 0.0, "ms": i8["q_ms"], "plain_ms": i8["q_plain_ms"],
        "bound_ms": i8["q_bound_ms"], "bound_by": "bytes",
        "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--profile": profile_phase, "--train": train_phase,
              "--zoo": zoo_phase}.get(
        sys.argv[1] if sys.argv[1:] else "", main)())
