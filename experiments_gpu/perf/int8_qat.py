"""Quantization-aware fine-tuning for the int8_static serving path, on the
card (counterpart of experiments/perf/int8_qat.py).

On trained weights (the regime that matters for deployment; the serving
gate's random weights are another):

  1. train the bench-shape AutoencoderKL (64, 128, 256, 512, 512 -> 64x8x8
     latent) as a round-trip AE (L1, clip 1.0 + AdamW) on synthetic VIL
     frames; its GroupNorms run the GroupNorm kernel in the forward;
  2. calibrate per-conv per-input-channel activation scales
     (``ops/quant.py::calibrate``) on training batches;
  3. measure the deployed int8_static path (the hand-written int8 conv and
     quantize kernels) before QAT: SSIM against the fp32 output (the
     serving gate) and against the input frames (task quality);
  4. fine-tune under ``conv_mode="fake_quant"`` (int8 numerics with
     straight-through gradients, the calibration scales fixed);
  5. re-measure both SSIMs for int8_static(W_qat), and the fp32 path of
     the QAT weights.

The four models (native, calibrate, int8_static, fake_quant) share one set
of weights, copied between them with ``load_state_dict``.

    python experiments_gpu/perf/int8_qat.py [--steps 2000] [--qat-steps 800]
        [--qat-lr 2e-5] [--events 192]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    NARROW_HW, NARROW_VAE, add_common_args, describe_device, frame_ssim,
    vae_config)
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (  # noqa: E402
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.ops.quant import calibrate  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.optim import adamw  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

HW = 128
BATCH = 16  # frames per optimizer step
EVAL_BATCH = 32


def frame_pool(n_events, seed, hw=HW):
    ev = synthetic_vil_events(n_events, hw, hw, 13, seed=seed)  # (N,H,W,T)
    frames = np.transpose(ev, (0, 3, 1, 2)).reshape(-1, 1, hw, hw)
    return frames.astype(np.float32) / 255.0


def train(model, frames, steps, lr, tag, device):
    """``steps`` clip 1.0 + AdamW(lr) steps of the L1 round trip on random
    batches of ``frames``, in place."""
    params = list(model.parameters())
    tx = adamw(lr, weight_decay=1e-4, grad_clip=1.0)   # optax.adamw's decay
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for i in range(steps):
        idx = rng.integers(0, len(frames), BATCH)
        batch = torch.from_numpy(frames[idx]).to(device)
        loss = torch.mean(torch.abs(model(batch) - batch))
        grads = torch.autograd.grad(loss, params)
        tx.update(params, list(grads), opt_state)
        if i == 0 or (i + 1) % max(1, steps // 8) == 0:
            print(f"  {tag} step {i + 1}/{steps}: L1 {float(loss.detach()):.5f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)


def outputs(model, frames, device):
    with torch.inference_mode():
        return torch.cat([model(torch.from_numpy(
            frames[i:i + EVAL_BATCH]).to(device)).float()
            for i in range(0, len(frames), EVAL_BATCH)])


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--qat-steps", type=int, default=800)
    p.add_argument("--qat-lr", type=float, default=2e-5)
    p.add_argument("--events", type=int, default=192)
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, kw = ((NARROW_HW, vae_config(NARROW_VAE)) if args.narrow
              else (HW, vae_config()))
    print(f"devices: {describe_device(device)}", flush=True)

    train_frames = frame_pool(args.events, 0, hw)
    eval_frames = frame_pool(48, 1, hw)[:256]
    eval_t = torch.from_numpy(eval_frames).to(device)

    def model(mode):
        return AutoencoderKL(**kw, conv_mode=mode, seed=0, device=device)

    native, static = model("native"), model("int8_static")
    n_params = sum(p.numel() for p in native.parameters())
    print(f"AutoencoderKL {n_params / 1e6:.1f}M params; "
          f"{len(train_frames)} train frames", flush=True)

    # ---- stage 1: train the fp32 AE
    train(native, train_frames, args.steps, 1e-4, "fp32", device)

    # ---- calibrate static scales on training-distribution batches
    calib = model("calibrate")
    calib.load_state_dict(native.state_dict())
    qscales = calibrate(lambda m, b: m(b), calib, [
        torch.from_numpy(train_frames[i * 32:(i + 1) * 32]).to(device)
        for i in range(4)])

    def report(tag, state):
        native.load_state_dict(state)
        static.load_state_dict(state)
        static.load_qscales(qscales)
        out_fp32 = outputs(native, eval_frames, device)
        out_int8 = outputs(static, eval_frames, device)
        gate = frame_ssim(out_fp32, out_int8)
        task_fp32 = frame_ssim(eval_t, out_fp32)
        task_int8 = frame_ssim(eval_t, out_int8)
        print(f"{tag}: int8-vs-fp32 SSIM {gate:.5f} | task SSIM "
              f"fp32 {task_fp32:.5f} int8 {task_int8:.5f}", flush=True)
        return gate, task_fp32, task_int8

    print("--- before QAT ---", flush=True)
    trained = {k: v.clone() for k, v in native.state_dict().items()}
    before = report("post-training int8_static", trained)

    # ---- stage 2: QAT fine-tune under fake_quant
    fq = model("fake_quant")
    fq.load_state_dict(trained)
    fq.load_qscales(qscales)
    train(fq, train_frames, args.qat_steps, args.qat_lr, "qat", device)

    print("--- after QAT ---", flush=True)
    after = report("int8_static(W_qat)", fq.state_dict())
    # the float path of the QAT weights (what an fp32/bf16 fallback would
    # serve): shows whether QAT sacrificed the float model
    print(f"fp32(W_qat) task SSIM {after[1]:.5f}", flush=True)
    return dict(before=before, after=after)


if __name__ == "__main__":
    main()
