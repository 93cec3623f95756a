#!/usr/bin/env python
"""bf16-vs-fp32 SSIM of the port's reference-shape serving rollout over
weight draws, on the card (or, with --device cpu, on the CPU).

chip_smoke.py gates the bf16 serving recipe on its SSIM against fp32. With
random weights that SSIM depends on the draw; this prints it for seeds
0..N-1 so the gate can be set from the spread.

    python bf16_gate_draws.py [--seeds 10] [--batch 16] [--device cpu]
"""

import argparse
import copy
import os
import statistics
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    from chip_smoke import (HW, REFERENCE_VAE, T_IN, T_OUT, codec,
                            frame_ssim)
    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    events = synthetic_vil_events(args.batch, HW, HW, T_IN, seed=0)
    frames = torch.from_numpy(np.ascontiguousarray(
        np.transpose(events, (0, 3, 1, 2))[:, :, None])).to(args.device)
    dlinear = DLinear(T_IN, T_OUT, kernel_size=25, device=args.device)
    values = []
    for seed in range(args.seeds):
        vae32 = AutoencoderKL(**REFERENCE_VAE, seed=seed, device=args.device)
        vae16 = copy.deepcopy(vae32).to(torch.bfloat16)
        out32 = make_forecast_pipeline(device=args.device, **codec(
            vae32, torch.float32))(dlinear, frames)
        out16 = make_forecast_pipeline(device=args.device, **codec(
            vae16, torch.bfloat16))(dlinear, frames)
        values.append(frame_ssim(out32, out16))
        print(f"seed {seed}: bf16 vs fp32 SSIM {values[-1]:.5f}", flush=True)
    print(f"{len(values)} draws, B={args.batch}: min {min(values):.5f}, "
          f"median {statistics.median(values):.5f}, max {max(values):.5f}; "
          f"{sum(v > 0.99 for v in values)} above 0.99")


if __name__ == "__main__":
    main()
