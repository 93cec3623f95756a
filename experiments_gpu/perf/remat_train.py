"""What per-block rematerialization buys the GAN train step on the card
(counterpart of experiments/perf/remat_train.py).

The two-optimizer PosAwareAE(latent_dim=2048) + PatchGAN step
(``training/gan.py::make_vae_gan_task``, bf16 mixed precision, the
discriminator on from step 0) at B x T = 16 x 4 and 32 x 4 frames of
128^2, with ``remat`` off and on (``models/common.py::run_blocks``: each
Enc/DecBlock recomputed in the backward, on the bf16 parameter copies the
forward saw). Prints steps/s, frames/s and the peak memory of each, to say
whether remat lets a larger batch run faster per frame. PosAwareAE has no
GroupNorm kernel; the step is cuDNN convs and eager elementwise work.

    python experiments_gpu/perf/remat_train.py [--batches 16,32] [--steps 8]

The JAX script's persistent compile cache is a TPU service with no
counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    add_common_args, describe_device, empty_cache, timed)
from weatherforecastingtoolkit_tpu_torch.models.conv_ae import PosAwareAE  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (  # noqa: E402
    NLayerDiscriminator)
from weatherforecastingtoolkit_tpu_torch.training.gan import make_vae_gan_task  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.optim import adam, adamw  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.trainer import TrainState  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

HW, T = 128, 4
AE = dict(latent_dim=2048)
DISC = (1, 64, 3)       # NLayerDiscriminator(input_nc, ndf, n_layers)
NARROW = (32, dict(enc_channels=(8, 16), dec_channels=(16, 8, 8),
                   num_blocks=1, latent_hw=8, latent_channels=4,
                   latent_dim=32), (1, 8, 1))


def gan_task(remat, ae=AE, disc=DISC, mixed=True):
    """bench.py::bench_train's task: PosAwareAE + PatchGAN, bf16 mixed
    precision unless ``mixed`` is False."""
    return make_vae_gan_task(
        name="remat_probe",
        generator_apply=lambda g, f, r: (g(f)[0], None),
        gen_init=lambda s, d: PosAwareAE(**ae, remat=remat, device=d, seed=s),
        disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: NLayerDiscriminator(*disc, device=d, seed=s),
        disc_tx=adam(4.5e-5, b1=0.5, b2=0.9),
        last_layer_path="dec_out.weight",
        disc_weight=0.5, disc_start=0, mixed_precision=mixed)


def gan_state(task, tx, device, seed=0):
    params = task.init_params(seed, device)
    return TrainState(step=0, params=params,
                      opt_state=tx.init(list(params.parameters())),
                      rng=torch.Generator(device=device).manual_seed(seed),
                      extra=task.init_extra(seed, params))


def measure(remat, bsz, steps, device, hw=HW, ae=AE, disc=DISC):
    task = gan_task(remat, ae, disc)
    tx = adamw(1e-4, weight_decay=1e-4, grad_clip=1.0)
    state = gan_state(task, tx, device)
    batch = {"vil": torch.from_numpy(np.random.default_rng(0).random(
        (bsz, T, 1, hw, hw), np.float32)).to(device)}
    tag = f"remat={'on ' if remat else 'off'} B={bsz}x{T}"

    def step():
        nonlocal state
        state, aux = task.custom_train_step(state, batch, tx)
        return aux

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    try:
        t, first_s, aux = timed(step, device, n_rep=steps)
    except torch.cuda.OutOfMemoryError as e:   # a batch that does not fit
        print(f"{tag}: FAILED {type(e).__name__}: "
              f"{str(e).splitlines()[0][:200]}", flush=True)
        return None
    finally:
        empty_cache(device)
    if not np.isfinite(float(aux["loss"])):
        raise AssertionError(f"{tag}: loss {float(aux['loss'])}")
    peak = (f"peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
            f" GiB" if device.type == "cuda" else "peak memory not measured")
    print(f"{tag}: first step {first_s:.1f}s, {t * 1000:.1f} ms/step -> "
          f"{1 / t:.2f} steps/s ({bsz * T / t:.1f} frames/s), {peak}",
          flush=True)
    return t


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batches", default="16,32",
                   help="batch sizes B of the B x 4 frame batches")
    p.add_argument("--steps", type=int, default=8,
                   help="timed steps after the first")
    args = add_common_args(p).parse_args(argv)
    device = resolve_device(args.device)
    hw, ae, disc = NARROW if args.narrow else (HW, AE, DISC)
    print(f"device: {describe_device(device)}", flush=True)
    return {(remat, b): measure(remat, b, args.steps, device, hw, ae, disc)
            for b in (int(v) for v in args.batches.split(","))
            for remat in (False, True)}


if __name__ == "__main__":
    main()
