"""GAN training throughput of the pixel-unshuffle (no full-resolution conv)
VAE on the PyTorch/CUDA port (counterpart of
experiments/perf/fast_vae_train.py).

The complete adversarial train step (reconstruction + KL + adaptive-weight
GAN, both optimizers; ``training/gan.py::make_vae_gan_task``) for the
reference-shape ``AutoencoderKL`` against the fast one, bf16 mixed
precision. Every ``GroupNormSiLU`` of the VAE runs the hand-written Hopper
GroupNorm+SiLU kernel in the forward; its backward is the autograd of the
kernel's plain version.

    python experiments_gpu/perf/fast_vae_train.py      # on the card

``build_step(vae_kwargs, mixed)`` returns (step, state, n_params) with
``step(state, batch) -> (state, aux)``; ``chip_smoke.py`` drives it.
"""

from __future__ import annotations

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (  # noqa: E402
    NLayerDiscriminator)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (  # noqa: E402
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.training.gan import (  # noqa: E402
    make_vae_gan_task)
from weatherforecastingtoolkit_tpu_torch.training.optim import (  # noqa: E402
    adam, adamw, count_params)
from weatherforecastingtoolkit_tpu_torch.training.trainer import (  # noqa: E402
    TrainState)
from weatherforecastingtoolkit_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)

# bench.py's constants (HW, LATENT_C, NORM_GROUPS)
HW, LATENT_C, NORM_GROUPS = 128, 64, 32
REFERENCE_SHAPE = dict(block_out_channels=(64, 128, 256, 512, 512))
FAST_SHAPE = dict(pixel_unshuffle=4, block_out_channels=(128, 256, 512))


def build_step(vae_kwargs, mixed=True, *, device=None, seed=0):
    """The two-optimizer VAE-GAN step on an ``AutoencoderKL(**vae_kwargs)``
    and ``NLayerDiscriminator(1, 64, 3)``: the generator's optimizer is
    clip 1.0 + AdamW(1e-4, weight decay 1e-4, optax's default), the
    discriminator's Adam(4.5e-5, 0.5, 0.9); kl_weight 1e-6, disc_weight
    0.5, disc_start 0. Returns (step, state, n_params)."""
    dev = resolve_device(device)

    def gen_init(s, d):
        return AutoencoderKL(in_channels=1, out_channels=1,
                             layers_per_block=1, latent_channels=LATENT_C,
                             norm_num_groups=NORM_GROUPS, **vae_kwargs,
                             device=d, seed=s)

    def generator_apply(vae, frames, rng):
        recon, posterior = vae(frames, sample_posterior=True, generator=rng,
                               return_posterior=True)
        return recon, posterior.kl()

    task = make_vae_gan_task(
        name="fast_vae_train", generator_apply=generator_apply,
        gen_init=gen_init, disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: NLayerDiscriminator(1, 64, 3, device=d,
                                                   seed=s),
        disc_tx=adam(4.5e-5, b1=0.5, b2=0.9),
        last_layer_path="decoder.conv_out.weight",
        kl_weight=1e-6, disc_weight=0.5, disc_start=0, mixed_precision=mixed)
    tx = adamw(1e-4, weight_decay=1e-4, grad_clip=1.0)
    params = task.init_params(seed, dev)
    state = TrainState(step=0, params=params,
                       opt_state=tx.init(list(params.parameters())),
                       rng=torch.Generator(device=dev).manual_seed(seed),
                       extra=task.init_extra(seed, params))
    return (lambda s, b: task.custom_train_step(s, b, tx)), state, \
        count_params(params)


def measure(tag, vae_kwargs, bsz, tsz=4):
    step, state, n_params = build_step(vae_kwargs)
    batch = {"vil": torch.from_numpy(np.random.default_rng(0).random(
        (bsz, tsz, 1, HW, HW), np.float32)).cuda()}
    t0 = time.perf_counter()
    state, aux = step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        state, aux = step(state, batch)
        float(aux["loss"])
        times.append(time.perf_counter() - t0)
    t_step = statistics.median(times)
    print(f"{tag} B={bsz}x{tsz} ({n_params / 1e6:.1f}M gen params): first "
          f"step {first_s:.1f}s, {t_step * 1000:.1f} ms/step -> "
          f"{1 / t_step:.2f} steps/s ({bsz * tsz / t_step:.1f} frames/s)",
          flush=True)
    return 1.0 / t_step


def main():
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    for bsz in (4, 16, 32):
        measure("reference-shape", REFERENCE_SHAPE, bsz)
        measure("fast (s2d stem)", FAST_SHAPE, bsz)


if __name__ == "__main__":
    main()
