"""Second-stage latent autoencoder on frozen-VAE latents, on the
PyTorch/CUDA port (counterpart of experiments/latent_convae/train.py).

Capability of reference pretrained_ae_convae_sevir (ConvModel + Huber,
train.py:155-178) and pretrained_ae_conv_disc (adds a PatchGAN in LATENT
space with its own optimizer/schedule, train.py:208-318) via lpips.enabled.
The frozen VAE's encode runs every GroupNorm through the Hopper
GroupNorm+SiLU kernel on the card, forward only.

    python experiments_gpu/latent_convae/train.py dataset.sevir_dir=... \\
        [lpips.enabled=true]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from experiments_gpu.latent_common import build_frozen_vae  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.latent_ae import ConvModel  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (  # noqa: E402
    NLayerDiscriminator)
from weatherforecastingtoolkit_tpu_torch.training.gan import make_vae_gan_task  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.optim import adam  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.tasks import (  # noqa: E402
    Task, dequantize, pixel_loss)


def build_task(cfg, dm=None, device=None) -> Task:
    """The Task of the config; the frozen VAE on ``device`` (None: cuda).
    Each step encodes its frames with a posterior sample drawn from the
    step's generator (``TrainState.rng``)."""
    encode_apply, _m, decode_apply, latent_shape = build_frozen_vae(
        cfg, device)
    c, h, w = latent_shape

    def new_model(seed, dev):
        return ConvModel(latent_dim=cfg.model.latent_dim, in_channels=c,
                         in_hw=h, device=dev, seed=seed)

    def frames_to_latents(batch, rng):
        x = dequantize(batch["vil"])
        b, t = x.shape[:2]
        with torch.no_grad():
            z = encode_apply(x.reshape((b * t,) + x.shape[2:]), rng)
        return z, (b, t)

    if cfg.lpips.get("enabled", False):
        ndf = cfg.lpips.get("disc_ndf", 64)
        task = make_vae_gan_task(
            name=cfg.experiment_name,
            generator_apply=lambda gen, latents, rng: (gen(latents)[1], None),
            gen_init=new_model,
            disc_apply=lambda d, f: d(f),
            disc_init=lambda seed, dev: NLayerDiscriminator(
                c, ndf, cfg.lpips.disc_num_layers, device=dev, seed=seed),
            disc_tx=adam(cfg.lpips.get("disc_lr", 4.5e-5), b1=0.5, b2=0.9),
            last_layer_path="decoder.conv_out.weight",
            pixel_loss=cfg.get("loss", "huber"),
            disc_weight=cfg.lpips.disc_weight,
            disc_factor=cfg.lpips.get("disc_factor", 1.0),
            disc_start=int(cfg.lpips.disc_start),
            disc_loss=cfg.lpips.get("disc_loss", "hinge"),
            mixed_precision=cfg.trainer.get("mixed_precision", False))

        # the GAN task consumes pixel batches; wrap its fns to encode first.
        # JAX folds the state's key (fold_in(state.rng, 1)); here the step's
        # generator draws the posterior noise and then serves the GAN step
        inner_step = task.custom_train_step
        inner_loss = task.loss_fn

        def custom_train_step(state, batch, tx):
            latents, _bt = frames_to_latents(batch, state.rng)
            return inner_step(state, {"vil": latents[:, None]}, tx)

        def loss_fn(params, batch, rng, step):
            latents, _bt = frames_to_latents(batch, rng)
            return inner_loss(params, {"vil": latents[:, None]}, rng, step)

        task.custom_train_step = custom_train_step
        task.loss_fn = loss_fn
        task.eval_fn = _make_eval(frames_to_latents, decode_apply, gan=True)
        return task

    px = pixel_loss(cfg.get("loss", "huber"))

    def loss_fn(model, batch, rng, step):
        latents, _bt = frames_to_latents(batch, rng)
        _z, recon = model(latents)
        return px(recon, latents), {}

    return Task(name=cfg.experiment_name, init_params=new_model,
                loss_fn=loss_fn,
                eval_fn=_make_eval(frames_to_latents, decode_apply, gan=False))


def _make_eval(frames_to_latents, decode_apply, gan):
    """Decoded reconstruction and decoded original, (B, T, C, H, W) each."""
    def eval_fn(model, batch, rng):
        latents, (b, t) = frames_to_latents(batch, rng)
        net = model.gen if gan else model
        with torch.no_grad():
            _z, recon = net(latents)  # ConvModel returns (z, recon)
            dec_recon = decode_apply(recon)
            dec_orig = decode_apply(latents)
        return (dec_recon.reshape((b, t) + dec_recon.shape[1:]),
                dec_orig.reshape((b, t) + dec_orig.shape[1:]))
    return eval_fn


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
