"""Adversarial frame-autoencoder experiment (conv AE or VAE + PatchGAN) on
the PyTorch/CUDA port (counterpart of experiments/ae_gan/train.py).

Capability of the reference's ae_v2_2 (PosAwareAE + hinge GAN + adaptive
weight, experiments/ae_v2_2/train.py:31-159) and — with model.name
autoencoder_kl + lpips.kl_weight set — ae_gan_kl / LPIPSWithDiscriminator
(autoencoderkl/losses/contperceptual.py:33-169). The same ``build_task``
serves experiments_gpu/vae_gan_kl and experiments_gpu/vae_sevir384: an
``AutoencoderKL`` generator runs every GroupNorm through the Hopper
GroupNorm+SiLU kernel on the card (its backward is the plain version's
autograd).

    python experiments_gpu/ae_gan/train.py dataset.sevir_dir=... \\
        dataset.use_cache=true
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (  # noqa: E402
    NLayerDiscriminator)
from weatherforecastingtoolkit_tpu_torch.models.registry import build_model  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.gan import make_vae_gan_task  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.optim import adam  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.trainer import Task  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import (  # noqa: E402
    DeviceLike, resolve_device)


def make_lpips(cfg, device: DeviceLike = None):
    """The perceptual (LPIPS) term of the config, or None when
    ``lpips.perceptual_weight`` is 0: reference losses/contperceptual.py:
    103-106, whose weights are downloaded there (losses/util.py:5-45); here
    they are user-provided torch files (``lpips.vgg_path``/``lin_path``),
    else random LPIPS weights with a warning (wiring smoke only)."""
    if float(cfg.lpips.get("perceptual_weight", 0.0)) <= 0:
        return None
    from weatherforecastingtoolkit_tpu_torch.models.losses.lpips import (
        LPIPS, lpips_state_dict_from_torch)

    lpips = LPIPS(device=device)
    vgg_path = cfg.lpips.get("vgg_path", None)
    lin_path = cfg.lpips.get("lin_path", None)
    if vgg_path and lin_path:
        from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
            load_torch_state_dict)
        lpips.load_state_dict(lpips_state_dict_from_torch(
            load_torch_state_dict(str(vgg_path)),
            load_torch_state_dict(str(lin_path))))
        print(f"[lpips] loaded VGG weights from {vgg_path}")
    else:
        print("[lpips] WARNING: perceptual_weight > 0 but no "
              "lpips.vgg_path/lin_path — using randomly initialized LPIPS "
              "(wiring smoke only; provide torch weight files for a real "
              "perceptual loss)")
    return lpips.requires_grad_(False)


def build_task(cfg, dm=None, device: DeviceLike = None) -> Task:
    """The VAE-GAN Task of the config; the generator and the discriminator
    are built on the trainer's device, the LPIPS network (if any) on
    ``device`` (None: cuda)."""
    kwargs = {k: v for k, v in cfg.model.items() if k != "name"}
    is_vae = cfg.model.name == "autoencoder_kl"

    if is_vae:
        def generator_apply(gen, frames, rng):
            recon, posterior = gen(frames, sample_posterior=True,
                                   generator=rng, return_posterior=True)
            return recon, posterior.kl()
        last_layer = "decoder.conv_out.weight"

        def eval_apply(gen, frames):
            return gen(frames)
    else:
        def generator_apply(gen, frames, rng):
            recon, _z = gen(frames)
            return recon, None
        last_layer = "dec_out.weight"

        def eval_apply(gen, frames):
            return gen(frames)[0]

    def gen_init(seed, dev):
        return build_model(cfg.model.name, **kwargs, device=dev, seed=seed)

    ndf = cfg.lpips.get("disc_ndf", 64)

    def disc_init(seed, dev):
        return NLayerDiscriminator(1, ndf, cfg.lpips.disc_num_layers,
                                   device=dev, seed=seed)

    lpips = make_lpips(cfg, resolve_device(device))
    return make_vae_gan_task(
        name=cfg.experiment_name,
        generator_apply=generator_apply,
        gen_init=gen_init,
        disc_apply=lambda d, f: d(f),
        disc_init=disc_init,
        disc_tx=adam(cfg.lpips.get("disc_lr", 4.5e-5), b1=0.5, b2=0.9),
        last_layer_path=last_layer,
        eval_apply=eval_apply,
        recon_weight=cfg.lpips.get("recon_weight", 1.0),
        perceptual_apply=lpips,
        perceptual_weight=cfg.lpips.get("perceptual_weight", 0.0),
        # weight-free perceptual term (PatchGAN feature matching) — fills the
        # role the reference's LPIPS plays (contperceptual.py:103-106)
        # without pretrained VGG weights; on by default via config
        disc_feats_apply=lambda d, f: d(f, return_features=True),
        feature_matching_weight=cfg.lpips.get("feature_matching_weight", 0.0),
        kl_weight=cfg.lpips.get("kl_weight", None),
        disc_weight=cfg.lpips.disc_weight,
        disc_factor=cfg.lpips.get("disc_factor", 1.0),
        disc_start=int(cfg.lpips.disc_start),
        disc_loss=cfg.lpips.get("disc_loss", "hinge"),
        mixed_precision=cfg.trainer.get("mixed_precision", False))


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
