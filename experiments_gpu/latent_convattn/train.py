"""Second-stage attention latent AE on frozen-VAE latents, on the
PyTorch/CUDA port (counterpart of experiments/latent_convattn/train.py).

Capability of reference pretrained_ae_convattn_ae_sevir (ConvAttnModel on
4x48x48 latents + Huber, train.py:58-178). The frozen VAE's encode runs
every GroupNorm through the Hopper GroupNorm+SiLU kernel on the card.

    python experiments_gpu/latent_convattn/train.py dataset.sevir_dir=...
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from experiments_gpu.latent_common import build_frozen_vae  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.latent_ae import ConvAttnModel  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.tasks import (  # noqa: E402
    Task, dequantize, pixel_loss)


def build_task(cfg, dm=None, device=None) -> Task:
    """The Task of the config; the frozen VAE on ``device`` (None: cuda)."""
    encode_apply, _m, decode_apply, latent_shape = build_frozen_vae(
        cfg, device)
    c, h, w = latent_shape
    px = pixel_loss(cfg.get("loss", "huber"))

    def to_latents(batch, rng):
        x = dequantize(batch["vil"])
        b, t = x.shape[:2]
        with torch.no_grad():
            z = encode_apply(x.reshape((b * t,) + x.shape[2:]), rng)
        return z, (b, t)

    def init_params(seed, dev):
        return ConvAttnModel(in_channels=c, embed_dim=cfg.model.embed_dim,
                             nhead=cfg.model.nhead,
                             num_tf_layers=cfg.model.num_tf_layers,
                             latent_dim=cfg.model.latent_dim, grid=h // 4,
                             device=dev, seed=seed)

    def loss_fn(model, batch, rng, step):
        latents, _bt = to_latents(batch, rng)
        recon, _z = model(latents)
        return px(recon, latents), {}

    def eval_fn(model, batch, rng):
        latents, (b, t) = to_latents(batch, rng)
        with torch.no_grad():
            recon, _z = model(latents)
            dec_r = decode_apply(recon)
            dec_o = decode_apply(latents)
        return (dec_r.reshape((b, t) + dec_r.shape[1:]),
                dec_o.reshape((b, t) + dec_o.shape[1:]))

    return Task(name=cfg.experiment_name, init_params=init_params,
                loss_fn=loss_fn, eval_fn=eval_fn)


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
