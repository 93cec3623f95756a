"""Token-sequence Path-B on the PyTorch/CUDA port: a frozen ViT AE's token
latents and a transformer forecaster (counterpart of
experiments/token_vit/train.py).

``build_task(cfg, dm=None, vit=None)`` builds the Task from the experiment's
config (``experiments/token_vit/config.yaml``): frames become token
sequences through the frozen ``ViTAE`` (``make_vit``: random weights from
``vit_ae.init_seed``, the hermetic mode, on the card unless another device
is given), a ``TokenSequenceForecaster`` learns to forecast them (latent
MSE, dropout on in training), and evaluation decodes the forecast tokens
to frames clipped to [0, 1]. The frozen ViTAE runs under ``torch.no_grad``
and gets no gradient.

Not here yet: loading the ViTAE from a run directory
(``vit_ae.ckpt_run_dir``; the JAX experiment restores a JAX checkpoint)
raises. The command-line entry point waits for the port's data slice, as
experiments_gpu/earthformer/train.py says.
"""

from __future__ import annotations

import torch

from weatherforecastingtoolkit_tpu_torch.models.token_forecaster import (
    TokenSequenceForecaster)
from weatherforecastingtoolkit_tpu_torch.models.vit_ae import ViTAE
from weatherforecastingtoolkit_tpu_torch.training.tasks import Task, dequantize
from weatherforecastingtoolkit_tpu_torch.utils.device import DeviceLike


def make_vit(cfg, device: DeviceLike = None) -> ViTAE:
    """The frozen ViTAE of the config: random weights from
    ``vit_ae.init_seed``, no dropout, no gradients."""
    v = cfg.vit_ae
    if v.get("ckpt_run_dir"):
        raise NotImplementedError(
            "loading the frozen ViTAE from vit_ae.ckpt_run_dir is not ported "
            "yet; leave it null for the random frozen ViTAE")
    vit = ViTAE(img_size=v.img_size, patch=v.patch, d_token=v.d_token,
                d_latent=v.d_latent, depth_enc=v.depth_enc,
                depth_dec=v.depth_dec, heads=v.heads, dropout=0.0,
                device=device, seed=v.get("init_seed", 7))
    return vit.requires_grad_(False).eval()


def build_task(cfg, dm=None, vit: ViTAE = None) -> Task:
    v = cfg.vit_ae
    t_in, t_out = cfg.dataset.input_frames, cfg.dataset.pred_frames
    vit = make_vit(cfg) if vit is None else vit
    n_tok = vit.n_patches

    def encode_seq(x):
        b, t = x.shape[:2]
        with torch.no_grad():
            tokens = vit.encode_tokens(x.reshape((b * t,) + x.shape[2:]))
        return tokens.reshape(b, t, n_tok, v.d_token)

    def decode_seq(tokens):
        b, t = tokens.shape[:2]
        with torch.no_grad():
            frames = vit.decode_tokens(tokens.reshape(b * t, n_tok,
                                                      v.d_token))
        return frames.reshape((b, t) + frames.shape[1:])

    def init_params(seed, device):
        return TokenSequenceForecaster(
            t_in=t_in, t_out=t_out, d_token=v.d_token,
            num_heads=cfg.forecaster.num_heads, depth=cfg.forecaster.depth,
            device=device, seed=seed)

    def split(batch):
        x = dequantize(batch["vil"])
        return x[:, :t_in], x[:, t_in:t_in + t_out]

    def loss_fn(model, batch, rng, step):
        frames_in, frames_gt = split(batch)
        z = encode_seq(torch.cat([frames_in, frames_gt], dim=1))
        pred = model(z[:, :t_in], deterministic=False)
        return torch.mean((pred - z[:, t_in:]) ** 2), {}

    def eval_fn(model, batch, rng):
        frames_in, frames_gt = split(batch)
        with torch.no_grad():
            pred_tokens = model(encode_seq(frames_in))
        return torch.clamp(decode_seq(pred_tokens), 0.0, 1.0), frames_gt

    return Task(name=cfg.experiment_name, init_params=init_params,
                loss_fn=loss_fn, eval_fn=eval_fn)
