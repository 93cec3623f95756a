"""Token-sequence Path-B on the PyTorch/CUDA port: a frozen ViT AE's token
latents and a transformer forecaster (counterpart of
experiments/token_vit/train.py).

``build_task(cfg, dm=None, vit=None)`` builds the Task from the experiment's
config (``experiments/token_vit/config.yaml``): frames become token
sequences through the frozen ``ViTAE`` (``make_vit``), a
``TokenSequenceForecaster`` learns to forecast them (latent MSE, dropout on
in training), and evaluation decodes the forecast tokens to frames clipped
to [0, 1]. The frozen ViTAE runs under ``torch.no_grad`` and gets no
gradient.

The ViTAE's weights come from ``vit_ae.ckpt_run_dir``, a run directory of
``experiments_gpu/ae_recon/train.py`` with ``model.name: vit_ae`` (its
newest checkpoint's params, through the port's checkpoint module), or,
when it is null, from ``vit_ae.init_seed`` (random, the hermetic mode). A
missing run, a run without checkpoints or one whose shapes differ from
the config's raises. The command line (``experiments_gpu/common.py::main``)
trains it from a SEVIR tree, on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from weatherforecastingtoolkit_tpu_torch.models.token_forecaster import (  # noqa: E402
    TokenSequenceForecaster)
from weatherforecastingtoolkit_tpu_torch.models.vit_ae import ViTAE  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (  # noqa: E402
    restore_params)
from weatherforecastingtoolkit_tpu_torch.training.tasks import Task, dequantize  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import DeviceLike  # noqa: E402


def make_vit(cfg, device: DeviceLike = None) -> ViTAE:
    """The frozen ViTAE of the config, no dropout, no gradients: the params
    of the newest checkpoint of ``vit_ae.ckpt_run_dir`` (an ae_recon run),
    else random weights from ``vit_ae.init_seed``."""
    v = cfg.vit_ae
    vit = ViTAE(img_size=v.img_size, patch=v.patch, d_token=v.d_token,
                d_latent=v.d_latent, depth_enc=v.depth_enc,
                depth_dec=v.depth_dec, heads=v.heads, dropout=0.0,
                device=device, seed=v.get("init_seed", 7))
    if v.get("ckpt_run_dir"):
        restore_params(str(v.ckpt_run_dir), vit)
        print(f"[token_vit] loaded frozen ViT AE from {v.ckpt_run_dir}")
    else:
        print("[token_vit] random frozen ViT AE (hermetic mode)")
    return vit.requires_grad_(False).eval()


def build_task(cfg, dm=None, device: DeviceLike = None,
               vit: ViTAE = None) -> Task:
    """The Task of the config; the frozen ViTAE (``make_vit``) on
    ``device`` (None: cuda) unless ``vit`` is given."""
    v = cfg.vit_ae
    t_in, t_out = cfg.dataset.input_frames, cfg.dataset.pred_frames
    vit = make_vit(cfg, device) if vit is None else vit
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


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
