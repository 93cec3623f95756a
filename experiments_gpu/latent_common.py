"""Shared frozen-autoencoder wiring for the latent forecasting experiments
on the PyTorch/CUDA port (counterpart of experiments/latent_common.py).

The reference loads a pretrained frozen VAE from a torch .pt and encodes every
batch with it (reference experiments/ae_s2/train.py:19-51,
pretrained_ae_linear_sevir/train.py). Here:
  * cfg.ae_kl.ckpt_path set   -> the torch checkpoint's state dict
    (training/checkpoint.load_torch_state_dict, `submodel` selecting a
    CasCast-format entry), loaded strictly: the port's AutoencoderKL has the
    reference's state-dict names
  * ckpt_path null            -> a seed-fixed random frozen VAE (hermetic
    smoke/demo mode; the latent geometry is identical). Its weights are
    drawn with numpy from `init_seed`, not JAX's jax.random.key(init_seed):
    the two packages' random VAEs differ.
Every GroupNorm of the frozen encode runs the Hopper GroupNorm+SiLU kernel on
the card (16 launches an encode at the reference width).
"""

from __future__ import annotations

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (  # noqa: E402
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (  # noqa: E402
    load_torch_state_dict)
from weatherforecastingtoolkit_tpu_torch.utils.device import DeviceLike  # noqa: E402


def build_frozen_vae(cfg, device: DeviceLike = None):
    """Returns (encode_apply(frames, rng) -> latents, encode_mode(frames),
    decode_apply(latents), latent_shape), the VAE on `device` (None: cuda).

    encode samples the posterior like the reference (ae_s2/train.py:36
    `.sample()`) with the caller's torch.Generator; decode is deterministic.
    """
    ae_cfg = cfg.ae_kl
    widths = tuple(ae_cfg.get("block_out_channels", [64, 128, 256, 512, 512]))
    vae = AutoencoderKL(
        in_channels=ae_cfg.get("in_channels", 1),
        out_channels=ae_cfg.get("out_channels", 1),
        block_out_channels=widths,
        layers_per_block=ae_cfg.get("layers_per_block", 1),
        latent_channels=ae_cfg.get("latent_channels", 64),
        norm_num_groups=ae_cfg.get("norm_num_groups", 32),
        device=device, seed=int(ae_cfg.get("init_seed", 7)))

    ckpt_path = ae_cfg.get("ckpt_path")
    if ckpt_path:
        sd = load_torch_state_dict(str(ckpt_path),
                                   submodel=ae_cfg.get("submodel"))
        vae.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                            strict=True)
        print(f"[frozen-vae] loaded torch checkpoint {ckpt_path}")
    else:
        print("[frozen-vae] no ckpt_path; using seed-fixed random frozen VAE")
    vae.requires_grad_(False).eval()

    hw = cfg.dataset.get("img_size", 128)
    n_down = len(widths) - 1
    latent_hw = hw // (2 ** n_down)
    latent_shape = (int(ae_cfg.get("latent_channels", 64)), latent_hw,
                    latent_hw)

    # trainer.mixed_precision: the frozen encoder is the latent experiments'
    # dominant compute — run it bf16 (latents come back fp32 for the
    # forecaster loss); decode stays fp32 (metric-grade eval path)
    if cfg.get("trainer", {}).get("mixed_precision", False):
        enc = copy.deepcopy(vae).to(torch.bfloat16)

        def encode_apply(frames, rng):
            return enc.encode(frames.to(torch.bfloat16)).sample(rng).float()

        def encode_mode(frames):
            return enc.encode(frames.to(torch.bfloat16)).mode().float()
    else:
        def encode_apply(frames, rng):
            return vae.encode(frames).sample(rng)

        def encode_mode(frames):
            return vae.encode(frames).mode()

    def decode_apply(latents):
        return vae.decode(latents)

    return encode_apply, encode_mode, decode_apply, latent_shape
