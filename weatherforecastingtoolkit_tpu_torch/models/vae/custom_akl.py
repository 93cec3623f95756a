"""Path-A VAE with a flat "timeseries" bottleneck, in PyTorch (counterpart
of weatherforecastingtoolkit_tpu/models/vae/custom_akl.py).

``encode(x)`` gives the posterior over the (latent_channels, latent_hw,
latent_hw) grid; ``forward`` adds the fixed 2-D sin/cos embedding, projects
the flattened grid to a ``timeseries_dim`` vector and back
(``to_timeseries``/``from_timeseries``), decodes, and returns
(reconstruction, z_timeseries, posterior). ``decode`` takes the grid or a
flat vector.

The Encoder/Decoder are the port's (``vae.py``), so every GroupNorm+SiLU
runs the Hopper kernel on a CUDA tensor. ``scales`` picks the stacked 4x
resamplers per block and ``remat`` recomputes each block in the backward,
as in JAX. Activations and conv weights are ``channels_last``, as in
``AutoencoderKL``; weights are made from ``seed`` with flax's initializers,
and ``state_dict_from_flax`` (the ``AutoencoderKL`` one: the names follow
the same rules) carries JAX-package params across. The embedding is a
non-persistent buffer, recomputed, as the JAX module recomputes it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...ops.quant import QConv
from ...utils.device import DeviceLike, resolve_device
from .autoencoder_kl import (flax_path, init_vae_weights,  # noqa: F401
                             state_dict_from_flax)
from .blocks import Downsample4x, Upsample4x  # noqa: F401 (public re-export)
from .distributions import DiagonalGaussianDistribution
from .vae import Decoder, Encoder

_CL = torch.channels_last


def sinusoidal_pos_emb_2d(channels: int, height: int, width: int) -> np.ndarray:
    """(1, C, H, W) 2-D sin/cos embedding, channels laid out
    [y_sin | y_cos | x_sin | x_cos]."""
    if channels % 4 != 0:
        raise ValueError("Channels must be divisible by 4 for 2D sinusoidal embeddings.")
    cq = channels // 4
    inv_freq = 1.0 / (10000 ** (np.arange(cq, dtype=np.float32) / cq))
    pos_y = np.arange(height, dtype=np.float32)[:, None] * inv_freq[None]
    pos_x = np.arange(width, dtype=np.float32)[:, None] * inv_freq[None]
    y_emb = np.concatenate([np.sin(pos_y), np.cos(pos_y)], axis=1)   # (H, C/2)
    x_emb = np.concatenate([np.sin(pos_x), np.cos(pos_x)], axis=1)   # (W, C/2)
    y_full = np.repeat(y_emb[:, None, :], width, axis=1)             # (H, W, C/2)
    x_full = np.repeat(x_emb[None, :, :], height, axis=0)            # (H, W, C/2)
    emb = np.concatenate([y_full, x_full], axis=2)                   # (H, W, C)
    return emb.transpose(2, 0, 1)[None]                              # (1, C, H, W)


class CustomAutoencoderKL(nn.Module):
    """VAE whose user-facing latent is a flat timeseries vector."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512, 512),
                 layers_per_block: int = 1, latent_channels: int = 64,
                 norm_num_groups: int = 32, latent_hw: int = 8,
                 timeseries_dim: int = 2048,
                 scales: Optional[Sequence[int]] = None,
                 remat: bool = False, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.latent_channels, self.latent_hw = latent_channels, latent_hw
        # the encoder downsamples after blocks 0..n-2 with scales[i]; the
        # decoder's up block j inverts encoder block n-2-j
        dec_scales = None
        if scales:
            s = tuple(scales)
            dec_scales = tuple(reversed(s[:-1])) + s[-1:]
        grid = latent_channels * latent_hw * latent_hw
        with torch.device("meta"):  # shapes only; weights are made below
            self.encoder = Encoder(
                in_channels, latent_channels, block_out_channels,
                layers_per_block, norm_num_groups, double_z=True,
                scales=scales, remat=remat)
            self.decoder = Decoder(
                latent_channels, out_channels, block_out_channels,
                layers_per_block, norm_num_groups, scales=dec_scales,
                remat=remat)
            self.quant_conv = nn.Conv2d(2 * latent_channels,
                                        2 * latent_channels, 1)
            self.post_quant_conv = nn.Conv2d(latent_channels,
                                             latent_channels, 1)
            self.to_timeseries = nn.Linear(grid, timeseries_dim)
            self.from_timeseries = nn.Linear(timeseries_dim, grid)
        self.to_empty(device="cpu")
        init_vae_weights(self, np.random.default_rng(seed))
        self.register_buffer("pe", torch.from_numpy(sinusoidal_pos_emb_2d(
            latent_channels, latent_hw, latent_hw)), persistent=False)
        self.to(device=device, memory_format=_CL)
        for name, m in self.named_modules():
            if isinstance(m, QConv):
                m.set_path(flax_path(name))

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        h = self.encoder(x.contiguous(memory_format=_CL))
        return DiagonalGaussianDistribution(self.quant_conv(h))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Takes the latent grid or a flat vector (reshaped to the grid)."""
        z = z.reshape(z.shape[0], self.latent_channels, self.latent_hw,
                      self.latent_hw)
        return self.decoder(self.post_quant_conv(
            z.contiguous(memory_format=_CL)))

    def forward(self, x: torch.Tensor, sample_posterior: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor,
                           DiagonalGaussianDistribution]:
        posterior = self.encode(x)
        z2d = posterior.sample(generator) if sample_posterior \
            else posterior.mode()
        z2d = z2d + self.pe.to(z2d.dtype)
        z_ts = self.to_timeseries(z2d.reshape(z2d.shape[0], -1))
        recon = self.decode(self.from_timeseries(z_ts))
        return recon, z_ts, posterior
