"""Structured-latent conv AEs in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/legacy.py).

``StructuredConvAE`` keeps a spatial latent grid (``encode`` returns
(B, latent_channels, latent_hw, latent_hw)); with ``tf_depth > 0`` the
latent tokens pass through a ``CoordEmbedding`` and a post-LN transformer
on the encode side. Its Enc/DecBlocks are the port's (``models/common.py``,
flax's numerics). Weights are made from ``seed`` with flax's initializers
(N(0, 0.02) coordinate embedding); ``structured_conv_ae_state_dict_from_flax``
carries JAX-package params across.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import (DecBlock, EncBlock, init_flax_defaults, lecun_normal_,
                     normal_)
from .conv_ae import pos_aware_ae_state_dict_from_flax
from .transformer import TransformerEncoder


class CoordEmbedding(nn.Module):
    """Learned per-position embedding added to latent tokens."""

    def __init__(self, n_tokens: int, dim: int):
        super().__init__()
        self.coord = nn.Parameter(torch.zeros(1, n_tokens, dim))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return tokens + self.coord


class StructuredConvAE(nn.Module):
    def __init__(self, in_channels: int = 1, latent_channels: int = 64,
                 latent_hw: int = 8, groups: int = 8,
                 enc_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dec_channels: Sequence[int] = (1024, 1024, 512, 256, 128),
                 num_blocks: int = 4, tf_depth: int = 0, tf_heads: int = 8, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        lc, hw = latent_channels, latent_hw
        self.latent_channels, self.latent_hw = lc, hw
        self.tf_depth = tf_depth
        enc = tuple(enc_channels)
        dec = tuple(dec_channels)
        self.enc_blocks = nn.ModuleList(
            EncBlock(a, b, num_blocks, groups)
            for a, b in zip((in_channels,) + enc[:-1], enc))
        self.enc_out = nn.Conv2d(enc[-1], lc, 1)
        if tf_depth > 0:
            self.coord = CoordEmbedding(hw * hw, lc)
            self.latent_tf = TransformerEncoder(tf_depth, lc, tf_heads, 4 * lc)
        self.dec_in = nn.Conv2d(lc, dec[0], 1)
        self.dec_blocks = nn.ModuleList(
            DecBlock(a, b, num_blocks, groups) for a, b in zip(dec, dec[1:]))
        self.dec_out = nn.Conv2d(dec[-1], in_channels, 3, padding=1)
        rng = np.random.default_rng(seed)
        init_flax_defaults(self, rng)
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):      # flax (kh, kw, in, out)
                lecun_normal_(m.weight, rng, fan_in=m.weight[:, 0].numel())
        if tf_depth > 0:
            normal_(self.coord.coord, rng, 0.02)
        self.to(device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for blk in self.enc_blocks:
            h = blk(h)
        h = self.enc_out(h)
        if self.tf_depth > 0:
            b, lc, hw = h.shape[0], self.latent_channels, self.latent_hw
            tokens = h.permute(0, 2, 3, 1).reshape(b, hw * hw, lc)
            tokens = self.latent_tf(self.coord(tokens))
            h = tokens.reshape(b, hw, hw, lc).permute(0, 3, 1, 2)
        return h

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_in(z)
        for blk in self.dec_blocks:
            h = blk(h)
        return torch.sigmoid(self.dec_out(h))

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``deterministic`` is accepted for the reconstruction task's call
        and changes nothing: the model has no dropout."""
        z = self.encode(x)
        return self.decode(z), z


def structured_conv_ae_state_dict_from_flax(params: dict
                                            ) -> Dict[str, torch.Tensor]:
    """JAX ``StructuredConvAE`` variables ``{'params': ...}`` (numpy arrays)
    -> this module's state dict, for ``load_state_dict(strict=True)``. Its
    blocks, ``latent_tf`` and flax names follow ``PosAwareAE``'s rules."""
    return pos_aware_ae_state_dict_from_flax(params)
