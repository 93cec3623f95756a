"""ViT autoencoder with a global cross-attention bottleneck, in PyTorch
(counterpart of weatherforecastingtoolkit_tpu/models/vit_ae.py).

patch x patch embedding -> n_patches tokens of d_token (+ learned position
embedding) -> transformer encoder -> cross-attention collapse to one
d_latent vector -> cross-attention expansion back to n_patches tokens ->
transformer decoder -> transposed-conv unpatchify.

The unpatchify is flax's ``ConvTranspose(patch, strides=patch, "VALID")``:
torch's ``ConvTranspose2d(patch, stride=patch)`` with the flax kernel
flipped in both spatial axes, as Earthformer's ``unpatch``. Dropout (0.1 by
default) is active only when a caller passes ``deterministic=False``.
Weights are made from ``seed`` with flax's initializers (N(0, 1) position
embeddings and queries); ``vit_ae_state_dict_from_flax`` carries JAX-package
params across.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import init_flax_defaults, lecun_normal_, normal_
from .transformer import (CrossAttention, TransformerEncoder,
                          transformer_state_dict_from_flax)


class ViTAE(nn.Module):
    def __init__(self, img_size: int = 128, patch: int = 16,
                 in_channels: int = 1, d_token: int = 512,
                 d_latent: int = 2048, depth_enc: int = 6, depth_dec: int = 6,
                 heads: int = 8, dropout: float = 0.1, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.img_size, self.patch = img_size, patch
        self.d_token, self.d_latent = d_token, d_latent
        n = self.n_patches
        self.patch_embed = nn.Conv2d(in_channels, d_token, patch, stride=patch)
        self.pos_embed = nn.Parameter(torch.empty(1, n, d_token))
        self.encoder = TransformerEncoder(depth_enc, d_token, heads,
                                          4 * d_token, dropout)
        self.query_vec = nn.Parameter(torch.empty(1, 1, d_latent))
        self.to_latent = CrossAttention(d_latent, d_token, heads)
        self.dec_queries = nn.Parameter(torch.empty(1, n, d_token))
        self.from_latent = CrossAttention(d_token, d_latent, heads)
        self.decoder = TransformerEncoder(depth_dec, d_token, heads,
                                          4 * d_token, dropout)
        self.unpatch = nn.ConvTranspose2d(d_token, in_channels, patch,
                                          stride=patch)
        self._init_weights(np.random.default_rng(seed))
        self.to(device)

    @property
    def grid(self) -> int:
        return self.img_size // self.patch

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid

    @torch.no_grad()
    def _init_weights(self, rng: np.random.Generator) -> None:
        init_flax_defaults(self, rng)
        w = self.unpatch.weight                      # flax (kh, kw, in, out)
        lecun_normal_(w, rng, fan_in=w[:, 0].numel())
        self.unpatch.bias.zero_()
        for p in (self.pos_embed, self.query_vec, self.dec_queries):
            normal_(p, rng)

    def _unpatchify(self, z: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        z = z.reshape(b, self.grid, self.grid, self.d_token).permute(0, 3, 1, 2)
        return self.unpatch(z)

    def encode_tokens(self, x: torch.Tensor, deterministic: bool = True
                      ) -> torch.Tensor:
        """(B, C, H, W) -> token latent (B, n_patches, d_token)."""
        z = self.patch_embed(x)                               # (B, d, g, g)
        z = z.permute(0, 2, 3, 1).reshape(x.shape[0], self.n_patches,
                                          self.d_token)
        return self.encoder(z + self.pos_embed, deterministic=deterministic)

    def decode_tokens(self, tokens: torch.Tensor, deterministic: bool = True
                      ) -> torch.Tensor:
        """(B, n_patches, d_token) -> (B, C, H, W)."""
        z = self.decoder(tokens + self.pos_embed, deterministic=deterministic)
        return self._unpatchify(z)

    def encode(self, x: torch.Tensor, deterministic: bool = True
               ) -> torch.Tensor:
        """(B, C, H, W) -> (B, d_latent)."""
        z = self.encode_tokens(x, deterministic=deterministic)
        q = self.query_vec.expand(x.shape[0], 1, self.d_latent)
        return self.to_latent(q, z)[:, 0]

    def decode(self, latent: torch.Tensor, deterministic: bool = True
               ) -> torch.Tensor:
        """(B, d_latent) -> (B, C, H, W)."""
        b = latent.shape[0]
        dec_q = self.dec_queries.expand(b, self.n_patches, self.d_token)
        z = self.from_latent(dec_q, latent[:, None, :])
        return self.decode_tokens(z, deterministic=deterministic)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        latent = self.encode(x, deterministic=deterministic)
        return self.decode(latent, deterministic=deterministic), latent


def vit_ae_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ViTAE`` variables ``{'params': ...}`` (numpy arrays) -> this
    module's state dict, for ``load_state_dict(strict=True)``."""
    return transformer_state_dict_from_flax(params, conv_transpose=("unpatch",))
