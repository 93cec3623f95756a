"""Second-stage latent autoencoders in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/latent_ae.py): compress a frozen VAE's
spatial latent, (B, C, H, W) at the API edge.

  * ``ConvModel``: a stride-2 conv ladder (16x16 -> 1x1), a Linear to
    ``latent_dim``, and the mirrored transposed-conv ladder;
  * ``ConvAttnModel``: convs to a 12x12 token grid, a post-LN transformer
    encoder, attention pooling to one latent vector; learned decoder
    queries, a pre-LN transformer decoder, transposed convs back.

Two flax transposed-conv geometries, each torch's ``ConvTranspose2d`` with
the flax kernel flipped in both spatial axes, (in, out, kh, kw):
  * ``ConvTranspose(3, strides 2, "SAME")`` is ``padding=0`` keeping the
    first 2H rows and 2W columns (``padding=1, output_padding=1`` is
    another function: the window sits one pixel off);
  * ``ConvTranspose(4, strides 2, "SAME")`` is ``padding=1``.

flax reads a Dense's and a conv's input width off the input; a torch layer
needs it up front, so ``ConvModel`` takes the latent's ``in_hw`` (16).
Kernels use flax's ``he_normal`` where the JAX modules ask for it; the
position embeddings and queries are N(0, 1). Weights are made from ``seed``;
``*_state_dict_from_flax`` carries JAX-package params across.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import (gelu, group_norm, init_flax_defaults, lecun_normal_,
                     normal_)
from .transformer import (CrossAttention, TransformerDecoder,
                          TransformerEncoder, layer_norm,
                          transformer_state_dict_from_flax)


@torch.no_grad()
def _kaiming_(module: nn.Module, rng: np.random.Generator) -> None:
    """flax ``he_normal`` on a Linear, Conv2d or ConvTranspose2d (whose
    fan_in is (in, kh, kw) of its (in, out, kh, kw) weight)."""
    w = module.weight
    fan_in = w[:, 0].numel() if isinstance(module, nn.ConvTranspose2d) \
        else None
    lecun_normal_(w, rng, fan_in=fan_in, scale=2.0)
    if module.bias is not None:
        module.bias.zero_()


class SameConvTranspose3x3(nn.ConvTranspose2d):
    """flax ``ConvTranspose(3, strides 2, "SAME")``: exact 2x upsampling."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        return super().forward(x)[..., :2 * h, :2 * w]


class LatentConvEncoder(nn.Module):
    def __init__(self, latent_dim: int = 512,
                 channels: Sequence[int] = (128, 256, 512, 1024),
                 in_channels: int = 64, in_hw: int = 16):
        super().__init__()
        chans = (in_channels,) + tuple(channels)
        for i, (a, b) in enumerate(zip(chans, chans[1:])):
            self.add_module(f"conv_{i}", nn.Conv2d(a, b, 3, stride=2,
                                                   padding=1))
        self.n = len(channels)
        self.conv_out = nn.Conv2d(chans[-1], chans[-1], 1)
        hw = in_hw
        for _ in channels:
            hw = (hw - 1) // 2 + 1
        self.fc = nn.Linear(chans[-1] * hw * hw, latent_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.n):
            h = F.silu(getattr(self, f"conv_{i}")(h))
        h = self.conv_out(h).permute(0, 2, 3, 1)          # flax's NHWC flatten
        return self.fc(h.reshape(h.shape[0], -1))


class LatentConvDecoder(nn.Module):
    def __init__(self, out_channels: int = 64,
                 channels: Sequence[int] = (1024, 512, 256, 128),
                 latent_dim: int = 512):
        super().__init__()
        self.c0 = channels[0]
        self.fc = nn.Linear(latent_dim, channels[0])
        chans = (channels[0],) + tuple(channels)
        for i, (a, b) in enumerate(zip(chans, chans[1:])):
            self.add_module(f"deconv_{i}", SameConvTranspose3x3(a, b))
        self.n = len(channels)
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.fc(z).reshape(z.shape[0], self.c0, 1, 1)
        for i in range(self.n):
            h = F.silu(getattr(self, f"deconv_{i}")(h))
        return self.conv_out(h)


class ConvModel(nn.Module):
    """Latent-space AE: (B, 64, 16, 16) -> z (B, latent_dim) -> back."""

    def __init__(self, latent_dim: int = 512, in_channels: int = 64, *,
                 in_hw: int = 16, device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.encoder = LatentConvEncoder(latent_dim, in_channels=in_channels,
                                         in_hw=in_hw)
        self.decoder = LatentConvDecoder(in_channels, latent_dim=latent_dim)
        rng = np.random.default_rng(seed)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                _kaiming_(m, rng)
        self.to(device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encoder(x)
        return z, self.decoder(z)   # (z, recon), as the reference orders them


class ConvAttnModel(nn.Module):
    """Latent AE with positional attention instead of naive flattening."""

    def __init__(self, in_channels: int = 4, embed_dim: int = 128,
                 nhead: int = 8, num_tf_layers: int = 4,
                 latent_dim: int = 512, grid: int = 12, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        d, n_tok = embed_dim, grid * grid
        self.embed_dim, self.grid = embed_dim, grid
        self.enc_conv1 = nn.Conv2d(in_channels, 64, 3, stride=2, padding=1)
        self.enc_norm1 = group_norm(64, 8)
        self.enc_conv2 = nn.Conv2d(64, d, 3, stride=2, padding=1)
        self.enc_norm2 = group_norm(d, 8)
        self.enc_pos = nn.Parameter(torch.empty(1, n_tok, d))
        self.encoder_tf = TransformerEncoder(num_tf_layers, d, nhead, 4 * d)
        self.pool_q = nn.Parameter(torch.empty(1, 1, d))
        self.attention_pool = CrossAttention(d, d, nhead)
        self.head_norm = layer_norm(d)
        self.head_fc = nn.Linear(d, latent_dim)
        self.decoder_head = nn.Linear(latent_dim, d)
        self.dec_q = nn.Parameter(torch.empty(1, n_tok, d))
        self.dec_pos = nn.Parameter(torch.empty(1, n_tok, d))
        self.decoder_tf = TransformerDecoder(num_tf_layers, d, nhead, 4 * d)
        self.dec_deconv1 = nn.ConvTranspose2d(d, 64, 4, stride=2, padding=1)
        self.dec_norm1 = group_norm(64, 8)
        self.dec_deconv2 = nn.ConvTranspose2d(64, in_channels, 4, stride=2,
                                              padding=1)
        rng = np.random.default_rng(seed)
        init_flax_defaults(self, rng)
        for m in (self.enc_conv1, self.enc_conv2, self.head_fc,
                  self.decoder_head, self.dec_deconv1, self.dec_deconv2):
            _kaiming_(m, rng)
        for p in (self.enc_pos, self.pool_q, self.dec_q, self.dec_pos):
            normal_(p, rng)
        self.to(device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = gelu(self.enc_norm1(self.enc_conv1(x)))
        h = gelu(self.enc_norm2(self.enc_conv2(h)))
        tokens = h.permute(0, 2, 3, 1).reshape(b, -1, self.embed_dim)
        context = self.encoder_tf(tokens + self.enc_pos)
        pooled = self.attention_pool(self.pool_q.expand(b, 1, self.embed_dim),
                                     context)
        return self.head_fc(self.head_norm(pooled))[:, 0]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        b = z.shape[0]
        memory = self.decoder_head(z)[:, None, :]
        q = self.dec_q.expand(b, *self.dec_q.shape[1:]) + self.dec_pos
        patches = self.decoder_tf(q, memory)
        h = patches.reshape(b, self.grid, self.grid, self.embed_dim)
        h = gelu(self.dec_norm1(self.dec_deconv1(h.permute(0, 3, 1, 2))))
        return self.dec_deconv2(h)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return self.decode(z), z


_DECONVS = ("deconv_0", "deconv_1", "deconv_2", "deconv_3", "dec_deconv1",
            "dec_deconv2")


def latent_ae_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ConvModel`` or ``ConvAttnModel`` variables ``{'params': ...}``
    (numpy arrays) -> the port module's state dict, for
    ``load_state_dict(strict=True)``. ``ConvModel``'s encoder ``fc`` reads
    the flattened grid in flax's (h, w, c) order, as the port flattens it."""
    return transformer_state_dict_from_flax(params, conv_transpose=_DECONVS)
