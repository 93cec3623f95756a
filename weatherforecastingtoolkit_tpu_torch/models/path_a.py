"""Path-A conv autoencoders in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/path_a.py): compress a frame to one
flat vector.

  * ``ResidualBlock``: 3x3 (strided) conv, GroupNorm, GELU, 3x3 conv,
    GroupNorm, a projected shortcut on a change of stride or width, GELU;
  * ``UpsampleBlock``: nearest 2x, then a ``ResidualBlock``;
  * ``ConvAutoencoder``: a stride-2 residual ladder to 1x1, Linear to the
    latent, and an upsample ladder back (sigmoid head);
  * ``AttentionChargedAutoencoder``: the conv ladder to a flat latent; a
    pre-LN transformer decoder whose learned position queries attend to the
    latent, then an upsample ladder.

NCHW at the API edge, as in JAX; GroupNorm with flax's eps (1e-6), GELU as
the tanh approximation. flax reads a Dense's input width off the input; a
torch layer needs it up front, so the encoders take ``img_size`` (128, the
frames the JAX defaults reduce to 1x1). Weights are made from ``seed`` with
flax's initializers; ``path_a_state_dict_from_flax`` carries JAX-package
params across.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import _num_groups, gelu, group_norm, init_flax_defaults, normal_
from .transformer import TransformerDecoder, transformer_state_dict_from_flax


class ResidualBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        g = _num_groups(out_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, stride=stride, padding=1,
                               bias=False)
        self.norm1 = group_norm(out_ch, g)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        self.norm2 = group_norm(out_ch, g)
        self.project = stride != 1 or in_ch != out_ch
        if self.project:
            # flax's 1x1 "SAME" conv pads nothing at an even size
            self.short_conv = nn.Conv2d(in_ch, out_ch, 1, stride=stride,
                                        bias=False)
            self.short_norm = group_norm(out_ch, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = gelu(self.norm1(self.conv1(x)))
        h = self.norm2(self.conv2(h))
        if self.project:
            x = self.short_norm(self.short_conv(x))
        return gelu(x + h)


class UpsampleBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, scale_factor: int = 2):
        super().__init__()
        self.scale_factor = scale_factor
        self.resblock = ResidualBlock(in_ch, out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an integer factor: output pixel i reads input pixel i // factor,
        # as jax.image.resize(method="nearest")
        x = F.interpolate(x, scale_factor=float(self.scale_factor),
                          mode="nearest")
        return self.resblock(x)


def _ladder(in_ch: int, channels: Sequence[int], strides: Sequence[int]):
    chans = (in_ch,) + tuple(channels)
    return nn.ModuleList(ResidualBlock(a, b, s) for a, b, s in
                         zip(chans, chans[1:], strides))


def _up_ladder(in_ch: int, channels: Sequence[int]):
    chans = (in_ch,) + tuple(channels)
    return nn.ModuleList(UpsampleBlock(a, b) for a, b in zip(chans, chans[1:]))


def _reduced(size: int, strides: Sequence[int]) -> int:
    for s in strides:
        size = (size - 1) // s + 1
    return size


class ConvAutoencoder(nn.Module):
    """Stride-2 residual ladder to 1x1, Linear bottleneck, upsample ladder.
    The defaults are the reference ConvAutoencoder (latent 1024)."""

    def __init__(self, in_channels: int = 1, latent_dim: int = 1024,
                 enc_channels: Sequence[int] = (64, 128, 256, 512, 1024,
                                                1024, 1024),
                 dec_channels: Sequence[int] = (512, 256, 128, 64, 64, 64, 64),
                 *, img_size: int = 128, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        enc = tuple(enc_channels)
        self.c_last = enc[-1]
        self.enc_blocks = _ladder(in_channels, enc, (2,) * len(enc))
        hw = _reduced(img_size, (2,) * len(enc))
        self.fc_enc = nn.Linear(enc[-1] * hw * hw, latent_dim)
        self.fc_dec = nn.Linear(latent_dim, enc[-1])
        self.dec_init = ResidualBlock(enc[-1], enc[-1])
        self.dec_blocks = _up_ladder(enc[-1], dec_channels)
        self.final_conv = nn.Conv2d(tuple(dec_channels)[-1], in_channels, 3,
                                    padding=1)
        init_flax_defaults(self, np.random.default_rng(seed))
        self.to(device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for blk in self.enc_blocks:
            h = blk(h)
        h = h.permute(0, 2, 3, 1)                         # flax's NHWC flatten
        return self.fc_enc(h.reshape(h.shape[0], -1))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.dec_init(self.fc_dec(z).reshape(z.shape[0], self.c_last,
                                                 1, 1))
        for blk in self.dec_blocks:
            h = blk(h)
        return torch.sigmoid(self.final_conv(h))

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``deterministic`` is accepted for the reconstruction task's call
        and changes nothing: the model has no dropout."""
        z = self.encode(x)
        return self.decode(z), z


class AttentionChargedAutoencoder(nn.Module):
    """Conv encoder -> flat latent; transformer-decoder queries rebuild the
    spatial grid from the latent, then an upsample ladder."""

    def __init__(self, in_channels: int = 1, latent_dim: int = 512,
                 initial_res: int = 8, embed_dim: int = 768,
                 num_heads: int = 12, num_layers: int = 6,
                 enc_channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 enc_strides: Sequence[int] = (2, 2, 2, 4, 4),
                 dec_channels: Sequence[int] = (512, 256, 128, 64), *,
                 img_size: int = 128, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        enc = tuple(enc_channels)
        self.initial_res, self.embed_dim = initial_res, embed_dim
        self.enc_blocks = _ladder(in_channels, enc, enc_strides)
        hw = _reduced(img_size, enc_strides)
        self.fc_enc = nn.Linear(enc[-1] * hw * hw, latent_dim)
        self.fc_dec = nn.Linear(latent_dim, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(
            1, initial_res * initial_res, embed_dim))
        self.decoder_tf = TransformerDecoder(num_layers, embed_dim, num_heads,
                                             4 * embed_dim, dropout=0.1)
        self.dec_blocks = _up_ladder(embed_dim, dec_channels)
        self.final_conv = nn.Conv2d(tuple(dec_channels)[-1], in_channels, 3,
                                    padding=1)
        rng = np.random.default_rng(seed)
        init_flax_defaults(self, rng)
        normal_(self.pos_embed, rng)
        self.to(device)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for blk in self.enc_blocks:
            h = blk(h)
        h = h.permute(0, 2, 3, 1)
        return self.fc_enc(h.reshape(h.shape[0], -1))

    def decode(self, z: torch.Tensor, deterministic: bool = True
               ) -> torch.Tensor:
        b, r = z.shape[0], self.initial_res
        memory = self.fc_dec(z)[:, None, :]
        queries = self.pos_embed.expand(b, *self.pos_embed.shape[1:])
        tokens = self.decoder_tf(queries, memory, deterministic=deterministic)
        h = tokens.reshape(b, r, r, self.embed_dim).permute(0, 3, 1, 2)
        for blk in self.dec_blocks:
            h = blk(h)
        return self.final_conv(h)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return self.decode(z, deterministic=deterministic), z


def path_a_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ConvAutoencoder`` or ``AttentionChargedAutoencoder`` variables
    ``{'params': ...}`` (numpy arrays) -> the port module's state dict, for
    ``load_state_dict(strict=True)``: flax's list members ``enc_blocks_<i>``
    become ``enc_blocks.<i>``."""
    out = transformer_state_dict_from_flax(params)
    return {_list_key(k): v for k, v in out.items()}


def _list_key(key: str) -> str:
    head, _, rest = key.partition(".")
    for prefix in ("enc_blocks_", "dec_blocks_"):
        if head.startswith(prefix):
            return f"{prefix[:-1]}.{head[len(prefix):]}.{rest}"
    return key
