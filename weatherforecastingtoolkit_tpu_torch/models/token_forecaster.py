"""Token-sequence latent forecasters in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/token_forecaster.py).

``TokenSequenceForecaster``: factorised attention over ViT tokens, (B, T_in,
N, D) -> (B, T_out, N, D) in one shot. Each of ``depth`` pairs attends along
T at every token position (``time_i``), then across the tokens at every
step (``space_i``); learned horizon queries cross-attend into the history
(``readout``), anchored on the last input step's tokens.

``LatentTokenForecaster``: the same over a VAE latent grid with DLinear's
flat interface, (B, T_in, C*h*w) -> (B, T_out, C*h*w): the h*w positions
become tokens of C channels, embedded to ``d_model``; the zero-initialised
``unembed`` head makes the untrained model predict zero deltas.

Weights are made from ``seed`` with flax's initializers (N(0, 0.02)
position embeddings and queries); ``*_state_dict_from_flax`` carries
JAX-package params across.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import init_flax_defaults, normal_
from .transformer import (CrossAttention, TransformerEncoderLayer,
                          transformer_state_dict_from_flax)


class TokenSequenceForecaster(nn.Module):
    def __init__(self, t_in: int, t_out: int, d_token: int = 512,
                 num_heads: int = 8, depth: int = 2, dropout: float = 0.0, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.t_in, self.t_out, self.d_token = t_in, t_out, d_token
        self.depth = depth
        d = d_token
        self.time_pos = nn.Parameter(torch.empty(1, t_in, 1, d))
        for i in range(depth):
            self.add_module(f"time_{i}", TransformerEncoderLayer(
                d, num_heads, 4 * d, dropout))
            self.add_module(f"space_{i}", TransformerEncoderLayer(
                d, num_heads, 4 * d, dropout))
        self.horizon_queries = nn.Parameter(torch.empty(1, t_out, 1, d))
        self.readout = CrossAttention(d, d, num_heads)
        rng = np.random.default_rng(seed)
        init_flax_defaults(self, rng)
        normal_(self.time_pos, rng, 0.02)
        normal_(self.horizon_queries, rng, 0.02)
        self.to(device)

    def forward(self, tokens: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        """tokens: (B, T_in, N, D) -> (B, T_out, N, D)."""
        b, t, n, d = tokens.shape
        if t != self.t_in or d != self.d_token:
            raise ValueError(f"expected (B, {self.t_in}, N, {self.d_token}), "
                             f"got {tuple(tokens.shape)}")
        h = tokens + self.time_pos
        for i in range(self.depth):
            # time mixing: tokens folded into the batch, attention along T
            ht = h.transpose(1, 2).reshape(b * n, t, d)
            ht = getattr(self, f"time_{i}")(ht, deterministic=deterministic)
            h = ht.reshape(b, n, t, d).transpose(1, 2)
            # space mixing: time folded into the batch, attention over tokens
            hs = getattr(self, f"space_{i}")(h.reshape(b * t, n, d),
                                             deterministic=deterministic)
            h = hs.reshape(b, t, n, d)
        # per token position the horizon queries attend over the history
        qf = self.horizon_queries.expand(b, self.t_out, n, d).transpose(1, 2)
        qf = qf.reshape(b * n, self.t_out, d)
        kf = h.transpose(1, 2).reshape(b * n, t, d)
        out = self.readout(qf, kf).reshape(b, n, self.t_out, d).transpose(1, 2)
        return out + h[:, -1:]


class LatentTokenForecaster(nn.Module):
    def __init__(self, t_in: int, t_out: int,
                 latent_shape: Tuple[int, int, int], d_model: int = 128,
                 num_heads: int = 8, depth: int = 2, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.t_in, self.t_out = t_in, t_out
        self.latent_shape = tuple(latent_shape)
        c, h, w = self.latent_shape
        rng = np.random.default_rng(seed)
        self.embed = nn.Linear(c, d_model)
        self.space_pos = nn.Parameter(torch.empty(1, 1, h * w, d_model))
        self.unembed = nn.Linear(d_model, c)
        init_flax_defaults(self, rng)
        normal_(self.space_pos, rng, 0.02)
        with torch.no_grad():
            self.unembed.weight.zero_()
        self.core = TokenSequenceForecaster(
            t_in, t_out, d_model, num_heads, depth, device="cpu",
            seed=int(rng.integers(2**31)))
        self.to(device)

    def forward(self, z: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        b, t, d_flat = z.shape
        c, h, w = self.latent_shape
        if d_flat != c * h * w or t != self.t_in:
            raise ValueError(f"expected (B, {self.t_in}, {c * h * w}), got "
                             f"{tuple(z.shape)}")
        tokens = z.reshape(b, t, c, h * w).transpose(2, 3)     # (B, T, N, C)
        tokens = self.embed(tokens) + self.space_pos
        out = self.unembed(self.core(tokens, deterministic=deterministic))
        return out.transpose(2, 3).reshape(b, self.t_out, d_flat)


def token_forecaster_state_dict_from_flax(params: dict
                                          ) -> Dict[str, torch.Tensor]:
    """JAX ``TokenSequenceForecaster`` or ``LatentTokenForecaster``
    variables ``{'params': ...}`` (numpy arrays) -> the port module's state
    dict, for ``load_state_dict(strict=True)``."""
    return transformer_state_dict_from_flax(params)
