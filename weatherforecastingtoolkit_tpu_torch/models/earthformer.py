"""Earthformer-style cuboid-attention nowcaster in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/earthformer.py).

(B, T_in, C, H, W) -> (B, T_out, C, H, W):
  * per-frame patch embedding -> (B, T, H', W', D) tokens plus a learned
    space-time position embedding;
  * cuboid blocks: full attention within (T x wh x ww) cuboids, alternating
    aligned and half-window-shifted tilings;
  * ``global_tokens=G``: G learned global vectors extend every cuboid's keys
    and values and cross-attend back over the whole token field each block;
  * ``hierarchy=2``: half the blocks run on a 2x2-merged grid at twice the
    width, expanded back and fused with a fine-scale skip;
  * learned horizon queries cross-attend per spatial site over the input
    time axis; two more cuboid blocks; a transposed-conv unpatchify; sigmoid,
    or with ``residual_out`` persistence-anchored deltas.

A flax module reads its token grid off the input at init; a torch module
needs it up front, so the constructor takes ``img_size``. Weights are drawn
from ``seed`` with flax's initializers (lecun-normal kernels, zero biases,
unit norms, N(0, 0.02) embeddings, a zero ``unpatch`` kernel under
``residual_out``). ``earthformer_state_dict_from_flax`` carries JAX-package
params across.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import lecun_normal_
from .transformer import (CrossAttention, SelfAttention, gelu,
                          init_flax_defaults, layer_norm,
                          transformer_state_dict_from_flax)


def _window_partition(x: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """(B, T, H, W, D) -> (B*nH*nW, T*wh*ww, D) cuboid token groups."""
    b, t, h, w, d = x.shape
    x = x.reshape(b, t, h // wh, wh, w // ww, ww, d)
    x = x.permute(0, 2, 4, 1, 3, 5, 6)  # B nH nW T wh ww D
    return x.reshape(b * (h // wh) * (w // ww), t * wh * ww, d)


def _window_merge(x: torch.Tensor, b: int, t: int, h: int, w: int,
                  wh: int, ww: int) -> torch.Tensor:
    d = x.shape[-1]
    x = x.reshape(b, h // wh, w // ww, t, wh, ww, d)
    x = x.permute(0, 3, 1, 4, 2, 5, 6)
    return x.reshape(b, t, h, w, d)


class CuboidBlock(nn.Module):
    """Pre-LN cuboid attention + FFN; optional half-window shift; with
    ``global_vectors`` the cuboids also attend to the globals, which then
    attend over the whole field (pre-LN + FFN)."""

    def __init__(self, dim: int, num_heads: int,
                 window: Tuple[int, int] = (4, 4), shifted: bool = False,
                 global_vectors: bool = False):
        super().__init__()
        self.window, self.shifted = tuple(window), shifted
        self.norm1 = layer_norm(dim)
        if global_vectors:
            self.g_norm = layer_norm(dim)
            self.attn = CrossAttention(dim, dim, num_heads)
        else:
            self.attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.ffn1 = nn.Linear(dim, 4 * dim)
        self.ffn2 = nn.Linear(4 * dim, dim)
        if global_vectors:
            self.g_attn = CrossAttention(dim, dim, num_heads)
            self.g_norm2 = layer_norm(dim)
            self.g_norm3 = layer_norm(dim)
            self.g_ffn1 = nn.Linear(dim, 4 * dim)
            self.g_ffn2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None):
        """x: (B, T, H, W, D); g: optional (B, G, D) global vectors.
        Returns x' (and g' when g is given)."""
        b, t, h, w, d = x.shape
        wh, ww = self.window
        sh, sw = (wh // 2, ww // 2) if self.shifted else (0, 0)

        hdn = self.norm1(x)
        if sh or sw:
            hdn = torch.roll(hdn, (-sh, -sw), dims=(2, 3))
        tokens = _window_partition(hdn, wh, ww)
        if g is not None:
            # cuboids read the globals: KV = [cuboid tokens ; globals]
            n_win = tokens.shape[0] // b
            gk = self.g_norm(g).repeat_interleave(n_win, dim=0)
            tokens = self.attn(tokens, torch.cat([tokens, gk], dim=1))
        else:
            tokens = self.attn(tokens)
        hdn = _window_merge(tokens, b, t, h, w, wh, ww)
        if sh or sw:
            hdn = torch.roll(hdn, (sh, sw), dims=(2, 3))
        x = x + hdn
        x = x + self.ffn2(gelu(self.ffn1(self.norm2(x))))
        if g is None:
            return x
        field = x.reshape(b, t * h * w, d)
        g = g + self.g_attn(self.g_norm2(g), field)
        g = g + self.g_ffn2(gelu(self.g_ffn1(self.g_norm3(g))))
        return x, g


class PatchMerge(nn.Module):
    """2x2 spatial merge -> wider channels (hierarchical downsample)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.norm1 = layer_norm(4 * in_dim)
        self.merge = nn.Linear(4 * in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, d = x.shape
        x = x.reshape(b, t, h // 2, 2, w // 2, 2, d)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, t, h // 2, w // 2, 4 * d)
        return self.merge(self.norm1(x))


class PatchExpand(nn.Module):
    """2x upsample (depth-to-space) -> narrower channels."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.out_dim = out_dim
        self.norm1 = layer_norm(in_dim)
        self.expand = nn.Linear(in_dim, 4 * out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, _ = x.shape
        x = self.expand(self.norm1(x)).reshape(b, t, h, w, 2, 2, self.out_dim)
        x = x.permute(0, 1, 2, 4, 3, 5, 6)
        return x.reshape(b, t, 2 * h, 2 * w, self.out_dim)


class Earthformer(nn.Module):
    """Cuboid-transformer nowcaster: (B, T_in, C, H, W) -> (B, T_out, C, H, W)."""

    def __init__(self, t_in: int = 13, t_out: int = 12, in_channels: int = 1,
                 patch: int = 8, dim: int = 128, depth: int = 4,
                 num_heads: int = 4, window: Sequence[int] = (4, 4),
                 sigmoid_head: bool = True, residual_out: bool = False,
                 hierarchy: int = 1, global_tokens: int = 0, *,
                 img_size: Union[int, Tuple[int, int]] = 128,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        hh, ww = ((img_size, img_size) if isinstance(img_size, int)
                  else tuple(img_size))
        gh, gw = hh // patch, ww // patch
        window = tuple(window)
        self.t_in, self.t_out, self.dim = t_in, t_out, dim
        self.in_channels, self.patch = in_channels, patch
        self.sigmoid_head, self.residual_out = sigmoid_head, residual_out
        self.hierarchy, self.global_tokens = hierarchy, global_tokens
        glob = global_tokens > 0

        self.patch_embed = nn.Conv2d(in_channels, dim, patch, stride=patch)
        self.st_pos = nn.Parameter(torch.empty(1, t_in, gh, gw, dim))
        if glob:
            self.global_init = nn.Parameter(torch.empty(1, global_tokens, dim))

        def blocks(n, d, heads, win):
            return nn.ModuleList(CuboidBlock(d, heads, win, bool(i % 2), glob)
                                 for i in range(n))

        if hierarchy <= 1:
            self.cuboid = blocks(depth, dim, num_heads, window)
        else:
            d_fine = max(1, depth // 2)
            d_coarse = max(1, depth - d_fine)
            self.cuboid = blocks(d_fine, dim, num_heads, window)
            self.down = PatchMerge(dim, 2 * dim)
            if glob:
                self.g_down = nn.Linear(dim, 2 * dim)
            cw = (min(window[0], gh // 2), min(window[1], gw // 2))
            self.coarse = blocks(d_coarse, 2 * dim, 2 * num_heads, cw)
            self.up = PatchExpand(2 * dim, dim)
            self.fuse = nn.Linear(2 * dim, dim)
        self.horizon_queries = nn.Parameter(torch.empty(1, t_out, 1, 1, dim))
        self.readout = CrossAttention(dim, dim, num_heads)
        self.dec_cuboid = nn.ModuleList(
            CuboidBlock(dim, num_heads, window, bool(i % 2)) for i in range(2))
        self.unpatch = nn.ConvTranspose2d(dim, in_channels, patch,
                                          stride=patch)
        self._init_weights(np.random.default_rng(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, rng: np.random.Generator) -> None:
        init_flax_defaults(self, rng)
        for p in (self.st_pos, getattr(self, "global_init", None),
                  self.horizon_queries):
            if p is not None:
                p.copy_(torch.from_numpy(rng.standard_normal(p.shape) * 0.02))
        # zero-init head under residual_out: the model starts exactly at
        # persistence; flax's fan_in of the (kh, kw, in, out) kernel otherwise
        if self.residual_out:
            self.unpatch.weight.zero_()
        else:
            lecun_normal_(self.unpatch.weight, rng,
                          fan_in=self.patch * self.patch * self.dim)
        self.unpatch.bias.zero_()

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        b, t, c, hh, wwd = frames.shape
        if t != self.t_in:
            raise ValueError(f"expected {self.t_in} input frames, got {t}")
        x = self.patch_embed(frames.reshape(b * t, c, hh, wwd))
        gh, gw = x.shape[2], x.shape[3]
        x = x.permute(0, 2, 3, 1).reshape(b, t, gh, gw, self.dim) + self.st_pos

        g = (self.global_init.expand(b, -1, -1) if self.global_tokens > 0
             else None)

        def run(x, g, blks):
            for blk in blks:
                if g is not None:
                    x, g = blk(x, g)
                else:
                    x = blk(x)
            return x, g

        x, g = run(x, g, self.cuboid)
        if self.hierarchy > 1:
            skip = x
            x = self.down(x)
            g = self.g_down(g) if g is not None else None
            x, g = run(x, g, self.coarse)
            x = self.fuse(torch.cat([self.up(x), skip], dim=-1))

        # horizon readout: per spatial site, T_out queries attend over T_in
        qf = self.horizon_queries.expand(b, -1, gh, gw, -1).permute(
            0, 2, 3, 1, 4).reshape(b * gh * gw, self.t_out, self.dim)
        kf = x.permute(0, 2, 3, 1, 4).reshape(b * gh * gw, self.t_in, self.dim)
        out = self.readout(qf, kf).reshape(b, gh, gw, self.t_out, self.dim
                                           ).permute(0, 3, 1, 2, 4)
        for blk in self.dec_cuboid:
            out = blk(out)

        # unpatchify per frame
        y = out.reshape(b * self.t_out, gh, gw, self.dim).permute(0, 3, 1, 2)
        y = self.unpatch(y).reshape(b, self.t_out, self.in_channels, hh, wwd)
        if self.residual_out:
            out = frames[:, -1:] + y
            if not self.sigmoid_head:
                return out
            # min(max(.)) as jnp.clip: at the bounds the gradient splits 0.5
            # each way. torch.clamp passes all of it, and at init (a zero
            # head) the output sits on the bounds wherever the frame is 0 or 1.
            zero, one = out.new_zeros(()), out.new_ones(())
            return torch.minimum(torch.maximum(out, zero), one)
        return torch.sigmoid(y) if self.sigmoid_head else y


def earthformer_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``Earthformer`` variables ``{'params': ...}`` (numpy arrays) ->
    this module's state dict, for ``load_state_dict(strict=True)``."""
    return transformer_state_dict_from_flax(params, conv_transpose=("unpatch",))
