"""Building blocks, layout helpers and parameter init shared by the port's
models (counterpart of weatherforecastingtoolkit_tpu/models/common.py).

``space_to_depth``/``depth_to_space`` keep the JAX package's channel order,
``(u*f + v)*C + c`` for subpixel (u, v), so fast-VAE weights transfer between
the two packages. ``torch.nn.functional.pixel_unshuffle`` orders channels as
``c*f*f + u*f + v`` and must not be used in their place.

The conv-AE blocks (``Bottleneck``, ``EncBlock``, ``DecBlock``) run NCHW
with flax's numerics: GroupNorm with eps 1e-6 (``F.group_norm``, the
library's, as flax's ``nn.GroupNorm`` is XLA's in JAX), GELU as the tanh
approximation, and ``DecBlock``'s transposed conv with the geometry of
flax's ``ConvTranspose(4, stride 2, "SAME")``: torch's ``padding=1``, its
weight the flax kernel flipped in both spatial axes, (in, out, kh, kw).
Their parameters are made by the model that holds them
(``init_flax_defaults``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

# flax's lecun_normal: a normal truncated to [-2, 2] whose std is corrected
# back to sqrt(1 / fan_in) (jax.nn.initializers.variance_scaling).
_TRUNC_STD = 0.87962566103423978


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def space_to_depth(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Lossless (N, H, W, C) -> (N, H/f, W/f, f*f*C) repack; channel index
    (u*f + v)*C + c for subpixel (u, v)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h // factor, w // factor, factor * factor * c)


def depth_to_space(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    n, h, w, cf = x.shape
    c = cf // (factor * factor)
    x = x.reshape(n, h, w, factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        n, h * factor, w * factor, c)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, rng: np.random.Generator,
                  fan_in: Optional[int] = None,
                  scale: float = 1.0) -> torch.Tensor:
    """flax's default kernel init on a torch (out, in, ...) weight: fan_in
    is everything but the leading output axis unless given (a transposed
    conv's weight is (in, out, kh, kw)); ``scale=2`` gives flax's
    ``he_normal``. The draw comes from numpy, so a seed
    gives the same weights under every torch version (torch's own
    ``trunc_normal_`` changed its sampler between versions)."""
    v = rng.standard_normal(weight.shape)
    # truncate at two sigma by redrawing, in index order (the values of a
    # redraw of the whole array's out-of-range mask, each round), testing
    # again only the values just drawn
    flat = v.reshape(-1)
    idx = np.flatnonzero(np.abs(flat) > 2.0)
    while idx.size:
        flat[idx] = rng.standard_normal(idx.size)
        idx = idx[np.abs(flat[idx]) > 2.0]
    v *= (scale / (fan_in or weight[0].numel())) ** 0.5 / _TRUNC_STD
    return weight.copy_(torch.from_numpy(v))


@torch.no_grad()
def normal_(param: torch.Tensor, rng: np.random.Generator,
            std: float = 1.0) -> torch.Tensor:
    """flax ``initializers.normal(std)`` (embeddings, queries), drawn with
    numpy."""
    return param.copy_(torch.from_numpy(rng.standard_normal(param.shape) * std))


@torch.no_grad()
def init_flax_defaults(module: nn.Module, rng: np.random.Generator) -> None:
    """flax's defaults: lecun-normal Dense/Conv kernels, zero biases, unit
    LayerNorm and GroupNorm scales. Parameters owned directly by a module
    (embeddings) and transposed convs (whose fan_in the holder knows) are
    left to it."""
    for m in module.modules():
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, (nn.Linear, nn.Conv2d)):
            lecun_normal_(m.weight, rng)
            if m.bias is not None:
                m.bias.zero_()


def _call_block(blk: nn.Module, params, x: torch.Tensor) -> torch.Tensor:
    return functional_call(blk, params, (x,))


def run_blocks(blocks, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """Apply blocks in turn; with ``remat`` while autograd records, each one
    under a non-reentrant ``torch.utils.checkpoint`` (its activations
    recomputed in the backward, as flax's ``nn.remat``). The recompute runs
    the block on the parameter tensors its forward saw: under
    ``ops/amp.py::cast_call`` those are bf16 copies that exist only during
    the call, and the backward comes after it."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(_call_block, blk, dict(blk.named_parameters()), x,
                           use_reentrant=False)
        else:
            x = blk(x)
    return x


def _num_groups(channels: int, preferred: int = 8) -> int:
    g = min(preferred, channels)
    while channels % g:
        g -= 1
    return g


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def group_norm(channels: int, num_groups: int) -> nn.GroupNorm:
    """flax ``nn.GroupNorm(num_groups)``: eps 1e-6, learned scale and bias."""
    return nn.GroupNorm(num_groups, channels, eps=1e-6)


class Bottleneck(nn.Module):
    """Pre-activation bottleneck residual: GN-GELU-1x1 / GN-GELU-3x3
    (grouped) / GN-GELU-1x1."""

    def __init__(self, channels: int, groups: int = 8):
        super().__init__()
        mid = channels // 4
        g = _num_groups(mid, groups)
        self.norm0 = group_norm(channels, _num_groups(channels))
        self.conv0 = nn.Conv2d(channels, mid, 1, bias=False)
        self.norm1 = group_norm(mid, _num_groups(mid))
        self.conv1 = nn.Conv2d(mid, mid, 3, padding=1, groups=g, bias=False)
        self.norm2 = group_norm(mid, _num_groups(mid))
        self.conv2 = nn.Conv2d(mid, channels, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(gelu(self.norm0(x)))
        h = self.conv1(gelu(self.norm1(h)))
        h = self.conv2(gelu(self.norm2(h)))
        return x + h


class EncBlock(nn.Module):
    """Stride-2 4x4 conv downsample + N bottleneck residuals."""

    def __init__(self, in_ch: int, out_ch: int, num_blocks: int = 2,
                 groups: int = 8):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, 4, stride=2, padding=1,
                              bias=False)
        self.norm = group_norm(out_ch, _num_groups(out_ch))
        self.blocks = nn.ModuleList(Bottleneck(out_ch, groups)
                                    for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.norm(self.conv(x)))
        for blk in self.blocks:
            x = blk(x)
        return x


class DecBlock(nn.Module):
    """Stride-2 4x4 transposed-conv upsample (exact 2x) + N bottleneck
    residuals."""

    def __init__(self, in_ch: int, out_ch: int, num_blocks: int = 2,
                 groups: int = 8):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, 4, stride=2, padding=1,
                                       bias=False)
        self.norm = group_norm(out_ch, _num_groups(out_ch))
        self.blocks = nn.ModuleList(Bottleneck(out_ch, groups)
                                    for _ in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.norm(self.conv(x)))
        for blk in self.blocks:
            x = blk(x)
        return x


class MLP(nn.Module):
    """Linear stack with an activation between layers (flax reads the input
    width off the input; a torch layer needs it up front)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.relu):
        super().__init__()
        widths = (in_features,) + tuple(features)
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(widths, widths[1:]))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x
