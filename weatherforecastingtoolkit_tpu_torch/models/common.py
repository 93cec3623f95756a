"""Layout helpers and parameter init shared by the port's models.

``space_to_depth``/``depth_to_space`` keep the JAX package's channel order,
``(u*f + v)*C + c`` for subpixel (u, v), so fast-VAE weights transfer between
the two packages. ``torch.nn.functional.pixel_unshuffle`` orders channels as
``c*f*f + u*f + v`` and must not be used in their place.
"""

from __future__ import annotations

import numpy as np
import torch

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
def lecun_normal_(weight: torch.Tensor,
                  rng: np.random.Generator) -> torch.Tensor:
    """flax's default kernel init on a torch (out, in, ...) weight: fan_in
    is everything but the leading output axis. The draw comes from numpy, so
    a seed gives the same weights under every torch version (torch's own
    ``trunc_normal_`` changed its sampler between versions)."""
    v = rng.standard_normal(weight.shape)
    out = np.abs(v) > 2.0
    while out.any():                      # truncate at two sigma by redrawing
        v[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(v) > 2.0
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    return weight.copy_(torch.from_numpy(v * std))
