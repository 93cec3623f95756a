"""Latent temporal forecasters in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/forecasters.py): per-position
``LinearForecaster``, ``PerPixelLinear``, ``TimeMLP`` and ``DLinear``.

DLinear: moving-average trend/seasonal decomposition (replicate-padded time
ends, cumulative-sum box filter) and one linear map over time for each
part. The shared variant holds two ``nn.Linear(seq_len, pred_len)``;
``individual`` holds one (T_out, T_in) map per feature channel. Weights
start at 1/seq_len and biases at 0, as in the reference. The other three
are ``nn.Linear`` stacks made from ``seed`` with flax's Dense init
(lecun-normal kernels, zero biases); flax infers a Dense's input width at
its first call, the port takes it as an argument. Each has a
``*_state_dict_from_flax`` (flax Dense kernels are (in, out), ``nn.Linear``
weights (out, in)). The latent path runs in fp32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import lecun_normal_


def _flax_dense_init(module: nn.Module, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, rng)
                m.bias.zero_()


def _check_steps(t: int, t_in: int) -> None:
    if t != t_in:
        raise ValueError(f"expected T_in={t_in}, got {t}")


class LinearForecaster(nn.Module):
    """One linear map over the flattened (T_in * D) features of each
    sample: x (B, T_in, D) -> (B, T_out, D)."""

    def __init__(self, t_in: int, t_out: int, d: int, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.t_in, self.t_out = t_in, t_out
        self.dense = nn.Linear(t_in * d, t_out * d,
                               device=resolve_device(device))
        _flax_dense_init(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        _check_steps(t, self.t_in)
        return self.dense(x.reshape(b, t * d)).reshape(b, self.t_out, d)


class PerPixelLinear(nn.Module):
    """At each latent pixel, map the stacked (T_in * C) channel-time
    features to (T_out * C): x (B, T_in, C, H, W) -> (B, T_out, C, H, W)."""

    def __init__(self, t_in: int, t_out: int, c: int, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        self.t_in, self.t_out = t_in, t_out
        self.dense = nn.Linear(t_in * c, t_out * c,
                               device=resolve_device(device))
        _flax_dense_init(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c, h, w = x.shape
        _check_steps(t, self.t_in)
        feat = x.permute(0, 3, 4, 1, 2).reshape(b, h, w, t * c)
        out = self.dense(feat).reshape(b, h, w, self.t_out, c)
        return out.permute(0, 3, 4, 1, 2)


class TimeMLP(nn.Module):
    """(..., T_in) -> (..., T_out): Dense(hidden), ReLU, Dense(hidden),
    ReLU, Dense(T_out) over the trailing time axis."""

    def __init__(self, t_in: int, t_out: int, hidden_dim: int = 128, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        widths = (t_in, hidden_dim, hidden_dim, t_out)
        self.layers = nn.ModuleList(nn.Linear(a, b, device=dev)
                                    for a, b in zip(widths, widths[1:]))
        _flax_dense_init(self, seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def moving_avg(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Trend: replicate-pad the time ends, then a box filter along T.
    x: (B, T, D)."""
    pad = (kernel_size - 1) // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x,
                    x[:, -1:].expand(-1, pad, -1)], dim=1)
    cs = torch.cumsum(xp, dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
    return (cs[:, kernel_size:] - cs[:, :-kernel_size]) / kernel_size


def series_decomp(x: torch.Tensor, kernel_size: int):
    """(residual/seasonal, trend) decomposition."""
    trend = moving_avg(x, kernel_size)
    return x - trend, trend


class DLinear(nn.Module):
    """Decomposition-Linear forecaster. x: (B, T_in, D) -> (B, T_out, D)."""

    def __init__(self, seq_len: int, pred_len: int, kernel_size: int = 25,
                 individual: bool = False, channels: int = 1, *,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.kernel_size = kernel_size
        self.individual = individual
        lead = (channels,) if individual else ()
        w = torch.full(lead + (pred_len, seq_len), 1.0 / seq_len,
                       device=device)
        b = torch.zeros(lead + (pred_len,), device=device)
        if individual:
            self.seasonal_weight = nn.Parameter(w)
            self.seasonal_bias = nn.Parameter(b)
            self.trend_weight = nn.Parameter(w.clone())
            self.trend_bias = nn.Parameter(b.clone())
        else:
            self.seasonal = nn.Linear(seq_len, pred_len, device=device)
            self.trend = nn.Linear(seq_len, pred_len, device=device)
            with torch.no_grad():
                for lin in (self.seasonal, self.trend):
                    lin.weight.copy_(w)
                    lin.bias.copy_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seasonal, trend = series_decomp(x, self.kernel_size)
        if self.individual:
            if x.shape[-1] != self.seasonal_weight.shape[0]:
                raise ValueError(f"channels={self.seasonal_weight.shape[0]} "
                                 f"!= D={x.shape[-1]}")
            s = (torch.einsum("btd,dot->bod", seasonal, self.seasonal_weight)
                 + self.seasonal_bias.T)
            t = (torch.einsum("btd,dot->bod", trend, self.trend_weight)
                 + self.trend_bias.T)
        else:
            s = (torch.einsum("btd,ot->bod", seasonal, self.seasonal.weight)
                 + self.seasonal.bias[:, None])
            t = (torch.einsum("btd,ot->bod", trend, self.trend.weight)
                 + self.trend.bias[:, None])
        return s + t


def dlinear_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``DLinear`` variables ``{'params': ...}`` -> this module's state
    dict. The flax weights are (T_in, T_out), or (D, T_in, T_out) when
    ``individual``; the port's are (T_out, T_in) and (D, T_out, T_in)."""
    p = params["params"] if "params" in params else params
    w_s = np.asarray(p["seasonal_w"], np.float32)
    individual = w_s.ndim == 3
    names = ({"seasonal_w": "seasonal_weight", "seasonal_b": "seasonal_bias",
              "trend_w": "trend_weight", "trend_b": "trend_bias"}
             if individual else
             {"seasonal_w": "seasonal.weight", "seasonal_b": "seasonal.bias",
              "trend_w": "trend.weight", "trend_b": "trend.bias"})
    out = {}
    for flax_name, torch_name in names.items():
        v = np.asarray(p[flax_name], np.float32)
        if flax_name.endswith("_w"):
            v = np.swapaxes(v, -1, -2)
        out[torch_name] = torch.from_numpy(np.array(v, order="C"))
    return out


def _dense_from_flax(p, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": torch.from_numpy(np.array(
                np.asarray(p["kernel"], np.float32).T, order="C")),
            f"{prefix}.bias": torch.from_numpy(np.array(
                np.asarray(p["bias"], np.float32)))}


def linear_forecaster_state_dict_from_flax(params: dict
                                           ) -> Dict[str, torch.Tensor]:
    """JAX ``LinearForecaster`` variables -> this module's state dict."""
    p = params["params"] if "params" in params else params
    return _dense_from_flax(p["Dense_0"], "dense")


# PerPixelLinear holds one Dense, named as LinearForecaster's
per_pixel_linear_state_dict_from_flax = linear_forecaster_state_dict_from_flax


def time_mlp_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``TimeMLP`` variables (its ``MLP_0`` stack) -> this module's
    state dict."""
    p = params["params"] if "params" in params else params
    out = {}
    for i in range(3):
        out.update(_dense_from_flax(p["MLP_0"][f"Dense_{i}"], f"layers.{i}"))
    return out
