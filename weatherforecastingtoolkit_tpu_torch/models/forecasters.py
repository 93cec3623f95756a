"""DLinear latent forecaster in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/forecasters.py).

Moving-average trend/seasonal decomposition (replicate-padded time ends,
cumulative-sum box filter) and one linear map over time for each part. The
shared variant holds two ``nn.Linear(seq_len, pred_len)``; ``individual``
holds one (T_out, T_in) map per feature channel. Weights start at 1/seq_len
and biases at 0, as in the reference. The latent path runs in fp32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device


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
