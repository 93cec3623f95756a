"""2-D pooling on (..., H, W) tensors (counterpart of
weatherforecastingtoolkit_tpu/ops/pooling.py), floor semantics: trailing
pixels that do not fill a window are dropped.

``avg_pool2d`` is a sum over the window, row by row, then one division by
window**2, the order JAX's ``reduce_window`` sum takes, so a field of
constant values pools to the same bits in both packages (the metric
thresholds compare against such values).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _as_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1, 1) + tuple(x.shape[-2:]))


def avg_pool2d(x: torch.Tensor, window: int,
               stride: Optional[int] = None) -> torch.Tensor:
    """Average-pool the trailing two axes."""
    stride = window if stride is None else stride
    y = F.avg_pool2d(_as_nchw(x), window, stride)
    return y.reshape(tuple(x.shape[:-2]) + tuple(y.shape[-2:]))


def max_pool2d(x: torch.Tensor, window: int,
               stride: Optional[int] = None) -> torch.Tensor:
    """Max-pool the trailing two axes."""
    stride = window if stride is None else stride
    y = F.max_pool2d(_as_nchw(x), window, stride)
    return y.reshape(tuple(x.shape[:-2]) + tuple(y.shape[-2:]))
