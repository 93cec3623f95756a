"""``QConv``: the conv of the VAE blocks (counterpart of
weatherforecastingtoolkit_tpu/ops/quant.py::QConv), ``native`` mode only.

``native`` mirrors flax ``nn.Conv``'s dtype promotion: input, kernel and bias
are promoted to one dtype and the conv runs in it. The quantized modes
(``int8``, ``int8_static``, ``calibrate``, ``fake_quant``) and mixed per-layer
specs are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

CONV_MODES = ("native", "int8", "int8_static", "calibrate", "fake_quant")


class QConv(nn.Module):
    """A 2-D conv with ``weight`` (out, in, kh, kw) and ``bias`` (out,),
    the names and layout of ``nn.Conv2d``; symmetric integer padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 mode: str = "native"):
        super().__init__()
        if mode != "native":
            if isinstance(mode, str) and mode not in CONV_MODES:
                raise ValueError(f"conv mode {mode!r} not in {CONV_MODES}")
            raise NotImplementedError(
                f"conv mode {mode!r} is not ported; only 'native' runs")
        kh, kw = ((kernel_size,) * 2 if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                        self.stride, self.padding)
