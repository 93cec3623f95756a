"""Diffusers-style VAE building blocks in PyTorch, NCHW (counterpart of
weatherforecastingtoolkit_tpu/models/vae/blocks.py).

Module names give the reference torch keys (``resnets.0.norm1.weight``,
``downsamplers.0.conv.weight``, ``attentions.0.query.weight``, ...), so the
JAX ``from_torch_state_dict`` loads a port ``state_dict`` strictly.

Convs are ``QConv``s in the mode their ``conv_mode`` spec resolves to at
their flax path (``AutoencoderKL`` sets the paths).

Every GroupNorm — ``ResnetBlock2D`` norm1/norm2, the stacks'
``conv_norm_out`` and the attention norm (eps 1e-5, no SiLU) — goes through
``ops/cuda/groupnorm.py::group_norm_silu``: the Hopper kernel on a CUDA
tensor, its plain version on a CPU tensor.

``fir_upsample_2d``/``fir_downsample_2d`` are the FIR resamplers, NHWC at
the interface as in JAX: a depthwise ``F.conv2d`` (``groups=c``) with the
normalised outer product of the taps.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.cuda.groupnorm import group_norm_silu
from ...ops.quant import ConvMode, QConv


def _rescale(x: torch.Tensor, factor: float) -> torch.Tensor:
    # dividing by 1.0 changes no value but costs a pass over x
    return x if factor == 1.0 else x / factor


class GroupNormSiLU(nn.Module):
    """GroupNorm followed by an optional SiLU; ``weight``/``bias`` (C,).

    The JAX module's ``fused`` flag chooses between its Pallas kernel and
    XLA's GroupNorm. On a CUDA tensor the port always runs its kernel: there
    is no library GroupNorm on the card for it to choose instead.
    """

    def __init__(self, num_channels: int, num_groups: int, eps: float = 1e-6,
                 silu: bool = True):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.silu = silu
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups,
                               self.eps, self.silu)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 groups: int = 32, eps: float = 1e-6,
                 output_scale_factor: float = 1.0, conv_mode: ConvMode = "native"):
        super().__init__()
        out_ch = out_channels or in_channels
        self.output_scale_factor = output_scale_factor
        self.norm1 = GroupNormSiLU(in_channels, min(groups, in_channels), eps)
        self.conv1 = QConv(in_channels, out_ch, 3, padding=1, mode=conv_mode)
        self.norm2 = GroupNormSiLU(out_ch, min(groups, out_ch), eps)
        self.conv2 = QConv(out_ch, out_ch, 3, padding=1, mode=conv_mode)
        self.conv_shortcut = (QConv(in_channels, out_ch, 1, mode=conv_mode)
                              if in_channels != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return _rescale(x + h, self.output_scale_factor)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with the VAE's asymmetric (0, 1) edge padding, as
    conv padding: a quantized conv reads it without a padded copy."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 conv_mode: ConvMode = "native"):
        super().__init__()
        self.conv = QConv(channels, out_channels or channels, 3, stride=2,
                          padding=((0, 1), (0, 1)), mode=conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample2D(nn.Module):
    """2x nearest-neighbour upsample + 3x3 conv."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 conv_mode: ConvMode = "native"):
        super().__init__()
        self.conv = QConv(channels, out_channels or channels, 3, padding=1,
                          mode=conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an exact integer factor: output pixel i reads input pixel i // 2
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample4x(nn.Module):
    """Two stacked stride-2 downsamples (torch keys down1.conv/down2.conv)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 conv_mode: ConvMode = "native"):
        super().__init__()
        out_ch = out_channels or channels
        self.down1 = Downsample2D(channels, out_ch, conv_mode)
        self.down2 = Downsample2D(out_ch, out_ch, conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down2(self.down1(x))


class Upsample4x(nn.Module):
    """Two stacked 2x upsamples (torch keys up1.conv/up2.conv)."""

    def __init__(self, channels: int, out_channels: Optional[int] = None,
                 conv_mode: ConvMode = "native"):
        super().__init__()
        out_ch = out_channels or channels
        self.up1 = Upsample2D(channels, out_ch, conv_mode)
        self.up2 = Upsample2D(out_ch, out_ch, conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up2(self.up1(x))


class AttentionBlock(nn.Module):
    """Spatial self-attention over the HxW grid with a residual connection.

    softmax(Q K^T / sqrt(d)) V written out with ``torch.matmul``; the logits
    and softmax are fp32 and the probabilities are cast back to the working
    dtype, as ``jax.nn.dot_product_attention`` does.
    """

    def __init__(self, channels: int, num_head_channels: Optional[int] = None,
                 norm_num_groups: int = 32, eps: float = 1e-5,
                 rescale_output_factor: float = 1.0):
        super().__init__()
        self.heads = channels // num_head_channels if num_head_channels else 1
        self.rescale_output_factor = rescale_output_factor
        self.group_norm = GroupNormSiLU(channels, min(norm_num_groups, channels),
                                        eps, silu=False)
        self.query = nn.Linear(channels, channels)
        self.key = nn.Linear(channels, channels)
        self.value = nn.Linear(channels, channels)
        self.proj_attn = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hd = c // self.heads
        tokens = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)

        def split(t):  # (b, hw, c) -> (b, heads, hw, hd)
            return t.reshape(b, h * w, self.heads, hd).transpose(1, 2)

        q = split(self.query(tokens))
        k = split(self.key(tokens))
        v = split(self.value(tokens))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        probs = torch.softmax(logits * (1.0 / math.sqrt(hd)), dim=-1)
        out = torch.matmul(probs.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, h * w, c)
        out = self.proj_attn(out).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return _rescale(out + x, self.rescale_output_factor)


def _fir_kernel_2d(kernel=(1, 3, 3, 1)) -> torch.Tensor:
    k = torch.tensor(kernel, dtype=torch.float32)
    k2 = torch.outer(k, k)
    return k2 / torch.sum(k2)


def _depthwise_fir(x: torch.Tensor, k: torch.Tensor, stride: int,
                   pad: tuple) -> torch.Tensor:
    """(N, C, H, W) conv with one (kh, kw) filter per channel, ``groups=c``;
    ``pad`` = (before, after) on both spatial axes."""
    c = x.shape[1]
    weight = k.to(device=x.device, dtype=x.dtype).expand(c, 1, *k.shape)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, weight, stride=stride, groups=c)


def fir_upsample_2d(x: torch.Tensor, kernel=(1, 3, 3, 1), factor: int = 2
                    ) -> torch.Tensor:
    """FIR-filtered upsample, NHWC in and out as in JAX: zero-stuff by
    ``factor``, then the depthwise FIR filter (scaled by factor**2)."""
    b, h, w, c = x.shape
    k = _fir_kernel_2d(kernel) * (factor ** 2)
    up = x.new_zeros((b, h, factor, w, factor, c))
    up[:, :, 0, :, 0, :] = x
    up = up.reshape(b, h * factor, w * factor, c).permute(0, 3, 1, 2)
    kh = k.shape[0]
    pad = ((kh - factor + 1) // 2 + factor - 1, (kh - factor) // 2)
    return _depthwise_fir(up, k, 1, pad).permute(0, 2, 3, 1)


def fir_downsample_2d(x: torch.Tensor, kernel=(1, 3, 3, 1), factor: int = 2
                      ) -> torch.Tensor:
    """FIR-filtered downsample, NHWC in and out as in JAX: the depthwise FIR
    filter at stride ``factor``."""
    k = _fir_kernel_2d(kernel)
    kh = k.shape[0]
    pad = ((kh - factor + 1) // 2, (kh - factor) // 2)
    return _depthwise_fir(x.permute(0, 3, 1, 2), k, factor,
                          pad).permute(0, 2, 3, 1)


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 1, resnet_groups: int = 32,
                 resnet_eps: float = 1e-6, add_downsample: bool = True,
                 scale: int = 2, conv_mode: ConvMode = "native"):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, resnet_groups, resnet_eps,
                          conv_mode=conv_mode)
            for i in range(num_layers))
        down = Downsample4x if scale == 4 else Downsample2D
        self.downsamplers = (
            nn.ModuleList([down(out_channels, out_channels, conv_mode)])
            if add_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 num_layers: int = 1, resnet_groups: int = 32,
                 resnet_eps: float = 1e-6, add_upsample: bool = True,
                 scale: int = 2, conv_mode: ConvMode = "native"):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(in_channels if i == 0 else out_channels,
                          out_channels, resnet_groups, resnet_eps,
                          conv_mode=conv_mode)
            for i in range(num_layers))
        up = Upsample4x if scale == 4 else Upsample2D
        self.upsamplers = (
            nn.ModuleList([up(out_channels, out_channels, conv_mode)])
            if add_upsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, resnet_groups: int = 32,
                 resnet_eps: float = 1e-6,
                 attn_num_head_channels: Optional[int] = None,
                 output_scale_factor: float = 1.0, num_layers: int = 1,
                 conv_mode: ConvMode = "native"):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock2D(channels, channels, resnet_groups, resnet_eps,
                          output_scale_factor, conv_mode)
            for _ in range(num_layers + 1))
        self.attentions = nn.ModuleList(
            AttentionBlock(channels, attn_num_head_channels, resnet_groups,
                           rescale_output_factor=output_scale_factor)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = resnet(attn(x))
        return x
