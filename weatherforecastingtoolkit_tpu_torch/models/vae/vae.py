"""VAE Encoder / Decoder stacks in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/vae/vae.py).

``scales`` (per-block 2 or 4) selects the stacked 4x resamplers; None means
all 2x. The decoder runs ``layers_per_block + 1`` resnets per block.
``remat`` recomputes each down/mid/up block in the backward instead of
keeping its activations (``models/common.py::run_blocks``), as the JAX
stacks' ``nn.remat``; a recomputed block runs its GroupNorm kernels again.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.quant import ConvMode, QConv
from ..common import run_blocks
from .blocks import (DownEncoderBlock2D, GroupNormSiLU, UNetMidBlock2D,
                     UpDecoderBlock2D)


class Encoder(nn.Module):
    """conv_in -> N DownEncoderBlocks -> mid (resnet/attn/resnet) ->
    GroupNorm/SiLU/conv_out; emits 2*out_channels when double_z."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64,),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 double_z: bool = True,
                 scales: Optional[Sequence[int]] = None,
                 conv_mode: ConvMode = "native", remat: bool = False):
        super().__init__()
        self.remat = remat
        boc = tuple(block_out_channels)
        n = len(boc)
        scales = tuple(scales or (2,) * n)
        self.conv_in = QConv(in_channels, boc[0], 3, padding=1, mode=conv_mode)
        self.down_blocks = nn.ModuleList(
            DownEncoderBlock2D(boc[max(i - 1, 0)], ch, layers_per_block,
                               norm_num_groups, add_downsample=(i != n - 1),
                               scale=scales[i] if i < len(scales) else 2,
                               conv_mode=conv_mode)
            for i, ch in enumerate(boc))
        self.mid_block = UNetMidBlock2D(boc[-1], norm_num_groups,
                                        conv_mode=conv_mode)
        self.conv_norm_out = GroupNormSiLU(boc[-1], norm_num_groups, 1e-6)
        out_ch = 2 * out_channels if double_z else out_channels
        self.conv_out = QConv(boc[-1], out_ch, 3, padding=1, mode=conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = run_blocks([*self.down_blocks, self.mid_block], self.conv_in(x),
                       self.remat)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    """conv_in -> mid -> N UpDecoderBlocks (reversed channels) ->
    GroupNorm/SiLU/conv_out."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64,),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 scales: Optional[Sequence[int]] = None,
                 conv_mode: ConvMode = "native", remat: bool = False):
        super().__init__()
        self.remat = remat
        rev = tuple(reversed(tuple(block_out_channels)))
        n = len(rev)
        scales = tuple(scales or (2,) * n)
        self.conv_in = QConv(in_channels, rev[0], 3, padding=1, mode=conv_mode)
        self.mid_block = UNetMidBlock2D(rev[0], norm_num_groups,
                                        conv_mode=conv_mode)
        self.up_blocks = nn.ModuleList(
            UpDecoderBlock2D(rev[max(i - 1, 0)], ch, layers_per_block + 1,
                             norm_num_groups, add_upsample=(i != n - 1),
                             scale=scales[i] if i < len(scales) else 2,
                             conv_mode=conv_mode)
            for i, ch in enumerate(rev))
        self.conv_norm_out = GroupNormSiLU(rev[-1], norm_num_groups, 1e-6)
        self.conv_out = QConv(rev[-1], out_channels, 3, padding=1,
                              mode=conv_mode)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = run_blocks([self.mid_block, *self.up_blocks], self.conv_in(z),
                       self.remat)
        return self.conv_out(self.conv_norm_out(x))
