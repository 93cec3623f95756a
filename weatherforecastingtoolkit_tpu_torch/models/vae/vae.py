"""VAE Encoder / Decoder stacks in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/vae/vae.py).

``scales`` (per-block 2 or 4) selects the stacked 4x resamplers; None means
all 2x. The decoder runs ``layers_per_block + 1`` resnets per block.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ...ops.quant import QConv
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
                 conv_mode: str = "native"):
        super().__init__()
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
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    """conv_in -> mid -> N UpDecoderBlocks (reversed channels) ->
    GroupNorm/SiLU/conv_out."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64,),
                 layers_per_block: int = 2, norm_num_groups: int = 32,
                 scales: Optional[Sequence[int]] = None,
                 conv_mode: str = "native"):
        super().__init__()
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
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(self.conv_norm_out(x))
