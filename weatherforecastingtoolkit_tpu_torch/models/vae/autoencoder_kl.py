"""AutoencoderKL in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/vae/autoencoder_kl.py).

Public contract, NCHW at the API edge:
  encode(x)  -> DiagonalGaussianDistribution over (B, latent_C, h, w)
  decode(z)  -> (B, C, H, W)
  forward(x, sample_posterior, generator) -> recon [, posterior]

Inside, activations and conv weights are ``channels_last``, the layout
cuDNN's tensor-core convolutions take without a transpose and the int8
conv kernel reads as NHWC. Weights are made from ``seed`` with flax's
initializers, so a seed gives the same weights on every device.
``state_dict_from_flax`` carries JAX-package params across; the JAX
``from_torch_state_dict`` loads this module's ``state_dict`` in every conv
mode. ``conv_mode`` is a mode of ``ops/quant.py`` or a mixed spec, resolved
at each conv's flax path (``encoder/down_blocks_1/resnets_0/conv1``);
``quant_conv`` and ``post_quant_conv`` are native convs in every conv mode,
as JAX's plain convs are.
Calibration scales (``load_qscales``, ``qscales_from_flax``) live outside
the state dict.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ...ops.quant import ConvMode, QConv
from ...utils.device import DeviceLike, resolve_device
from ..common import (depth_to_space, lecun_normal_, nchw_to_nhwc,
                      nhwc_to_nchw, space_to_depth)
from .blocks import GroupNormSiLU
from .distributions import DiagonalGaussianDistribution
from .vae import Decoder, Encoder

_CL = torch.channels_last


class AutoencoderKL(nn.Module):
    """The diffusers-style VAE with quant convs and a gaussian posterior.

    ``fused_norm`` and ``use_slicing`` are accepted for signature parity
    with the JAX module: on a CUDA tensor every GroupNorm runs the Hopper
    kernel whatever ``fused_norm`` says, and slicing is a no-op as in JAX.
    ``remat`` recomputes each encoder and decoder block in the backward
    (training memory for FLOPs), as in JAX.
    """

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 block_out_channels: Sequence[int] = (64,),
                 layers_per_block: int = 1, latent_channels: int = 4,
                 norm_num_groups: int = 32, scaling_factor: float = 0.18215,
                 use_slicing: bool = False, fused_norm: bool = False,
                 conv_mode: ConvMode = "native", remat: bool = False,
                 pixel_unshuffle: int = 1,
                 scales: Optional[Sequence[int]] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        f = self.pixel_unshuffle = pixel_unshuffle
        self.scaling_factor = scaling_factor
        dec_scales = None
        if scales:
            s = tuple(scales)
            dec_scales = tuple(reversed(s[:-1])) + s[-1:]
        with torch.device("meta"):  # shapes only; weights are made below
            self.encoder = Encoder(
                in_channels * f * f, latent_channels, block_out_channels,
                layers_per_block, norm_num_groups, double_z=True,
                scales=scales, conv_mode=conv_mode, remat=remat)
            self.decoder = Decoder(
                latent_channels, out_channels * f * f, block_out_channels,
                layers_per_block, norm_num_groups, scales=dec_scales,
                conv_mode=conv_mode, remat=remat)
            self.quant_conv = QConv(2 * latent_channels,
                                    2 * latent_channels, 1)
            self.post_quant_conv = QConv(latent_channels, latent_channels, 1)
        self.to_empty(device="cpu")
        self._init_weights(np.random.default_rng(seed))
        self.to(device=device, memory_format=_CL)
        for name, m in self.named_modules():
            if isinstance(m, QConv):
                m.set_path(flax_path(name))

    def load_qscales(self, qscales: Mapping[str, torch.Tensor]) -> None:
        """Give every conv that reads calibration scales its act_absmax from
        {flax conv path: (Cin,)} (``calibrate`` or ``qscales_from_flax``);
        a conv missing from the dict gets ones, as JAX's default."""
        for m in self.modules():
            if isinstance(m, QConv) and m.act_absmax is not None:
                v = qscales.get(m.path)
                with torch.no_grad():
                    if v is None:
                        m.act_absmax.fill_(1.0)
                    else:
                        m.act_absmax.copy_(torch.as_tensor(v))

    def _init_weights(self, rng: np.random.Generator) -> None:
        init_vae_weights(self, rng)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        h = x
        if self.pixel_unshuffle > 1:
            h = nhwc_to_nchw(space_to_depth(nchw_to_nhwc(h),
                                            self.pixel_unshuffle))
        h = self.encoder(h.contiguous(memory_format=_CL))
        return DiagonalGaussianDistribution(self.quant_conv(h))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        h = self.decoder(self.post_quant_conv(z.contiguous(memory_format=_CL)))
        if self.pixel_unshuffle > 1:
            h = nhwc_to_nchw(depth_to_space(nchw_to_nhwc(h),
                                            self.pixel_unshuffle))
        return h

    def forward(self, x: torch.Tensor, sample_posterior: bool = False,
                generator: Optional[torch.Generator] = None,
                return_posterior: bool = False
                ) -> Union[torch.Tensor,
                           Tuple[torch.Tensor, DiagonalGaussianDistribution]]:
        posterior = self.encode(x)
        z = posterior.sample(generator) if sample_posterior else posterior.mode()
        dec = self.decode(z)
        if return_posterior:
            return dec, posterior
        return dec


@torch.no_grad()
def init_vae_weights(module: nn.Module, rng: np.random.Generator) -> None:
    """flax's defaults: lecun-normal conv and dense kernels, zero biases,
    unit norms."""
    for m in module.modules():
        if isinstance(m, GroupNormSiLU):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif hasattr(m, "weight") and m.weight is not None:
            lecun_normal_(m.weight, rng)
            if m.bias is not None:
                m.bias.zero_()


# --------------------------------------------------------------------------
# JAX-package params -> port state dict
# --------------------------------------------------------------------------
def _torch_key(flax_path: str) -> str:
    """'encoder.down_blocks_0.resnets_1.norm1.scale' ->
    'encoder.down_blocks.0.resnets.1.norm1.weight' (inverts JAX ``_rename``)."""
    *mods, leaf = flax_path.split(".")
    mods = [re.sub(r"_(\d+)$", r".\1", m) for m in mods]
    return ".".join(mods + [{"kernel": "weight", "scale": "weight",
                             "bias": "bias"}[leaf]])


def flax_path(module_name: str) -> str:
    """'encoder.down_blocks.1.resnets.0.conv1' ->
    'encoder/down_blocks_1/resnets_0/conv1' (the inverse of ``_torch_key``'s
    renaming, joined as flax joins a module path)."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", module_name).replace(".", "/")


def _torch_tensor(leaf: str, v: np.ndarray) -> torch.Tensor:
    v = np.asarray(v, dtype=np.float32)
    if leaf == "kernel" and v.ndim == 4:      # conv HWIO -> OIHW
        v = np.transpose(v, (3, 2, 0, 1))
    elif leaf == "kernel" and v.ndim == 2:    # dense (in, out) -> (out, in)
        v = v.T
    return torch.from_numpy(np.array(v, np.float32, order="C"))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``AutoencoderKL`` variables ``{'params': ...}`` (numpy arrays) ->
    this module's state dict, for ``load_state_dict(..., strict=True)``."""
    tree = params["params"] if "params" in params else params
    return {_torch_key(path): _torch_tensor(path.rsplit(".", 1)[1], v)
            for path, v in _flatten(tree).items()}
