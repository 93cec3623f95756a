"""LPIPS perceptual loss: a VGG16 backbone and learned 1x1 heads
(counterpart of weatherforecastingtoolkit_tpu/models/losses/lpips.py).

VGG16 is written out here (no torchvision is needed): 13 3x3 convs with
ReLU in 5 slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), a 2x2 max
pool between slices. Each slice's features are unit-normalised over the
channels (+1e-10), their squared difference weighted by the "lin" head
(initialised to ones), summed over channels and averaged over space; the
five slices add up.

Weights are the user's: nothing is downloaded. ``lpips_state_dict_from_torch``
takes a torchvision VGG16 state dict (its ``features.*`` entries) and the
LPIPS lin-head checkpoint (``lin{i}.model.1.weight``); without them the
module runs on flax-default random weights from ``seed``.
``lpips_state_dict_from_flax`` carries the JAX package's params across.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.device import DeviceLike, resolve_device
from ..common import init_flax_defaults

# ImageNet scaling (the LPIPS ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# (channels, convs) per slice; a 2x2 max pool between slices
_VGG_SLICES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# torchvision's vgg16().features index of each of the 13 convs
TORCHVISION_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


class VGG16Features(nn.Module):
    """VGG16 returning the 5 LPIPS slice activations; convs ``conv_{i}``."""

    def __init__(self):
        super().__init__()
        cin, i = 3, 0
        for ch, n in _VGG_SLICES:
            for _ in range(n):
                setattr(self, f"conv_{i}", nn.Conv2d(cin, ch, 3, padding=1))
                cin, i = ch, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, 3, H, W) in [-1, 1]."""
        outs, i, h = [], 0, x
        for s, (_, n) in enumerate(_VGG_SLICES):
            if s > 0:
                h = F.max_pool2d(h, 2, 2)
            for _ in range(n):
                h = F.relu(getattr(self, f"conv_{i}")(h))
                i += 1
            outs.append(h)
        return outs


class LPIPS(nn.Module):
    """Scaling -> VGG slices -> unit-normalise -> 1x1 lin heads."""

    def __init__(self, use_dropout: bool = True, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.use_dropout = use_dropout  # parity flag; heads are eval-time
        self.vgg = VGG16Features()
        for i, (ch, _) in enumerate(_VGG_SLICES):
            setattr(self, f"lin_{i}", nn.Parameter(torch.ones(1, ch, 1, 1)))
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1),
                             persistent=False)
        init_flax_defaults(self.vgg, np.random.default_rng(seed))
        self.to(device)

    def forward(self, in0: torch.Tensor, in1: torch.Tensor) -> torch.Tensor:
        """in0, in1: (B, 3, H, W) in [-1, 1]. Returns (B, 1, 1, 1)."""
        b = in0.shape[0]
        shift, scale = self.shift.to(in0.dtype), self.scale.to(in0.dtype)
        feats = self.vgg((torch.cat([in0, in1]) - shift) / scale)
        total = 0.0
        for i, f in enumerate(feats):
            f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + 1e-10)
            diff = (f[:b] - f[b:]) ** 2
            weighted = torch.sum(getattr(self, f"lin_{i}") * diff, dim=1,
                                 keepdim=True)
            total = total + torch.mean(weighted, dim=(2, 3), keepdim=True)
        return total


def lpips_state_dict_from_torch(vgg_state_dict: Mapping[str, object],
                                lin_state_dict: Mapping[str, object]
                                ) -> Dict[str, torch.Tensor]:
    """This module's state dict from a torchvision VGG16 state dict (its
    ``features.{i}.weight``/``bias`` entries) and the LPIPS lin-head
    checkpoint (``lin{i}.model.1.weight``, (1, C, 1, 1)); the counterpart of
    the JAX ``lpips_params_from_torch``."""
    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float32)).clone()

    out = {}
    for i, li in enumerate(TORCHVISION_CONVS):
        out[f"vgg.conv_{i}.weight"] = t(vgg_state_dict[f"features.{li}.weight"])
        out[f"vgg.conv_{i}.bias"] = t(vgg_state_dict[f"features.{li}.bias"])
    for i in range(len(_VGG_SLICES)):
        w = t(lin_state_dict[f"lin{i}.model.1.weight"])   # (1, C, 1, 1)
        out[f"lin_{i}"] = w.reshape(1, -1, 1, 1)
    return out


def lpips_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``LPIPS`` variables ``{'params': ...}`` (numpy arrays) -> this
    module's state dict: conv kernels HWIO -> OIHW, the lin heads as they
    are ((1, C, 1, 1) in both)."""
    tree = params["params"] if "params" in params else params
    out = {}
    for name, conv in tree["vgg"].items():
        out[f"vgg.{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(conv["kernel"], np.float32), (3, 2, 0, 1))))
        out[f"vgg.{name}.bias"] = torch.from_numpy(
            np.asarray(conv["bias"], np.float32).copy())
    for i in range(len(_VGG_SLICES)):
        out[f"lin_{i}"] = torch.from_numpy(
            np.asarray(tree[f"lin_{i}"], np.float32).copy())
    return out
