"""PatchGAN discriminator and adversarial losses (counterpart of
weatherforecastingtoolkit_tpu/models/losses/gan.py).

  * ``NLayerDiscriminator``: 4x4 stride-2 conv ladder, LeakyReLU(0.2), a
    norm after every conv but the first, a 1-channel patch-logit head (a 1x1
    conv with padding 1, as in JAX: a 128x128 input gives 17x17 logits).
    Convs are drawn from normal(0, 0.02), biases zero.
  * Norms: GroupNorm with one channel a group (``num_groups = C``, eps 1e-6,
    ``F.group_norm``) or ``ActNorm`` (``use_actnorm``), a per-channel affine
    whose data-dependent init is the explicit ``ActNorm.stats_from``.
  * ``hinge_d_loss``, ``vanilla_d_loss``, the ``adopt_weight`` gate, the
    ``adaptive_weight`` balance and ``feature_matching_distance``.

Everything is NCHW. ``discriminator_state_dict_from_flax`` carries the JAX
package's params across.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...utils.device import DeviceLike, resolve_device


class ActNorm(nn.Module):
    """Per-channel affine scale * (x + loc), loc (1, C, 1, 1) zeros and scale
    ones until set from data (``stats_from``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(1, channels, 1, 1))
        self.scale = nn.Parameter(torch.ones(1, channels, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * (x + self.loc)

    @staticmethod
    def stats_from(x: torch.Tensor):
        """(loc, scale) of a data batch (B, C, H, W), each (1, C, 1, 1):
        -mean and 1 / (std + 1e-6), std the population std as ``jnp.std``."""
        mean = torch.mean(x, dim=(0, 2, 3), keepdim=True)
        std = torch.std(x, dim=(0, 2, 3), keepdim=True, unbiased=False)
        return -mean, 1.0 / (std + 1e-6)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = False, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.n_layers = n_layers
        widths = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]
        self.conv_0 = nn.Conv2d(input_nc, ndf, 4, stride=2, padding=1)
        for n in range(1, n_layers + 1):
            stride = 2 if n < n_layers else 1
            setattr(self, f"conv_{n}", nn.Conv2d(
                widths[n - 1], widths[n], 4, stride=stride, padding=1,
                bias=use_actnorm))
            setattr(self, f"norm_{n}", ActNorm(widths[n]) if use_actnorm
                    else nn.GroupNorm(widths[n], widths[n], eps=1e-6))
        self.conv_out = nn.Conv2d(widths[-1], 1, 1, padding=1)
        self._init_weights(np.random.default_rng(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, rng: np.random.Generator) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.copy_(torch.from_numpy(
                    rng.standard_normal(m.weight.shape) * 0.02))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """x (B, C, H, W) -> patch logits (B, 1, h', w'); with
        ``return_features`` also the post-activation feature map of every
        level, the taps of ``feature_matching_distance``."""
        h = F.leaky_relu(self.conv_0(x), 0.2)
        feats = [h]
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = F.leaky_relu(getattr(self, f"norm_{n}")(h), 0.2)
            feats.append(h)
        logits = self.conv_out(h)
        if return_features:
            return logits, feats
        return logits


def feature_matching_distance(feats_a: List[torch.Tensor],
                              feats_b: List[torch.Tensor]) -> torch.Tensor:
    """Per-sample mean L1 distance across feature maps, averaged over the
    levels, as (B, 1, 1, 1) for broadcast onto the elementwise
    reconstruction map (the slot LPIPS takes)."""
    d = 0.0
    for a, b in zip(feats_a, feats_b):
        d = d + torch.mean(torch.abs(a - b), dim=tuple(range(1, a.ndim)))
    d = d / max(1, len(feats_a))
    return d.reshape(-1, 1, 1, 1)


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    loss_real = torch.mean(F.relu(1.0 - logits_real))
    loss_fake = torch.mean(F.relu(1.0 + logits_fake))
    return 0.5 * (loss_real + loss_fake)


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``value`` before ``threshold`` steps, ``weight`` from then on. The
    port's step counter is an int (``TrainState.step``), so this is a host
    decision and costs no device sync."""
    return value if global_step < threshold else weight


def adaptive_weight(nll_grad_last: torch.Tensor, g_grad_last: torch.Tensor,
                    disc_weight: float = 1.0) -> torch.Tensor:
    """Balance the reconstruction and adversarial gradients on the
    generator's last layer: ||grad rec|| / (||grad adv|| + 1e-4), clipped to
    [0, 1e4], detached, times ``disc_weight``. Norms do not depend on the
    layout, so the torch weight gives JAX's value."""
    norm_nll = torch.linalg.vector_norm(nll_grad_last.reshape(-1))
    norm_g = torch.linalg.vector_norm(g_grad_last.reshape(-1))
    w = norm_nll / (norm_g + 1e-4)
    # jnp.clip as minimum(maximum(.)); the value is detached anyway
    w = torch.minimum(torch.maximum(w, w.new_zeros(())), w.new_full((), 1e4))
    return w.detach() * disc_weight


def discriminator_state_dict_from_flax(params: dict
                                       ) -> Dict[str, torch.Tensor]:
    """JAX ``NLayerDiscriminator`` variables ``{'params': ...}`` (numpy
    arrays) -> this module's state dict, for ``load_state_dict(strict=True)``:
    conv kernels HWIO -> OIHW, GroupNorm scale -> weight, ActNorm's
    (1, 1, 1, C) loc and scale -> (1, C, 1, 1)."""
    tree = params["params"] if "params" in params else params
    out = {}
    for mod, leaves in tree.items():
        if not isinstance(leaves, Mapping):
            raise KeyError(mod)
        for leaf, v in leaves.items():
            v = np.asarray(v, dtype=np.float32)
            if leaf == "kernel":
                v, leaf = np.transpose(v, (3, 2, 0, 1)), "weight"
            elif leaf in ("loc", "scale") and v.ndim == 4:
                v = np.transpose(v, (0, 3, 1, 2))
            elif leaf == "scale":
                leaf = "weight"
            out[f"{mod}.{leaf}"] = torch.from_numpy(
                np.array(v, np.float32, order="C"))
    return out
