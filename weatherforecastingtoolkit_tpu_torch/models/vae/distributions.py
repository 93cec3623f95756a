"""VAE posterior distribution (counterpart of
weatherforecastingtoolkit_tpu/models/vae/distributions.py).

Mean/logvar chunked on the channel axis, logvar clamped to [-30, 20];
``sample`` draws from an explicit ``torch.Generator`` (inside a
data-parallel step, for the global batch, keeping this rank's rows:
``parallel/mesh.py::randn_rows``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ...parallel.mesh import randn_rows


class DiagonalGaussianDistribution:
    def __init__(self, parameters: torch.Tensor, deterministic: bool = False):
        """parameters: (B, 2*C, H, W) — mean/logvar chunked on axis 1."""
        self.parameters = parameters
        mean, logvar = torch.chunk(parameters, 2, dim=1)
        self.mean = mean
        self.logvar = torch.clamp(logvar, -30.0, 20.0)
        self.deterministic = deterministic
        self.std = torch.exp(0.5 * self.logvar)
        self.var = torch.exp(self.logvar)
        if deterministic:
            self.std = torch.zeros_like(self.mean)
            self.var = torch.zeros_like(self.mean)

    def sample(self, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        noise = randn_rows(self.mean.shape, generator, self.mean.device,
                           self.mean.dtype)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussianDistribution"] = None
           ) -> torch.Tensor:
        """KL divergence summed over (C, H, W) per sample -> (B,)."""
        if self.deterministic:
            return torch.zeros(self.mean.shape[0], dtype=self.mean.dtype,
                               device=self.mean.device)
        dims = tuple(range(1, self.mean.ndim))
        if other is None:
            return 0.5 * torch.sum(
                self.mean ** 2 + self.var - 1.0 - self.logvar, dim=dims)
        return 0.5 * torch.sum(
            (self.mean - other.mean) ** 2 / other.var
            + self.var / other.var - 1.0 - self.logvar + other.logvar,
            dim=dims)

    def nll(self, sample: torch.Tensor, axes: Tuple[int, ...] = (1, 2, 3)
            ) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros(sample.shape[0], dtype=sample.dtype,
                               device=sample.device)
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(
            logtwopi + self.logvar + (sample - self.mean) ** 2 / self.var,
            dim=axes)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL between two gaussians with broadcasting (counterpart of the JAX
    ``distributions.py::normal_kl``). Any argument may be a Python number;
    it takes the dtype and device of the first tensor argument."""
    like = next((a for a in (mean1, logvar1, mean2, logvar2)
                 if isinstance(a, torch.Tensor)), None)
    if like is None:
        raise TypeError("normal_kl needs at least one tensor argument")
    mean1, logvar1, mean2, logvar2 = (
        a if isinstance(a, torch.Tensor) else torch.tensor(a).to(like)
        for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))
