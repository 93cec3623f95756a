"""Weights from the run's seed, drawn on the card in one call.

One ``torch.randn`` over every parameter of the configuration (the VAE's as
``reference.param_spec`` lists them, then DLinear's), from a
``torch.Generator`` on the run's device, shaped per kind:
  conv, linear   standard normal clipped at 2, over sqrt(fan_in)
  bias           0.02 * normal
  norm_weight    1 + 0.1 * normal;  norm_bias 0.1 * normal
  time_weight    1 / T_in + 0.02 * normal (DLinear's seasonal and trend
                 maps);  time_bias 0.01 * normal
Random biases and norm parameters keep every parameter in play, so a
program that dropped one would disagree with the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .reference import Spec, dlinear_spec, param_spec
from .traffic_gen import sub_seed


def _shape(v: torch.Tensor, kind: str, shape: Tuple[int, ...]) -> torch.Tensor:
    if kind in ("conv", "linear"):
        fan_in = math.prod(shape[1:])
        return v.clamp(-2.0, 2.0) / math.sqrt(fan_in)
    if kind == "bias":
        return 0.02 * v
    if kind == "norm_weight":
        return 1.0 + 0.1 * v
    if kind == "norm_bias":
        return 0.1 * v
    if kind == "time_weight":
        return 1.0 / shape[1] + 0.02 * v
    if kind == "time_bias":
        return 0.01 * v
    raise ValueError(f"unknown parameter kind {kind!r}")


@torch.no_grad()
def draw(spec: Spec, seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        out[name] = _shape(flat[off:off + n].view(shape), kind, shape)
        off += n
    return out


def make(cfg: dict, seed: int, device) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """(VAE weights, DLinear weights), each value already rounded to the
    dtype it is served in and held as float32, so the program and the
    reference get the same numbers."""
    vae_dtype = getattr(torch, cfg["vae_dtype"])
    fc_dtype = getattr(torch, cfg["forecaster_dtype"])
    vae = {k: v.to(vae_dtype).float()
           for k, v in draw(param_spec(cfg["vae"]), seed, 1, device).items()}
    fc = {k: v.to(fc_dtype).float()
          for k, v in draw(dlinear_spec(cfg["forecaster"]), seed, 2, device).items()}
    return vae, fc
