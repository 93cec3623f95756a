"""Weights from the run's seed, drawn on the card, one call a group.

A system module's ``weight_groups(cfg)`` lists its parameters in groups
``(group, spec, dtype, stream)``. Each group is one ``torch.randn`` over
every parameter of its ``spec``, from a ``torch.Generator`` on the run's
device seeded by stream ``stream`` of the run's seed, shaped per kind:
  conv, linear   standard normal clipped at 2, over sqrt(fan_in)
  bias           0.02 * normal
  norm_weight    1 + 0.1 * normal;  norm_bias 0.1 * normal
and by the module's own ``KINDS`` beside these. Random biases and norm
parameters keep every parameter in play, so a program that dropped one
would disagree with the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from .traffic_gen import sub_seed

Kinds = Dict[str, Callable[[torch.Tensor, Tuple[int, ...]], torch.Tensor]]


def _shape(v: torch.Tensor, kind: str, shape: Tuple[int, ...],
           kinds: Optional[Kinds] = None) -> torch.Tensor:
    if kinds and kind in kinds:
        return kinds[kind](v, shape)
    if kind in ("conv", "linear"):
        fan_in = math.prod(shape[1:])
        return v.clamp(-2.0, 2.0) / math.sqrt(fan_in)
    if kind == "bias":
        return 0.02 * v
    if kind == "norm_weight":
        return 1.0 + 0.1 * v
    if kind == "norm_bias":
        return 0.1 * v
    raise ValueError(f"unknown parameter kind {kind!r}")


@torch.no_grad()
def draw(spec, seed: int, stream: int, device,
         kinds: Optional[Kinds] = None) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``spec``."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, stream))
    total = sum(math.prod(shape) for _, shape, _ in spec)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        out[name] = _shape(flat[off:off + n].view(shape), kind, shape, kinds)
        off += n
    return out


def make(mod, cfg: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{group: {name: tensor}} of system module ``mod`` for ``cfg``, each
    value already rounded to the dtype it is served in and held as float32,
    so the program and the reference get the same numbers."""
    kinds = getattr(mod, "KINDS", None)
    out = {}
    for group, spec, dtype, stream in mod.weight_groups(cfg):
        d = getattr(torch, dtype)
        out[group] = {k: v.to(d).float()
                      for k, v in draw(spec, seed, stream, device, kinds).items()}
    return out
