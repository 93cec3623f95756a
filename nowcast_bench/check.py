"""Whether what the timed path produced is right: the window's sampled
answers against the plain float32 reference (``reference.py``), which
works everything out again from the frames the benchmark gave both sides
and the benchmark's weights.

Numbers compared, each against the configuration's ``limits``:
  frame_err   the widest relative gap of one forecast frame over every
              frame of every sampled answer: ||y - y_ref|| / ||y_ref||, the
              denominator floored at the median frame's norm (so a nearly
              empty frame does not blow up); covers encode, the residual
              anchor, DLinear and decode;
  window_err  (tick mixes) the same over each tile's latent window as the
              port holds it after the tick, against the reference's encode
              of that tile's last T_in frames.
A non-finite value reads as infinite, and a limit not yet set fails.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from . import reference
from .traffic_gen import tick_window

# frames the reference encodes or decodes at a time
REF_BLOCK = 128


def widest_gap(out: torch.Tensor, ref: torch.Tensor, rows: int) -> float:
    """max over the ``rows`` leading rows of ||out - ref|| / max(||ref||,
    median ||ref||)."""
    a = out.reshape(rows, -1).double()
    b = ref.reshape(rows, -1).double()
    if not torch.isfinite(a).all():
        return float("inf")
    num = torch.linalg.vector_norm(a - b, dim=1)
    den = torch.linalg.vector_norm(b, dim=1)
    den = torch.clamp(den, min=float(den.median()))
    return float((num / den).max())


def readings(cfg: dict, kind: str, samples: List, inputs: np.ndarray,
             mix: dict, vae_w, fc_w, device) -> Dict[str, float]:
    """The compared numbers over the sampled answers."""
    frame_err, window_err = 0.0, 0.0
    with reference.strict_fp32():
        for item in samples:
            if kind == "batch":
                p, out = item
                frames = inputs[p]
            else:
                tick, out, window = item
                frames = tick_window(cfg, mix, inputs, tick)
            ref, z = reference.rollout(vae_w, fc_w, cfg,
                                       torch.from_numpy(frames).to(device), REF_BLOCK)
            rows = out.shape[0] * out.shape[1]
            frame_err = max(frame_err, widest_gap(out, ref, rows))
            if kind == "tick":
                window_err = max(window_err, widest_gap(window, z, z.shape[0]))
            del ref, z
    nums = {"frame_err": frame_err}
    if kind == "tick":
        nums["window_err"] = window_err
    return nums


def judge(nums: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
