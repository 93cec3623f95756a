"""Whether what the timed path produced is right: the window's sampled
answers against the system module's plain float32 reference, which works
everything out again from the frames the benchmark gave both sides and the
benchmark's weights, with TF32 off.

Numbers compared, each against the configuration's ``limits``:
  frame_err   the widest relative gap of one forecast frame over every
              frame of every sampled answer: ||y - y_ref|| / ||y_ref||, the
              denominator floored at the median frame's norm (so a nearly
              empty frame does not blow up); covers every stage the answer
              passes through;
  window_err  (tick mixes) the same over each tile's state as the program
              holds it after the tick, against the reference's state for
              that tile's last T_in frames.
A non-finite value reads as infinite, and a limit not yet set fails.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from .traffic_gen import tick_window

# frames the reference encodes or decodes at a time
REF_BLOCK = 128


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """float32 matrix products and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


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
             mix: dict, reference: Callable, weights: dict,
             device) -> Dict[str, float]:
    """The compared numbers over the sampled answers; ``reference`` is the
    system module's."""
    frame_err, window_err = 0.0, 0.0
    with strict_fp32():
        for item in samples:
            if kind == "batch":
                p, out = item
                frames = inputs[p]
            else:
                tick, out, window = item
                frames = tick_window(cfg, mix, inputs, tick)
            ref, state = reference(weights, cfg, torch.from_numpy(frames).to(device),
                                   REF_BLOCK)
            rows = out.shape[0] * out.shape[1]
            frame_err = max(frame_err, widest_gap(out, ref, rows))
            if kind == "tick":
                window_err = max(window_err, widest_gap(window, state, state.shape[0]))
            del ref, state
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
