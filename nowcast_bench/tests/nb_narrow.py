"""The benchmark's configurations at widths and a frame size the CPU runs
in seconds, for the CPU tests: each width cut alike in the port and the
reference, nothing else changed."""

from __future__ import annotations

import copy

import torch

from nowcast_bench import harness, system, weights

# Limits at these widths, set from CPU readings over six seeds (2**31 + 1
# to + 6) as the cells' limits are set from chip readings at full width:
# bf16 program / the port's int8 path as control
#   akl_ref   frame_err 0.024-0.051 / 0.134-0.363, window_err 0.014-0.021 / 0.111-0.210
#   akl_fast  frame_err 0.019-0.026 / 0.084-0.158, window_err 0.012-0.015 / 0.066-0.095
# (at 8-16 channels the two overlap: 0.022-0.102 against 0.071-0.645).
NARROW_LIMITS = {"akl_ref": {"frame_err": 0.085, "window_err": 0.04},
                 "akl_fast": {"frame_err": 0.05, "window_err": 0.04}}
HW = 32


def narrow(name: str, dtype: str = "bfloat16") -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", name))
    vae = cfg["vae"]
    vae["block_out_channels"] = ([32, 64, 64, 64, 64] if vae["pixel_unshuffle"] == 1
                                 else [32, 64, 64])
    vae["latent_channels"], vae["norm_num_groups"] = 16, 16
    cfg["frame_hw"] = HW
    cfg["vae_dtype"] = dtype
    cfg["limits"] = dict(NARROW_LIMITS[name])
    return cfg


def draw(cfg: dict, seed: int) -> dict:
    """The weights a run of ``cfg`` draws from ``seed``, on the CPU."""
    return weights.make(system.module(cfg), cfg, seed, torch.device("cpu"))


BATCH = {"kind": "batch", "batch": 2, "pool": 3}
TICK = {"kind": "tick", "tiles": 2, "stream_frames": 20}
