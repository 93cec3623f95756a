"""A toy pixel-space forecaster, a second system for the harness's tests:
the T_in input frames, stacked as channels, go through a 3x3 conv to
``hidden`` channels and SiLU (the ``features`` stage), then a 3x3 conv to
T_out channels, each scaled by a gain of its own (the ``forecast`` stage,
which gives the answer). A tick keeps each tile's last T_in frames, as
float32 in [0, 1], on the device.

The program runs ``torch.nn`` modules in the configuration's ``dtype``
(float32); the control runs them in bfloat16. The reference is written
apart with ``F.conv2d``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nowcast_bench.costs import CallCost
from nowcast_bench.system import System

ANSWER = "forecast"
KINDS = {"gain": lambda v, shape: 1.0 + 0.1 * v}


def weight_groups(cfg: dict) -> list:
    t_in, t_out, hid = cfg["input_frames"], cfg["pred_frames"], cfg["hidden"]
    spec = [("conv1.weight", (hid, t_in, 3, 3), "conv"), ("conv1.bias", (hid,), "bias"),
            ("conv2.weight", (t_out, hid, 3, 3), "conv"), ("conv2.bias", (t_out,), "bias"),
            ("gain", (t_out,), "gain")]
    return [("net", spec, cfg["dtype"], 1)]


def build(cfg: dict, kind: str, weights: dict, device, wrap=None,
          control: bool = False) -> System:
    w = weights["net"]
    dtype = torch.bfloat16 if control else getattr(torch, cfg["dtype"])
    t_in, t_out, hid = cfg["input_frames"], cfg["pred_frames"], cfg["hidden"]
    conv1 = torch.nn.Conv2d(t_in, hid, 3, padding=1, device=device, dtype=dtype)
    conv2 = torch.nn.Conv2d(hid, t_out, 3, padding=1, device=device, dtype=dtype)
    with torch.no_grad():
        for name, conv in (("conv1", conv1), ("conv2", conv2)):
            conv.weight.copy_(w[f"{name}.weight"])
            conv.bias.copy_(w[f"{name}.bias"])
    gain = w["gain"].to(device=device, dtype=dtype)[:, None, None]

    def to_input(frames):
        return torch.from_numpy(frames).to(device).float() / 255.0

    def features(x):                              # (B, T_in, 1, H, W) -> (B, hid, H, W)
        return F.silu(conv1(x[:, :, 0].to(dtype)))

    def forecast(h):                              # -> (B, T_out, 1, H, W) float32
        return (conv2(h) * gain).float()[:, :, None]

    if wrap is not None:
        features, forecast = wrap("features", features), wrap(ANSWER, forecast)

    @torch.no_grad()
    def pipeline(params, frames):
        return forecast(params(to_input(frames)))

    @torch.no_grad()
    def step(params, window, frame):
        window = torch.cat([window[:, 1:], to_input(frame)[:, None]], dim=1)
        return window, forecast(params(window))

    return System(features, pipeline=pipeline, init=to_input, step=step)


@torch.no_grad()
def reference(weights: dict, cfg: dict, frames: torch.Tensor, block: int):
    w = weights["net"]
    x = frames.to(torch.float32) / 255.0
    out = []
    for i in range(0, x.shape[0], block):
        h = F.silu(F.conv2d(x[i:i + block, :, 0], w["conv1.weight"], w["conv1.bias"],
                            padding=1))
        y = F.conv2d(h, w["conv2.weight"], w["conv2.bias"], padding=1)
        out.append(y * w["gain"][:, None, None])
    return torch.cat(out)[:, :, None], x


def call_cost(cfg: dict, batch: int, frames_in_per_seq: int) -> CallCost:
    """Both convs over every sequence of the call (a tick forecasts from its
    whole window)."""
    hw2 = cfg["frame_hw"] ** 2
    per_seq = 2 * hw2 * 9 * cfg["hidden"] * (cfg["input_frames"] + cfg["pred_frames"])
    return CallCost(batch * per_seq, [], 4)
