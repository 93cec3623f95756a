"""Path B: the port's rollout over a frozen ``AutoencoderKL`` and a latent
forecaster, assembled from its public pieces as
``experiments_gpu/perf/bench_helpers.py::build_pipeline`` assembles it,
with the benchmark's weights.

  * ``AutoencoderKL`` in the configuration's ``vae_dtype`` (bf16) and
    ``conv_mode``, encode -> posterior mode, decode; its weights loaded
    with ``load_state_dict(strict=True)``;
  * the forecaster: ``DLinear(T_in -> T_out)`` (``forecaster.kind``
    "dlinear", the only kind served here) in ``forecaster_dtype`` (fp32),
    loaded the same way;
  * ``models/rollout.py::make_forecast_pipeline`` for a batch mix, and
    ``make_streaming_forecaster``'s ``init`` and ``step`` for a tick mix,
    whose state is each tile's latent window.

Frames reach the port as uint8 numpy arrays in host memory; the port's
``to_input`` copies and dequantises them. The control is the port's own
int8 path (``conv_mode="int8"``: per-tensor dynamic activation scales,
per-channel weight scales), the precision below bf16. The reference is
``reference.py``. The port is imported only when the program is built, so
the weights, the reference and the counts load without it.

Counts (``call_cost``): a 3x3 conv over an Ho x Wo output counts
2 * Ho * Wo * Cin * Cout * 9; attention over P positions of C channels
counts four C x C linear maps (2 * P * C * C each) and the two P x P
products (2 * P * P * C each); DLinear counts two (T_out x T_in) maps over
every latent element. GroupNorm, SiLU, the upsample, the adds and the casts
count no FLOPs.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from nowcast_bench import reference as ref
from nowcast_bench.costs import DTYPE_BYTES, CallCost
from nowcast_bench.system import System

CONTROL_MODE = "int8"
ANSWER = "decode"
KINDS = {  # DLinear's seasonal and trend maps over time
    "time_weight": lambda v, shape: 1.0 / shape[1] + 0.02 * v,
    "time_bias": lambda v, shape: 0.01 * v,
}


def _dlinear(cfg: dict) -> dict:
    """The forecaster's settings; any kind but "dlinear" is refused."""
    f = cfg["forecaster"]
    if f.get("kind") != "dlinear":
        raise ValueError(f"system pathb_akl serves the forecaster kind 'dlinear' only; "
                         f"configuration {cfg.get('name')!r} asks for {f.get('kind')!r}")
    return f


def weight_groups(cfg: dict) -> list:
    """The VAE on stream 1, DLinear on stream 2, each in its served dtype."""
    return [("vae", ref.param_spec(cfg["vae"]), cfg["vae_dtype"], 1),
            ("forecaster", ref.dlinear_spec(_dlinear(cfg)), cfg["forecaster_dtype"], 2)]


def modules(cfg: dict, weights: Dict[str, Dict[str, torch.Tensor]], device,
            conv_mode: Optional[str] = None):
    """(AutoencoderKL, DLinear) of the port, holding ``weights``."""
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    f = _dlinear(cfg)
    dtype = getattr(torch, cfg["vae_dtype"])
    vae = AutoencoderKL(**cfg["vae"], conv_mode=conv_mode or cfg["conv_mode"],
                        device=device).to(dtype)
    vae.load_state_dict({k: v.to(dtype) for k, v in weights["vae"].items()}, strict=True)
    vae.eval()
    fc = DLinear(f["seq_len"], f["pred_len"], kernel_size=f["kernel_size"],
                 device=device).to(getattr(torch, cfg["forecaster_dtype"]))
    fc.load_state_dict(weights["forecaster"], strict=True)
    return vae, fc


def build(cfg: dict, kind: str, weights: Dict[str, Dict[str, torch.Tensor]], device,
          wrap=None, control: bool = False) -> System:
    """The port's entry for a ``kind`` mix; ``wrap`` may wrap the encode
    and decode callables handed to the rollout."""
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline, make_streaming_forecaster)
    vae, fc = modules(cfg, weights, device, CONTROL_MODE if control else None)
    dtype = getattr(torch, cfg["vae_dtype"])

    def encode_apply(x):
        return vae.encode(x.to(dtype)).mode().float()

    def decode_apply(z):
        return vae.decode(z.to(dtype)).float()

    if wrap is not None:
        encode_apply, decode_apply = wrap("encode", encode_apply), wrap("decode", decode_apply)
    kw = dict(encode_apply=encode_apply, decode_apply=decode_apply,
              forecaster_apply=lambda m, z: m(z),
              input_frames=cfg["input_frames"], pred_frames=cfg["pred_frames"],
              residual_anchor=cfg["residual_anchor"], device=device)
    system = System(fc)
    if kind == "batch":
        system.pipeline = make_forecast_pipeline(**kw)
    else:
        lhw = ref.latent_hw(cfg)
        system.init, system.step = make_streaming_forecaster(
            latent_shape=(cfg["vae"]["latent_channels"], lhw, lhw), **kw)
    return system


def reference(weights, cfg: dict, frames: torch.Tensor, block: int):
    """(forecast frames, latent window): ``reference.rollout``."""
    return ref.rollout(weights["vae"], weights["forecaster"], cfg, frames, block)


class Frame(NamedTuple):
    """Per-frame work of one VAE half: FLOPs, and each GroupNorm call as
    (C, H, W, silu)."""
    flops: int
    gn: List[tuple]


def _walk(vae: dict, hw: int, half: str) -> Frame:
    boc = list(vae["block_out_channels"])
    n, lpb, lat = len(boc), vae["layers_per_block"], vae["latent_channels"]
    f = vae.get("pixel_unshuffle", 1)
    flops, gn = 0, []

    def conv(h, cin, cout, k):
        nonlocal flops
        flops += 2 * h * h * cin * cout * k * k

    def resnet(h, cin, cout):
        gn.append((cin, h, h, True))
        conv(h, cin, cout, 3)
        gn.append((cout, h, h, True))
        conv(h, cout, cout, 3)
        if cin != cout:
            conv(h, cin, cout, 1)

    def mid(h, c):
        nonlocal flops
        resnet(h, c, c)
        gn.append((c, h, h, False))
        p = h * h
        flops += 4 * 2 * p * c * c + 2 * 2 * p * p * c
        resnet(h, c, c)

    if half == "encode":
        h = hw // f
        conv(h, vae["in_channels"] * f * f, boc[0], 3)
        for i, ch in enumerate(boc):
            for j in range(lpb):
                resnet(h, boc[max(i - 1, 0)] if j == 0 else ch, ch)
            if i != n - 1:
                h //= 2
                conv(h, ch, ch, 3)
        mid(h, boc[-1])
        gn.append((boc[-1], h, h, True))
        conv(h, boc[-1], 2 * lat, 3)
        conv(h, 2 * lat, 2 * lat, 1)
    else:
        rev = boc[::-1]
        h = hw // (f * 2 ** (n - 1))
        conv(h, lat, lat, 1)
        conv(h, lat, rev[0], 3)
        mid(h, rev[0])
        for i, ch in enumerate(rev):
            for j in range(lpb + 1):
                resnet(h, rev[max(i - 1, 0)] if j == 0 else ch, ch)
            if i != n - 1:
                h *= 2
                conv(h, ch, ch, 3)
        gn.append((rev[-1], h, h, True))
        conv(h, rev[-1], vae["out_channels"] * f * f, 3)
    return Frame(flops, gn)


def call_cost(cfg: dict, batch: int, frames_in_per_seq: int) -> CallCost:
    """One call over ``batch`` sequences that encodes ``frames_in_per_seq``
    frames a sequence and decodes T_out."""
    vae, hw = cfg["vae"], cfg["frame_hw"]
    enc, dec = _walk(vae, hw, "encode"), _walk(vae, hw, "decode")
    n_enc = batch * frames_in_per_seq
    n_dec = batch * cfg["pred_frames"]
    fc = _dlinear(cfg)
    d = vae["latent_channels"] * ref.latent_hw(cfg) ** 2
    dl = 2 * 2 * batch * d * fc["seq_len"] * fc["pred_len"]
    gn = ([(n_enc,) + g for g in enc.gn] + [(n_dec,) + g for g in dec.gn])
    return CallCost(n_enc * enc.flops + n_dec * dec.flops + dl, gn,
                    DTYPE_BYTES[cfg["vae_dtype"]])


def nvcc_seconds() -> float:
    """Seconds nvcc took in this process to build the GroupNorm kernel (0.0
    when its library was already in the checkout's build directory)."""
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    return groupnorm.build_seconds
