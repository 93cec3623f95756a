"""The system under test: the port's Path-B rollout, assembled from its
public pieces as ``experiments_gpu/perf/bench_helpers.py::build_pipeline``
assembles it, with the benchmark's weights.

  * ``AutoencoderKL`` in the configuration's dtype (bf16) and conv mode,
    encode -> posterior mode, decode; its weights loaded with
    ``load_state_dict(strict=True)``;
  * ``DLinear(T_in -> T_out)`` in the forecaster's dtype (fp32), loaded
    the same way;
  * ``models/rollout.py::make_forecast_pipeline`` for a batch mix, and
    ``make_streaming_forecaster``'s ``init`` and ``step`` for a tick mix.

Frames reach the port as uint8 numpy arrays in host memory; the port's
``to_input`` copies and dequantises them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
from weatherforecastingtoolkit_tpu_torch.models.rollout import (
    make_forecast_pipeline, make_streaming_forecaster)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)

from .reference import latent_hw


@dataclass
class System:
    vae: torch.nn.Module
    fc: torch.nn.Module
    pipeline: Optional[Callable] = None   # batch: (fc, frames) -> forecast
    init: Optional[Callable] = None       # tick: frames -> latent window
    step: Optional[Callable] = None       # tick: (fc, window, frame) -> (window, forecast)


def build(cfg: dict, kind: str, vae_w: Dict[str, torch.Tensor],
          fc_w: Dict[str, torch.Tensor], device,
          wrap: Optional[Callable[[str, Callable], Callable]] = None,
          conv_mode: Optional[str] = None) -> System:
    """The port's entry for a ``kind`` ("batch" or "tick") mix. ``wrap(name,
    fn)`` may wrap the encode and decode callables handed to the rollout
    (the traced run times them); ``conv_mode`` overrides the
    configuration's (the control runs the port's int8 path)."""
    dtype = getattr(torch, cfg["vae_dtype"])
    vae = AutoencoderKL(**cfg["vae"], conv_mode=conv_mode or cfg["conv_mode"],
                        device=device).to(dtype)
    vae.load_state_dict({k: v.to(dtype) for k, v in vae_w.items()}, strict=True)
    vae.eval()
    f = cfg["forecaster"]
    fc = DLinear(f["seq_len"], f["pred_len"], kernel_size=f["kernel_size"],
                 device=device).to(getattr(torch, cfg["forecaster_dtype"]))
    fc.load_state_dict(fc_w, strict=True)

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
    system = System(vae, fc)
    if kind == "batch":
        system.pipeline = make_forecast_pipeline(**kw)
    else:
        lhw = latent_hw(cfg)
        system.init, system.step = make_streaming_forecaster(
            latent_shape=(cfg["vae"]["latent_channels"], lhw, lhw), **kw)
    return system


def nvcc_seconds() -> float:
    """Seconds nvcc took in this process to build the GroupNorm kernel (0.0
    when its library was already in the checkout's build directory)."""
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    return groupnorm.build_seconds
