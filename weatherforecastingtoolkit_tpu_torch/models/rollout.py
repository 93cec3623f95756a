"""The latent forecast rollout in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/rollout.py): the Path-B serving path.

Encode frames with a frozen VAE (all T frames folded into the batch),
residual-anchor the latents on the last input latent, forecast with a latent
temporal model, add the anchor back, decode to pixels. uint8 frames are
dequantised on the device. The returned functions run under
``torch.inference_mode``: they serve, they do not train.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..utils.device import DeviceLike, resolve_device


def persistence_baseline(frames_in: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Repeat the last input frame n_steps times: (B,T,C,H,W) -> (B,n,C,H,W)."""
    return frames_in[:, -1:].repeat_interleave(n_steps, dim=1)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _unfold(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    return x.reshape((b, t) + x.shape[1:])


def _make_input(device: torch.device, dequantize: bool) -> Callable:
    """Frames (numpy or tensor) -> a tensor on `device`, uint8 -> [0, 1]."""

    def to_input(frames) -> torch.Tensor:
        x = torch.as_tensor(frames, device=device)
        if dequantize and x.dtype == torch.uint8:
            x = x.to(torch.float32) * (1.0 / 255.0)
        return x

    return to_input


def _make_forecast_decode(decode_apply: Callable, forecaster_apply: Callable,
                          pred_frames: int, residual_anchor: bool,
                          autoregressive: bool) -> Callable:
    """Shared latent-forecast-and-decode core: (fc_params, z (B,T_in,D),
    latent_shape) -> frames (B, pred_frames, C, H, W)."""

    def forecast_decode(fc_params, z, latent_shape):
        b = z.shape[0]
        anchor = z[:, -1:] if residual_anchor else torch.zeros_like(z[:, -1:])
        zin = z - anchor
        if not autoregressive:
            zpred = forecaster_apply(fc_params, zin)          # (B, T_out, D)
        else:
            window, steps = zin, []
            for _ in range(pred_frames):
                nxt = forecaster_apply(fc_params, window)[:, :1]  # one step
                window = torch.cat([window[:, 1:], nxt], dim=1)
                steps.append(nxt)
            zpred = torch.cat(steps, dim=1)                   # (B, T_out, D)
        zpred = zpred + anchor
        frames = decode_apply(zpred.reshape((b * pred_frames,) + latent_shape))
        return _unfold(frames, b, pred_frames)

    return forecast_decode


def make_forecast_pipeline(
    *,
    encode_apply: Callable,   # (frames (N,C,H,W)) -> latents (N, ...)
    decode_apply: Callable,   # (latents (N, ...)) -> frames (N,C,H,W)
    forecaster_apply: Callable,  # (fc_params, (B,T,D)) -> (B,T_out,D)
    input_frames: int,
    pred_frames: int,
    residual_anchor: bool = True,
    autoregressive: bool = False,
    dequantize: bool = True,
    device: DeviceLike = None,
) -> Callable:
    """Build pipeline(fc_params, frames_in) -> predicted frames.

    frames_in: (B, input_frames, C, H, W) float in [0,1] or uint8, a tensor
    or array; it is moved to `device` (default ``cuda``). Returns
    (B, pred_frames, C, H, W). autoregressive=True forecasts ONE latent step
    per iteration with a sliding window; False emits all pred_frames at once.
    """
    to_input = _make_input(resolve_device(device), dequantize)
    forecast_decode = _make_forecast_decode(
        decode_apply, forecaster_apply, pred_frames, residual_anchor,
        autoregressive)

    @torch.inference_mode()
    def pipeline(fc_params, frames_in):
        x = to_input(frames_in)
        b = x.shape[0]
        z = encode_apply(_fold(x))                    # (B*T_in, ...)
        latent_shape = tuple(z.shape[1:])
        z = z.reshape(b, input_frames, -1)            # NCHW flatten order
        return forecast_decode(fc_params, z, latent_shape)

    return pipeline


def make_streaming_forecaster(
    *,
    encode_apply: Callable,   # (frames (N,C,H,W)) -> latents (N, ...)
    decode_apply: Callable,   # (latents (N, ...)) -> frames (N,C,H,W)
    forecaster_apply: Callable,  # (fc_params, (B,T,D)) -> (B,T_out,D)
    input_frames: int,
    pred_frames: int,
    latent_shape: Tuple[int, ...],
    residual_anchor: bool = True,
    autoregressive: bool = False,
    dequantize: bool = True,
    device: DeviceLike = None,
) -> Tuple[Callable, Callable]:
    """Operational (streaming) serving: keep a sliding LATENT window so each
    new radar frame costs one frame encode + forecast + decode.

    Returns (init, step):
      init(frames_in (B, input_frames, C, H, W)) -> state   (latent window)
      step(fc_params, state, frame (B, C, H, W)) -> (state, forecast)
    with forecast (B, pred_frames, C, H, W) equal to the batch pipeline run
    on the window ending at `frame`.
    """
    to_input = _make_input(resolve_device(device), dequantize)
    forecast_decode = _make_forecast_decode(
        decode_apply, forecaster_apply, pred_frames, residual_anchor,
        autoregressive)
    latent_shape = tuple(latent_shape)

    @torch.inference_mode()
    def init(frames_in):
        x = to_input(frames_in)
        return encode_apply(_fold(x)).reshape(x.shape[0], input_frames, -1)

    @torch.inference_mode()
    def step(fc_params, z_window, frame):
        x = to_input(frame)
        z_new = encode_apply(x).reshape(x.shape[0], 1, -1)
        z_window = torch.cat([z_window[:, 1:], z_new], dim=1)
        return z_window, forecast_decode(fc_params, z_window, latent_shape)

    return init, step
