"""Standard training tasks (counterpart of
weatherforecastingtoolkit_tpu/training/tasks.py): pixel losses, on-device
dequantisation, frame reconstruction, and latent forecasting on a frozen
autoencoder (Path-B training: the forecaster learns to predict the frozen
encoder's latents, residual-anchored on the last input latent).

All T frames fold into the batch axis for one model call. The frozen
encoder runs under ``torch.no_grad``: its weights get no gradient, and its
GroupNorms run forward only.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from ..ops.amp import cast_call, to_f32
from .trainer import Task


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B*T, C, H, W)."""
    b, t = x.shape[:2]
    return x.reshape((b * t,) + tuple(x.shape[2:]))


def _unframes(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    return x.reshape((b, t) + tuple(x.shape[1:]))


def pixel_loss(kind: str) -> Callable:
    if kind == "l1":
        return lambda a, b: torch.mean(torch.abs(a - b))
    if kind == "mse":
        return lambda a, b: torch.mean((a - b) ** 2)
    if kind == "huber":
        def huber(a, b, delta=1.0):
            d = a - b
            ad = torch.abs(d)
            return torch.mean(torch.where(ad <= delta, 0.5 * d * d,
                                          delta * (ad - 0.5 * delta)))
        return huber
    raise ValueError(kind)


def dequantize(x: torch.Tensor) -> torch.Tensor:
    """uint8 batches are shipped raw and dequantized on the device; float
    batches pass through."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


def reconstruction_task(model: torch.nn.Module, key: str = "vil",
                        loss: str = "l1", name: str = "recon",
                        mixed_precision: bool = False) -> Task:
    """Frame autoencoder objective. Batch: {key: (B, T, C, H, W)}; ``model``
    (``PosAwareAE``, ...) maps frames to (recon, z), and ``init_params``
    hands the trainer a copy of it on the trainer's device.

    mixed_precision=True runs the network forward and backward in bf16 on
    copies of the fp32 master parameters (``ops/amp.py``); the loss
    reduction stays fp32."""
    loss_fn_px = pixel_loss(loss)

    def init_params(seed, device):
        return copy.deepcopy(model).to(device)

    def loss_fn(model, batch, rng, step):
        frames = _frames(dequantize(batch[key]))
        if mixed_precision:
            recon, z = to_f32(cast_call(
                lambda m, f: m(f, deterministic=False), model, frames))
        else:
            recon, z = model(frames, deterministic=False)
        return loss_fn_px(recon, frames), {
            "latent_norm": torch.mean(torch.abs(z)).detach()}

    def eval_fn(model, batch, rng):
        x = dequantize(batch[key])
        b, t = x.shape[:2]
        with torch.no_grad():
            recon, _ = model(_frames(x))
        return _unframes(recon, b, t), x

    return Task(name=name, init_params=init_params, loss_fn=loss_fn,
                eval_fn=eval_fn)


def latent_forecast_task(frozen_ae_apply: Callable, forecaster: torch.nn.Module,
                         input_frames: int, pred_frames: int,
                         latent_shape, decode_apply: Optional[Callable] = None,
                         key: str = "vil", name: str = "latent_forecast",
                         residual_anchor: bool = True,
                         channel_fold: bool = False) -> Task:
    """Forecast a frozen encoder's latents; MSE in latent space.

    frozen_ae_apply(frames (N,C,H,W), rng) -> latents (N, *latent_shape);
    decode_apply(latents) -> frames, used only for eval. ``forecaster`` is
    the module to train: ``init_params`` hands the trainer a copy of it on
    the trainer's device. ``residual_anchor`` subtracts the last input
    latent. ``channel_fold=True`` folds latent channels into the sequence
    axis: the forecaster sees (B, T*C, h*w); size it with
    seq_len=input_frames*C, pred_len=pred_frames*C.
    """
    c_lat = int(latent_shape[0]) if channel_fold else 1

    def _fold(z, b, t):
        # (B, T, C, hw) -> (B, T*C, hw) | identity for the flat layout
        return z.reshape(b, t * c_lat, -1) if channel_fold else z

    def init_params(seed, device):
        return copy.deepcopy(forecaster).to(device)

    def _encode_seq(x, rng):
        b, t = x.shape[:2]
        with torch.no_grad():
            z = frozen_ae_apply(_frames(x), rng)      # (B*T, *latent_shape)
        if channel_fold:
            return z.reshape(b, t, c_lat, -1)         # (B, T, C, hw)
        return z.reshape(b, t, -1)                    # (B, T, D)

    def _split_anchor(z):
        # the anchor (last input frame) broadcasts over the time axis,
        # per-channel in the 4-D channel_fold layout
        inp, tgt = z[:, :input_frames], z[:, input_frames:]
        if residual_anchor:
            anchor = inp[:, -1:]
            return inp - anchor, tgt - anchor, anchor
        return inp, tgt, torch.zeros_like(inp[:, -1:])

    def loss_fn(model, batch, rng, step):
        x = dequantize(batch[key])
        b = x.shape[0]
        inp, tgt, _ = _split_anchor(_encode_seq(x, rng))
        pred = model(_fold(inp, b, input_frames))
        return torch.mean((pred - _fold(tgt, b, pred_frames)) ** 2), {}

    def eval_fn(model, batch, rng):
        x = dequantize(batch[key])
        b = x.shape[0]
        inp, tgt, anchor = _split_anchor(_encode_seq(x, rng))
        with torch.no_grad():
            pred = model(_fold(inp, b, input_frames))
        if channel_fold:
            pred = pred.reshape(tgt.shape)
        pred = pred + anchor
        tgt = tgt + anchor
        if decode_apply is None:
            # latent-space "images" for loss-only eval
            if channel_fold:
                pred = pred.reshape(b, pred_frames, -1)
                tgt = tgt.reshape(b, pred_frames, -1)
            return pred[..., None, None, :], tgt[..., None, None, :]
        shp = (b * pred_frames,) + tuple(latent_shape)
        with torch.no_grad():
            dec_pred = decode_apply(pred.reshape(shp))
            dec_tgt = decode_apply(tgt.reshape(shp))
        return (_unframes(dec_pred, b, pred_frames),
                _unframes(dec_tgt, b, pred_frames))

    return Task(name=name, init_params=init_params, loss_fn=loss_fn,
                eval_fn=eval_fn)
