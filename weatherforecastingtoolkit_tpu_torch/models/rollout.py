"""The latent forecast rollout in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/rollout.py): the Path-B serving path.

Encode frames with a frozen VAE (all T frames folded into the batch),
residual-anchor the latents on the last input latent, forecast with a latent
temporal model, add the anchor back, decode to pixels. uint8 frames are
dequantised on the device. The returned functions run under
``torch.inference_mode``: they serve, they do not train.

The probabilistic rollout (``make_ensemble_pipeline``) writes the members
out as a batch dimension: N members of B sequences go through one
forecast and one decode of N*B sequences, with their noise drawn from an
explicit ``torch.Generator``. ``make_eval_fn``, ``make_ensemble_eval_fn``,
``calibrate_noise_std`` and ``evaluate_vs_persistence`` feed the metrics.

Each entry point is a call span (``training/profiling.py::span``:
``wftk.pipeline``, ``wftk.init``, ``wftk.step``, ``wftk.ensemble``) around
the spans of its layers: ``wftk.input`` (the copy and dequantise, counting
the ``bytes`` taken from host memory to a CUDA device), ``wftk.encode``,
``wftk.window`` (the tick's latent window), ``wftk.forecast`` (the anchor,
the forecaster and the add-back) and ``wftk.decode``. They sit around the
calls of the callables the caller hands in, never inside them, so a
caller's own spans there stay innermost. Spans are on only while a
``torch.profiler`` session is open.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..training.profiling import span
from ..utils.device import DeviceLike, resolve_device


def persistence_baseline(frames_in: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Repeat the last input frame n_steps times: (B,T,C,H,W) -> (B,n,C,H,W)."""
    return frames_in[:, -1:].repeat_interleave(n_steps, dim=1)


def _fold(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _unfold(x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    return x.reshape((b, t) + x.shape[1:])


def _host_bytes(frames, device: torch.device) -> int:
    """Bytes ``to_input`` takes from host memory (a numpy array or a CPU
    tensor) to a CUDA ``device``: 0 when the frames stay on the host or are
    already on a CUDA device."""
    if device.type != "cuda" or (isinstance(frames, torch.Tensor) and frames.is_cuda):
        return 0
    return frames.nbytes


def _make_input(device: torch.device, dequantize: bool) -> Callable:
    """Frames (numpy or tensor) -> a tensor on `device`, uint8 -> [0, 1]."""

    def to_input(frames) -> torch.Tensor:
        with span("wftk.input") as on:
            if on is not None:
                on.counts["bytes"] = _host_bytes(frames, device)
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
        with span("wftk.forecast"):
            anchor = z[:, -1:] if residual_anchor else torch.zeros_like(z[:, -1:])
            zin = z - anchor
            if not autoregressive:
                zpred = forecaster_apply(fc_params, zin)      # (B, T_out, D)
            else:
                window, steps = zin, []
                for _ in range(pred_frames):
                    nxt = forecaster_apply(fc_params, window)[:, :1]  # one step
                    window = torch.cat([window[:, 1:], nxt], dim=1)
                    steps.append(nxt)
                zpred = torch.cat(steps, dim=1)               # (B, T_out, D)
            zpred = zpred + anchor
        with span("wftk.decode"):
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
        with span("wftk.pipeline"):
            x = to_input(frames_in)
            b = x.shape[0]
            with span("wftk.encode"):
                z = encode_apply(_fold(x))            # (B*T_in, ...)
                latent_shape = tuple(z.shape[1:])
                z = z.reshape(b, input_frames, -1)    # NCHW flatten order
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
        with span("wftk.init"):
            x = to_input(frames_in)
            with span("wftk.encode"):
                return encode_apply(_fold(x)).reshape(x.shape[0], input_frames, -1)

    @torch.inference_mode()
    def step(fc_params, z_window, frame):
        with span("wftk.step"):
            x = to_input(frame)
            with span("wftk.encode"):
                z_new = encode_apply(x).reshape(x.shape[0], 1, -1)
            with span("wftk.window"):
                z_window = torch.cat([z_window[:, 1:], z_new], dim=1)
            return z_window, forecast_decode(fc_params, z_window, latent_shape)

    return init, step


def make_ensemble_pipeline(
    *,
    encode_apply: Callable,   # (frames (N,C,H,W)) -> latents (N, ...)
    decode_apply: Callable,   # (latents (N, ...)) -> frames (N,C,H,W)
    forecaster_apply: Callable,  # (fc_params, (B,T,D)) -> (B,T_out,D)
    input_frames: int,
    pred_frames: int,
    n_members: int,
    encode_sample_apply: Optional[Callable] = None,  # (generator, frames) -> latents
    residual_anchor: bool = True,
    autoregressive: bool = False,
    dequantize: bool = True,
    device: DeviceLike = None,
) -> Callable:
    """Build ensemble(fc_params, frames_in, generator, noise_std) ->
    (B, n_members, pred_frames, C, H, W), a probabilistic rollout whose
    output plugs into ``calc_metrics``' ensemble axis.

    Spread sources (composable):
      * latent noise: member m adds noise_std * eps_m to the input latents,
        eps (n_members, B, T_in, D) standard normal, drawn in one call from
        ``generator`` (on its device);
      * posterior sampling: with encode_sample_apply(generator, frames) ->
        latents, each member encodes its own posterior sample: the frames
        are tiled n_members times through one call, before the noise draw.

    Members are a batch dimension: when encode_sample_apply is None the
    deterministic encoder runs once for the B sequences and only the
    forecast and decode run on n_members * B.
    """
    to_input = _make_input(resolve_device(device), dequantize)
    forecast_decode = _make_forecast_decode(
        decode_apply, forecaster_apply, pred_frames, residual_anchor,
        autoregressive)

    @torch.inference_mode()
    def ensemble(fc_params, frames_in, generator: torch.Generator,
                 noise_std: float):
        with span("wftk.ensemble"):
            x = to_input(frames_in)
            b, n = x.shape[0], n_members
            flat = _fold(x)                           # (B*T_in, C, H, W)
            with span("wftk.encode"):                 # the members' latents
                if encode_sample_apply is None:
                    z = encode_apply(flat)
                    latent_shape = tuple(z.shape[1:])
                    z = z.reshape(1, b, input_frames, -1).expand(n, -1, -1, -1)
                else:
                    z = encode_sample_apply(generator, flat.repeat(
                        (n,) + (1,) * (flat.ndim - 1)))   # (N*B*T_in, ...)
                    latent_shape = tuple(z.shape[1:])
                    z = z.reshape(n, b, input_frames, -1)
                eps = torch.randn(z.shape, generator=generator,
                                  device=generator.device)
                zn = z + noise_std * eps.to(z.device)
            out = forecast_decode(fc_params, zn.reshape(n * b, input_frames, -1),
                                  latent_shape)       # (N*B, T_out, C, H, W)
            return out.reshape((n, b) + tuple(out.shape[1:])).transpose(0, 1)

    return ensemble


def _make_seq_split(input_frames: int, pred_frames: int, device,
                    dequantize: bool) -> Callable:
    to_input = _make_input(resolve_device(device), dequantize)

    def split(seq):
        x = to_input(seq)
        return (x[:, :input_frames],
                x[:, input_frames:input_frames + pred_frames])

    return split


def make_ensemble_eval_fn(ensemble: Callable, input_frames: int,
                          pred_frames: int, dequantize: bool = True,
                          device: DeviceLike = None) -> Callable:
    """(fc_params, full_seq (B,T_in+T_out,C,H,W), generator, noise_std) ->
    (ens_pred (B,N,T_out,C,H,W), target, persistence)."""
    split = _make_seq_split(input_frames, pred_frames, device, dequantize)

    def eval_fn(fc_params, seq, generator, noise_std):
        frames_in, target = split(seq)
        pred = ensemble(fc_params, frames_in, generator, noise_std)
        return pred, target, persistence_baseline(frames_in, pred_frames)

    return eval_fn


def batch_generator(seed: int, index: int,
                    device: DeviceLike = None) -> torch.Generator:
    """The generator of batch `index` under `seed`: its seed mixes the two
    (numpy's SeedSequence), so every (seed, index) pair draws its own
    stream and the same pair draws the same one."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(np.random.SeedSequence([seed, index]).generate_state(1)[0]))
    return g


def calibrate_noise_std(ensemble_eval_fn: Callable, fc_params, batches,
                        stds: Sequence[float], seed: int,
                        device: DeviceLike = None
                        ) -> Tuple[float, Dict[float, float]]:
    """Pick the latent-noise std minimizing ensemble CRPS on held-out
    batches. Returns (best_std, {std: mean CRPS}); stds should include 0.0
    so the deterministic baseline is in the table.

    JAX draws batch i's members from fold_in(key, i), the same draws for
    every std. Here batch i gets a fresh ``batch_generator(seed, i)`` for
    every std: one seeded generator per batch index, so each std sees the
    same member noise.
    """
    from ..metrics import crps as _crps

    batches = list(batches)
    table = {}
    for s in stds:
        tot = 0.0
        for i, batch in enumerate(batches):
            pred, target, _ = ensemble_eval_fn(
                fc_params, batch, batch_generator(seed, i, device), float(s))
            tot += _crps(pred, target)
        table[float(s)] = tot / max(len(batches), 1)
    best = min(table, key=table.get)
    return best, table


def make_eval_fn(pipeline: Callable, input_frames: int, pred_frames: int,
                 dequantize: bool = True, device: DeviceLike = None
                 ) -> Callable:
    """(fc_params, full_seq (B, T_in+T_out, C, H, W)) ->
    (pred, target, persistence) pixel tensors for metric computation."""
    split = _make_seq_split(input_frames, pred_frames, device, dequantize)

    def eval_fn(fc_params, seq):
        frames_in, target = split(seq)
        pred = pipeline(fc_params, frames_in)
        return pred, target, persistence_baseline(frames_in, pred_frames)

    return eval_fn


def evaluate_vs_persistence(eval_fn: Callable, fc_params, batches,
                            calc_metrics: Optional[Callable] = None):
    """The full metric dict for model and persistence, each averaged over
    batches (the reference's test_step + persistence comparison)."""
    if calc_metrics is None:
        from ..metrics import calc_metrics as _cm
        calc_metrics = _cm
    sums_m, sums_p, n = {}, {}, 0
    for batch in batches:
        with torch.inference_mode():
            pred, target, persist = eval_fn(fc_params, batch)
        for store, p in ((sums_m, pred), (sums_p, persist)):
            for k, v in calc_metrics(p, target).items():
                store[k] = store.get(k, 0.0) + v
        n += 1
    return ({k: v / n for k, v in sums_m.items()},
            {k: v / n for k, v in sums_p.items()})
