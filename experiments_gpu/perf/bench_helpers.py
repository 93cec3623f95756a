"""Shared pieces of the port's perf entry points (``experiments_gpu/perf/``):
the serving geometry, the pipeline factory, calibration, timing and the
cost count, in place of what the JAX scripts take from ``bench.py``. It
imports neither ``bench.py`` nor anything of the JAX package.

  * the constants ``HW``, ``T_IN``, ``T_OUT``, ``BATCH``, ``FAST_BATCH``,
    ``VAE_CHANNELS``, ``LATENT_C``, ``LATENT_HW``, ``NORM_GROUPS`` and
    ``FAST_VAE_KW``, as ``bench.py`` sets them;
  * ``build_pipeline``: ``bench.py::build_jax_pipeline`` on the port (the
    frozen ``AutoencoderKL`` in fp32 or bf16, DLinear and the latent path in
    fp32), with the frame size an argument (``hw``) rather than a module
    global; the VAE's weights are drawn with numpy from seed 0 unless a
    state dict is given;
  * ``calibrate_qscales``: ``bench.py::calibrate_qscales``;
  * ``time_pipeline``: the first call timed apart (the kernels' build and
    cuDNN's algorithm search fall in it), then CUDA events around each call
    after a ``torch.cuda.synchronize()``;
  * ``count_cost`` and ``utilization``: there is no XLA cost model, so FLOPs
    are counted with ``FlopCounterMode`` and bytes as the sum of each aten
    op's input and output bytes (what eager PyTorch moves, one op at a
    time); the hand-written int8 kernels are the custom ops
    ``wftk::int8_quantize`` and ``wftk::int8_conv2d``, which both modes see
    as ops (the conv's FLOPs by ``_int8_conv_flop``). They are scored
    against the card's published peaks (``DEVICE_PEAKS``, keyed on
    ``torch.cuda.get_device_name``): a share of the card's peak, not XLA's
    MFU.

Every script takes ``--device`` (default ``cuda``, which raises without a
GPU) and ``--narrow``: narrow widths and 32x32 frames, a check of the
script's control flow on the CPU, not a measurement.
"""

from __future__ import annotations

import os
import statistics
import sys
import time
from typing import Callable, Mapping, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import (  # noqa: E402
    FlopCounterMode, register_flop_formula)

from weatherforecastingtoolkit_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.rollout import (  # noqa: E402
    make_forecast_pipeline, make_streaming_forecaster)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (  # noqa: E402
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.ops.quant import (  # noqa: E402
    calibrate, mixed_mode_uses)
from weatherforecastingtoolkit_tpu_torch.ops.ssim import ssim  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)

BATCH = 64          # the reference VAE's serving batch
FAST_BATCH = 256    # the fast VAE's serving batch
FAST_VAE_KW = dict(pixel_unshuffle=4, block_out_channels=(128, 256, 512))
T_IN, T_OUT = 13, 12
HW = 128
LATENT_C, LATENT_HW = 64, 8
VAE_CHANNELS = (64, 128, 256, 512, 512)
NORM_GROUPS = 32
GATE = 0.995        # bench.py's bf16-vs-fp32 SSIM gate

# --narrow: the same pipelines at widths and a frame size the CPU runs in
# seconds (two channels a GroupNorm group at least)
NARROW_HW = 32
NARROW_VAE = dict(block_out_channels=(8, 16, 16, 16, 16), latent_channels=4,
                  norm_num_groups=4)
NARROW_FAST = dict(pixel_unshuffle=4, block_out_channels=(8, 16, 16))

# {device-name prefix: (bf16 dense FLOP/s, memory bytes/s, int8 dense OP/s)}:
# NVIDIA's data sheet, H100 SXM
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12, 1978.9e12),
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def add_common_args(parser):
    """``--device`` and ``--narrow``, which every perf script takes."""
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    parser.add_argument("--narrow", action="store_true",
                        help="narrow widths and 32x32 frames: a check of "
                             "the control flow on the CPU, no measurement")
    return parser


def describe_device(device: torch.device) -> str:
    """The card's name (or the CPU), printed first by every script."""
    if device.type == "cuda":
        return (f"{torch.cuda.get_device_name(device)} "
                f"x{torch.cuda.device_count()}")
    return "cpu"


def geometry(narrow: bool):
    """(hw, base VAE kwargs, fast VAE kwargs) of the serving scripts."""
    if narrow:
        return NARROW_HW, dict(NARROW_VAE), dict(NARROW_FAST)
    return HW, {}, dict(FAST_VAE_KW)


def vae_config(vae_kwargs: Optional[Mapping] = None) -> dict:
    """bench.py's AutoencoderKL arguments with ``vae_kwargs`` on top."""
    kw = dict(in_channels=1, out_channels=1, block_out_channels=VAE_CHANNELS,
              layers_per_block=1, latent_channels=LATENT_C,
              norm_num_groups=NORM_GROUPS)
    kw.update(vae_kwargs or {})
    return kw


def frames_for(batch: int, hw: int = HW, device=None,
               seed: int = 0) -> torch.Tensor:
    """(batch, T_IN, 1, hw, hw) fp32 frames in [0, 1] of
    ``synthetic_vil_events`` on ``device``."""
    ev = synthetic_vil_events(batch, hw, hw, T_IN, seed=seed)
    f = np.transpose(ev, (0, 3, 1, 2))[:, :, None].astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(f)).to(resolve_device(device))


def frame_ssim(a: torch.Tensor, b: torch.Tensor) -> float:
    """SSIM of two frame stacks (any leading dims, 1 x H x W frames)."""
    hw = a.shape[-2:]
    return float(ssim(a.reshape((-1, 1) + tuple(hw)).float(),
                      b.reshape((-1, 1) + tuple(hw)).float()))


def _vae(vae_kwargs, conv_mode, device, vae_state) -> AutoencoderKL:
    vae = AutoencoderKL(**vae_config(vae_kwargs), conv_mode=conv_mode,
                        seed=0, device=device)
    if vae_state is not None:
        vae.load_state_dict(vae_state, strict=True)
    return vae


def calibrate_qscales(calib_frames: torch.Tensor, vae_kwargs=None, *,
                      vae_state=None) -> dict:
    """One 'calibrate' pass over the serving batch (fp32, encode then decode
    of the posterior mode): {conv path: per-input-channel abs-max} for the
    geometry ``vae_kwargs`` with the pipeline's weights. The scales depend
    on the architecture and the batch, not on the int8 spec, so a sweep
    over specs calibrates once and passes them to every ``build_pipeline``.
    """
    cvae = _vae(vae_kwargs, "calibrate", calib_frames.device, vae_state)
    flat = calib_frames.reshape((-1,) + tuple(calib_frames.shape[2:]))
    return calibrate(lambda m, f: m.decode(m.encode(f).mode()), cvae,
                     [flat.float()])


def build_pipeline(dtype="float32", conv_mode="native", calib_frames=None,
                   autoregressive=False, vae_kwargs=None, streaming=False,
                   qscales=None, *, hw: int = HW, device=None,
                   vae_state: Optional[Mapping] = None):
    """bench.py's rollout on the port: (pipeline, forecaster), or
    ((init, step), forecaster) with ``streaming``.

    The VAE runs in ``dtype`` (bf16 parameters and activations for the
    conv stacks), the latent path and DLinear(13 -> 12, kernel 25) in fp32.
    ``conv_mode`` may be a mixed spec; a mode that reads calibration scales
    takes ``qscales`` or calibrates on ``calib_frames`` (at fp32). The
    pipeline carries its VAE as ``pipeline.vae``."""
    dev = resolve_device(device)
    tdtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    vae = _vae(vae_kwargs, conv_mode, dev, vae_state)
    if mixed_mode_uses(conv_mode, "int8_static"):
        if qscales is None:
            if calib_frames is None:
                raise ValueError("int8_static needs calib_frames or qscales")
            qscales = calibrate_qscales(calib_frames, vae_kwargs,
                                        vae_state=vae_state)
        vae.load_qscales(qscales)
    vae = vae.to(tdtype)   # the scales stay fp32
    fc = DLinear(T_IN, T_OUT, kernel_size=25, device=dev)

    def encode_apply(f):
        return vae.encode(f.to(tdtype)).mode().float()

    def decode_apply(z):
        return vae.decode(z.to(tdtype)).float()

    kw = dict(encode_apply=encode_apply, decode_apply=decode_apply,
              forecaster_apply=lambda m, z: m(z), input_frames=T_IN,
              pred_frames=T_OUT, device=dev)
    if streaming:
        with torch.inference_mode():
            lat = encode_apply(torch.zeros(1, 1, hw, hw, device=dev))
        init, step = make_streaming_forecaster(latent_shape=tuple(lat.shape[1:]),
                                               **kw)
        return (init, step), fc
    pipe = make_forecast_pipeline(autoregressive=autoregressive, **kw)
    pipe.vae = vae
    return pipe, fc


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn: Callable, device, n_rep: int = 10):
    """(median seconds a call, seconds of the first call, last output):
    the first call apart, then each call between CUDA events recorded after
    a ``torch.cuda.synchronize()`` (the host clock on the CPU)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(n_rep):
        sync(dev)
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times), first_s, out


def time_pipeline(pipeline, fc, frames, n_rep: int = 10):
    """bench.py::_time_pipeline: (median s, first-call s, output)."""
    return timed(lambda: pipeline(fc, frames), frames.device, n_rep)


def fp32_reference(pipeline, fc, frames, chunk: int):
    """The pipeline's output over ``frames`` computed ``chunk`` sequences at
    a time (every op is per sample, so this equals one call)."""
    return torch.cat([pipeline(fc, frames[i:i + chunk])
                      for i in range(0, frames.shape[0], chunk)])


class _Bytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs; a view
    moves nothing and is not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            leaves = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(t.numel() * t.element_size() for t in leaves
                              if isinstance(t, torch.Tensor))
        return out


@register_flop_formula(torch.ops.wftk.int8_conv2d)
def _int8_conv_flop(xq_shape, wq_shape, *args, out_shape=None, **kwargs):
    """2 * M * Cout * K of one int8 conv (``wftk::int8_conv2d``): M output
    positions, K = kh * kw * Cp over the channels the kernel multiplies
    (the input's padded to a multiple of 16)."""
    cout, kh, kw, cp = wq_shape
    return 2 * (out_shape[0] * out_shape[1] * out_shape[2]) * cout * (
        kh * kw * cp)


def count_cost(fn: Callable):
    """(FLOPs, bytes) of one ``fn()`` call, eager op by op, or (None, None)
    where nothing was counted."""
    counter, nbytes = FlopCounterMode(display=False), _Bytes()
    with torch.inference_mode(), counter, nbytes:
        fn()
    return (float(counter.get_total_flops()) or None), (float(nbytes.bytes)
                                                        or None)


def device_peaks(device):
    """The card's row of DEVICE_PEAKS (the longest matching name prefix),
    or None: the CPU, or a card without a row."""
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(dev)
    matches = [k for k in DEVICE_PEAKS if kind.startswith(k)]
    if not matches:
        log(f"no peak table for device {kind!r}")
        return None
    return DEVICE_PEAKS[max(matches, key=len)]


def utilization(flops, nbytes, seconds, precision="bf16", device=None):
    """(share of the card's peak FLOP/s, share of its peak bytes/s), each
    None where unknown: no count, the CPU, or a card without a row in
    DEVICE_PEAKS. ``precision`` "int8" scores against the int8 peak."""
    peaks = device_peaks(device)
    if peaks is None:
        return None, None
    flop_peak = peaks[2] if precision == "int8" else peaks[0]
    mfu = flops / seconds / flop_peak if flops else None
    bwu = nbytes / seconds / peaks[1] if nbytes else None
    return mfu, bwu


def share(v) -> str:
    return "-" if v is None else f"{v * 100:.1f}%"


def empty_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
