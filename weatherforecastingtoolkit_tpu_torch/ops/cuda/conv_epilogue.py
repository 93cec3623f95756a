"""Conv bias epilogue: y = (h + b_h [+ r + b_r]) / f, the hand-written
Hopper kernel, its plain PyTorch version and the custom op.

Replaces no TPU kernel: XLA fuses a conv's bias add and a resnet block's
residual add into the conv's output. cuDNN, as PyTorch calls it, leaves the
bias to ATen, whose broadcast add over a channels_last output is an
unvectorised pass (``elementwise_kernel<128, 4>``), and the residual to
another pass. So every native ``QConv`` (``ops/quant.py``) runs its conv
without bias and adds the bias here, and ``ResnetBlock2D``
(``models/vae/blocks.py``) folds conv2's bias, the shortcut's bias and the
residual into one call. The arithmetic is fp32 in the order written, with
one rounding to h's dtype: the bias alone gives ATen's ``h + b`` bit for
bit.

On the H100 the kernel is bound by device-memory bytes (h and r read once,
y written once; 3.35 TB/s). Its design, in ``csrc/conv_epilogue.cu``:
16-byte loads and stores, neighbouring threads on neighbouring addresses; on
channels_last a grid-stride loop whose stride is a multiple of the period
of the channel pattern, so each thread's biases sit in registers and the
loop does no division or gather; contiguous NCHW by whole planes. ``_plan``
sizes the launch; it is pure, so the CPU tests check it.

Dispatch: ``conv_epilogue`` calls the custom op ``wftk::conv_epilogue``,
whose CPU implementation is the plain version and whose CUDA implementation
(registered at the dispatcher's CUDA key) launches the kernel or raises. Its
fake implementation lets ``torch.export`` trace it; its registered autograd
is the plain version's: h and r get g / f, each bias g / f summed over N, H
and W. The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` and bound with ``ctypes``. ``launches`` counts calls that
launched it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .build import CSRC, nvcc_build

SOURCE = CSRC / "conv_epilogue.cu"
THREADS = 256          # the kernel's block size (kThreads)
RESIDENT_THREADS = 2048  # threads an SM holds
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float64: 3}

# Number of kernel launches since the last reset (a caller sets it to 0).
launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None
_sms: Dict[int, int] = {}          # device index -> SMs


def _format(h: torch.Tensor) -> torch.memory_format:
    """channels_last where h is laid out so, else NCHW."""
    return (torch.channels_last
            if h.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def conv_epilogue_reference(h: torch.Tensor, b_h: Optional[torch.Tensor],
                            r: Optional[torch.Tensor],
                            b_r: Optional[torch.Tensor],
                            f: float) -> torch.Tensor:
    """Plain version on (N, C, H, W): ((h + b_h) + (r + b_r)) / f in fp32
    (fp64 for fp64), each term only where it is given, one cast to h's
    dtype, in h's memory format. f divides as an fp32 tensor: an IEEE
    division on every device."""
    acc = torch.promote_types(h.dtype, torch.float32)
    y = h.to(acc)
    if b_h is not None:
        y = y + b_h.to(acc)[:, None, None]
    if r is not None:
        s = r.to(acc)
        if b_r is not None:
            s = s + b_r.to(acc)[:, None, None]
        y = y + s
    if f != 1.0:
        y = y / torch.full((), f, device=y.device)
    return y.to(h.dtype, copy=y is h).contiguous(memory_format=_format(h))


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so, seconds, out = nvcc_build(SOURCE)
    if seconds:
        build_seconds, build_log = seconds, out
    lib = ctypes.CDLL(str(so))
    fn = lib.conv_epilogue_forward
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, ll, i, ll, i, i, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _plan(n: int, c: int, hw: int, channels_last: bool, vec: int,
          sms: int) -> Tuple[int, int]:
    """(blocks, threads a block) of a launch over n elements of C channels
    and H*W positions, vec elements a load.

    channels_last: THREADS a block, enough blocks for two vectors a thread
    up to what the SMs hold at once, and at least one period of the channel
    pattern (C / gcd(C, vec) vectors: the kernel's stride is a multiple of
    it). NCHW: a block a (sample, channel) plane at a time, as many threads
    as the plane's vectors (32 to THREADS), as many blocks as stay resident
    (at most 32 an SM) or planes. Pure: no CUDA."""
    if channels_last:
        period = c // math.gcd(c, vec)
        work = -(-(n // vec) // 2)
        blocks = min(sms * RESIDENT_THREADS // THREADS, -(-work // THREADS))
        return max(blocks, -(-period // THREADS), 1), THREADS
    vectors = hw // vec
    threads = min(THREADS, max(32, 1 << (vectors - 1).bit_length()))
    per_sm = min(32, RESIDENT_THREADS // threads)
    return max(1, min(n // hw, sms * per_sm)), threads


def _aligned(*ts: Optional[torch.Tensor]) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


def conv_epilogue_cuda(h: torch.Tensor, b_h: Optional[torch.Tensor],
                       r: Optional[torch.Tensor], b_r: Optional[torch.Tensor],
                       f: float) -> torch.Tensor:
    """Launch the kernel on h's device and PyTorch's current stream. h:
    (N, C, H, W) fp32, bf16, fp16 or fp64, channels_last or contiguous NCHW; r
    (optional) of h's shape and dtype (copied to h's layout when it has
    another); b_h, b_r (optional): (C,) in h's dtype on h's device."""
    global launches
    if not h.is_cuda:
        raise ValueError(f"conv_epilogue_cuda needs a CUDA tensor, got {h.device}")
    code = DTYPES.get(h.dtype)
    if code is None:
        raise TypeError("conv_epilogue_cuda takes fp32, bf16, fp16 or fp64, "
                        f"got {h.dtype}")
    if h.ndim != 4:
        raise ValueError(f"expected (N, C, H, W), got {tuple(h.shape)}")
    n, c, hh, ww = h.shape
    fmt = _format(h)
    if fmt is torch.contiguous_format and not h.is_contiguous():
        raise ValueError("h must be contiguous NCHW or channels_last")
    for b in (b_h, b_r):
        if b is not None and (b.shape != (c,) or b.dtype != h.dtype
                              or b.device != h.device
                              or not b.is_contiguous()):
            raise ValueError(f"a bias must be ({c},) {h.dtype} on {h.device},"
                             f" got {tuple(b.shape)} {b.dtype} {b.device}")
    if r is not None:
        if r.shape != h.shape or r.dtype != h.dtype or r.device != h.device:
            raise ValueError(f"r must match h {tuple(h.shape)} {h.dtype} "
                             f"{h.device}, got {tuple(r.shape)} {r.dtype} "
                             f"{r.device}")
        if not r.is_contiguous(memory_format=fmt):
            r = r.contiguous(memory_format=fmt)
    index = h.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return conv_epilogue_cuda(h, b_h, r, b_r, f)
    y = torch.empty_like(h, memory_format=fmt)
    numel = h.numel()
    if numel == 0:
        return y
    lib = build()
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    channels_last = fmt is torch.channels_last
    hw = hh * ww
    vec = 16 // h.element_size()
    if not _aligned(h, r, y) or not (channels_last or hw % vec == 0):
        vec = 1
    grid, threads = _plan(numel, c, hw, channels_last, vec, sms)
    rc = lib.conv_epilogue_forward(
        h.data_ptr(), None if b_h is None else b_h.data_ptr(),
        None if r is None else r.data_ptr(),
        None if b_r is None else b_r.data_ptr(), y.data_ptr(), numel, c, hw,
        int(channels_last), code, vec, f, grid, threads,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_epilogue_forward failed with CUDA error {rc}")
    launches += 1
    return y


@torch.library.custom_op("wftk::conv_epilogue", mutates_args=(),
                         device_types="cpu")
def _conv_epilogue_op(h: torch.Tensor, b_h: Optional[torch.Tensor],
                      r: Optional[torch.Tensor], b_r: Optional[torch.Tensor],
                      f: float) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return conv_epilogue_reference(h, b_h, r, b_r, f)


@_conv_epilogue_op.register_fake
def _(h, b_h, r, b_r, f):
    return torch.empty_like(h, memory_format=_format(h))


def _setup_context(ctx, inputs, output):
    h, b_h, r, b_r, f = inputs
    ctx.f = f
    ctx.dtypes = tuple(None if t is None else t.dtype
                       for t in (h, b_h, r, b_r))


def _backward(ctx, g):
    """The plain version's gradients: g / f in fp32 (fp64 for fp64) to h and
    r, summed over N, H and W to each bias, each cast to its input's dtype.
    With f = 1 the incoming g is h's and r's gradient as it is (the plain
    version's round trip through fp32 gives its bits)."""
    need = ctx.needs_input_grad
    dt_h, dt_bh, dt_r, dt_br = ctx.dtypes
    acc = torch.promote_types(g.dtype, torch.float32)
    if ctx.f == 1.0 and g.dtype == dt_h:
        gf = None
        d_x = g
        if need[1] or need[3]:
            d_b = g.sum((0, 2, 3), dtype=acc)
    else:
        gf = g.to(acc)
        if ctx.f != 1.0:
            gf = gf / torch.full((), ctx.f, device=g.device)
        d_x = gf.to(dt_h)
        if need[1] or need[3]:
            d_b = gf.sum((0, 2, 3))
    return (d_x if need[0] else None,
            d_b.to(dt_bh) if need[1] else None,
            (d_x if gf is None else gf).to(dt_r) if need[2] else None,
            d_b.to(dt_br) if need[3] else None,
            None)


_conv_epilogue_op.register_autograd(_backward, setup_context=_setup_context)

# The CUDA implementation is the kernel's wrapper, registered at the
# dispatcher's CUDA key as it is: ``register_kernel``'s Python wrapper would
# add its host time to every launch. The op's overload is looked up once.
_CUDA = torch.library.Library("wftk", "FRAGMENT")
_CUDA.impl("conv_epilogue", conv_epilogue_cuda, "CUDA")
_op = torch.ops.wftk.conv_epilogue.default


def conv_epilogue(h: torch.Tensor, b_h: Optional[torch.Tensor] = None,
                  r: Optional[torch.Tensor] = None,
                  b_r: Optional[torch.Tensor] = None,
                  f: float = 1.0) -> torch.Tensor:
    """((h + b_h) + (r + b_r)) / f over (N, C, H, W) through the op
    ``wftk::conv_epilogue``: the kernel on CUDA tensors, the plain version
    on CPU tensors. h is a conv's output without its bias, b_h that bias
    (C,) in h's dtype; r a residual of h's shape with its own bias b_r.
    A residual of another dtype promotes with h, as ``h + r`` would. h
    comes back as it is when there is nothing to add. Differentiable in
    every tensor."""
    if r is not None and r.dtype != h.dtype:
        dtype = torch.promote_types(h.dtype, r.dtype)
        h, r = h.to(dtype), r.to(dtype)
        b_h, b_r = (None if b is None else b.to(dtype) for b in (b_h, b_r))
    if b_h is None and r is None and f == 1.0:
        return h
    return _op(h, b_h, r, b_r, float(f))
