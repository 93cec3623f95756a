"""int8 convolution and activation quantization: the hand-written Hopper
kernels and their plain PyTorch versions.

No TPU kernel stands behind these. They replace the XLA op the JAX package's
int8 convs run, ``lax.conv_general_dilated(xq, wq, ...,
preferred_element_type=jnp.int32)`` followed by the fp32 epilogue
(weatherforecastingtoolkit_tpu/ops/quant.py, ``int8_conv`` :104-112 and
``int8_conv_static`` :159-167), for which PyTorch has no CUDA counterpart.

``int8_conv2d_nhwc`` computes y = round_to(out_dtype)(fp32(acc) * scale +
bias) with acc the int32 sum of int8 codes over kh x kw x Cin, zero outside
the image; ``quantize_nhwc`` computes q = clamp(rint(x / s), -127, 127) in one
pass over x, with s per channel or one device scalar. Both kernels live in
``csrc/int8_conv.cu``: the conv is an implicit GEMM, warp-specialised and
persistent, on ``wgmma`` s8 tensor cores fed by TMA (weights) and cp.async
gathers (input rows) through a ring of shared-memory stages; the source's
header says what bounds it. The quantize pass is bound by bytes.

Input channels are padded to a multiple of 16 with zero codes (exact): the
quantize pass writes the padding into its output, and ``pad_channels`` pads
the (small) weight codes, which then are the (Cout, K) matrix the kernel
reads by TMA, K = kh * kw * Cp. ``plan`` picks the kernel's design, tile
width and ring depth for a conv; it is pure, so the CPU tests check it.

Dispatch: both kernels are custom ops (``torch.library.custom_op``),
``torch.ops.wftk.int8_quantize`` and ``torch.ops.wftk.int8_conv2d``, whose
CPU implementations are the plain versions and whose CUDA implementations
launch the kernels or raise. Their fake implementations give the outputs'
shapes and dtypes, so ``torch.export``, fake tensors and dispatch modes
trace through them (``plan`` and ``build`` run only at a launch). The plain
conv is ``F.conv2d`` in float64 on the codes (exact: every sum stays far
below 2**53) cast to int32, then the same epilogue in torch; the card's
kernel gives its bits. The kernels are built with ``nvcc`` for ``sm_90a``
at first use into ``_build/`` (keyed by a hash of the source) and bound
with ``ctypes``. ``conv_launches`` and ``quantize_launches`` count calls
that launched each kernel.

Gradients: the conv op's registered autograd is the autograd of the plain
version (``_conv_backward``), so the int8 modes differentiate in scale and
bias on the card as on the CPU; the codes carry no gradient, as in JAX.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .build import CSRC, nvcc_build

SOURCE = CSRC / "int8_conv.cu"
CHANNEL_ALIGN = 16      # input channels are padded to this (16-byte pieces)

# Numbers of kernel launches since the last reset (a caller sets them to 0).
conv_launches = 0
quantize_launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None

Pad = Tuple[int, int, int, int]


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


def pad_channels(wq: torch.Tensor) -> torch.Tensor:
    """Weight codes (Cout, kh, kw, Cin) with Cin padded by zero codes."""
    extra = padded_channels(wq.shape[-1]) - wq.shape[-1]
    return F.pad(wq, (0, extra)) if extra else wq


def out_size(h: int, w: int, kh: int, kw: int, strides: Tuple[int, int],
             pad: Pad) -> Tuple[int, int]:
    t, b, l, r = pad
    return ((h + t + b - kh) // strides[0] + 1,
            (w + l + r - kw) // strides[1] + 1)


class Plan(NamedTuple):
    """How csrc/int8_conv.cu runs one conv. ``design`` 2 reads the input
    rows by TMA in im2col mode, 1 gathers them with cp.async (two producer
    warpgroups); ``bn`` output channels a tile; ``stages`` the depth of the
    ring; ``resident`` 1 when the kernel holds all of the weights in shared
    memory (one Cout tile) and streams only the input rows."""
    design: int
    bn: int
    stages: int
    resident: int


GATHER, IM2COL = 1, 2
WS_WIDTHS = (8, 16, 64, 128, 256)   # wgmma N of the tiles
GATHER_MAX_BN = 128                 # the gather's sums: 128 registers a thread
GATHER_MAX_TAPS = 64                # kh * kw of the gather's tap masks
WS_BM = 128                         # output rows a tile
WS_EPI_COLS = 32                    # columns a warp stages at a time
SMEM_LIMIT = 232448                 # bytes of shared memory a block (H100)
IM2COL_CORNER = (-128, 127)         # TMA im2col's corner range, 4-D tensor
MIN_STAGES = 2


def stage_k(design: int, cp: int) -> int:
    """Bytes of K a stage holds: 128 (the 128-byte swizzle), or 64 (the
    64-byte one) for the im2col design when Cp is not a multiple of 128."""
    return 64 if design == IM2COL and cp % 128 else 128


def ws_smem_bytes(bn: int, out_bytes: int, stages: int, k: int = 0,
                  resident: int = 0, bk: int = 128) -> int:
    """Shared memory the kernel asks for (``ws_smem_bytes`` in the source):
    alignment slack, the ring of A stages (128 rows x bk bytes) and B stages
    (bn x bk bytes), or all ceil(K / bk) B boxes when resident, 8 warps' 16
    staged rows, the barriers."""
    stride = min(bn, WS_EPI_COLS) * out_bytes + 16
    b_boxes = -(-k // bk) if resident else stages
    return (1024 + stages * WS_BM * bk + b_boxes * bn * bk
            + 8 * 16 * stride + 16 * stages + 8)


def ws_width(cout: int) -> int:
    """The widest wgmma tile that Cout fills (8 for Cout <= 8)."""
    for bn in reversed(WS_WIDTHS):
        if cout >= bn:
            return bn
    return WS_WIDTHS[0]


def plan_stages(bn: int, out_bytes: int, k: int = 0, resident: int = 0,
                bk: int = 128, most: int = 8) -> int:
    """The most stages (at most `most`) that fit the shared memory; 0 when
    not even MIN_STAGES do."""
    stages = most
    while stages >= MIN_STAGES and ws_smem_bytes(
            bn, out_bytes, stages, k, resident, bk) > SMEM_LIMIT:
        stages -= 1
    return stages if stages >= MIN_STAGES else 0


def im2col_fits(h: int, w: int, kh: int, kw: int, strides: Tuple[int, int],
                pad: Pad) -> bool:
    """Whether TMA's im2col mode takes the conv: strides up to 8 and a
    bounding box (the tap-(0, 0) input pixels of all output pixels) whose
    corners lie within IM2COL_CORNER of the image's."""
    ho, wo = out_size(h, w, kh, kw, strides, pad)
    t, _, l, _ = pad
    corners = (-l, -t, -l + (wo - 1) * strides[1] - (w - 1),
               -t + (ho - 1) * strides[0] - (h - 1))
    lo, hi = IM2COL_CORNER
    return max(strides) <= 8 and all(lo <= c <= hi for c in corners)


def plan(cout: int, kh: int, kw: int, cp: int, out_bytes: int,
         im2col: bool = True) -> Plan:
    """The design, tile width, ring depth and weight residency for a conv of
    Cout output channels, a kh x kw kernel over Cp (padded) input channels,
    writing out_bytes a value; `im2col` says whether TMA's im2col mode
    takes its geometry (``im2col_fits``); raises where neither design takes
    the conv (the gather past 64 taps). From kernel_timing.py's sweep on an
    H100 (PERF.md): im2col wherever it fits and Cp is a multiple of 64; the
    widest tile Cout fills (the gather's at most 128); the weights resident
    where one tile of at most 64 spans Cout and the kernel is wider than
    1x1, with the deepest ring that fits; else a ring of 3 stages for
    256-wide tiles and 1x1 kernels and 4 for the rest (deeper rings were
    slower)."""
    k = kh * kw * cp
    design = IM2COL if im2col and cp % 64 == 0 else GATHER
    if design == GATHER and kh * kw > GATHER_MAX_TAPS:
        raise ValueError(f"no int8 conv kernel for a {kh}x{kw} kernel over "
                         f"{cp} channels outside TMA's im2col mode (the "
                         f"gather takes at most {GATHER_MAX_TAPS} taps)")
    bn = ws_width(cout)
    if design == GATHER:
        bn = min(bn, GATHER_MAX_BN)
    bk = stage_k(design, cp)
    most = 8 * 128 // bk
    if cout <= bn <= 64 and kh * kw > 1 and plan_stages(bn, out_bytes, k, 1,
                                                        bk) >= 4:
        return Plan(design, bn, plan_stages(bn, out_bytes, k, 1, bk, most), 1)
    ring = 3 if bn == 256 or kh * kw == 1 else 4
    return Plan(design, bn, plan_stages(bn, out_bytes, bk=bk, most=ring), 0)


@functools.lru_cache(maxsize=None)
def _geometry(h: int, w: int, cp: int, cout: int, kh: int, kw: int,
              strides: Tuple[int, int], pad: Pad, out_bytes: int):
    """(Ho, Wo, plan) of a launch, kept per conv shape: ``plan`` and
    ``im2col_fits`` are pure, and a serving call repeats its shapes."""
    ho, wo = out_size(h, w, kh, kw, strides, pad)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output for {h}x{w} with a {kh}x{kw} kernel")
    return ho, wo, plan(cout, kh, kw, cp, out_bytes,
                        im2col_fits(h, w, kh, kw, strides, pad))


# ------------------------------------------------------------ plain versions
def quantize_nhwc_plain(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) fp32/bf16, s (C,) or 0-d fp32 -> int8 codes
    (N, H, W, Cp), channels C..Cp zero."""
    s = s.to(device=x.device, dtype=torch.float32)
    q = torch.clamp(torch.round(x.float() / s), -127, 127).to(torch.int8)
    return pad_channels(q).contiguous()


def int8_accumulate_plain(xq: torch.Tensor, wq: torch.Tensor,
                          strides: Tuple[int, int], pad: Pad) -> torch.Tensor:
    """Codes xq (N, H, W, Cp), wq (Cout, kh, kw, Cp) -> fp32(acc) (N, Ho,
    Wo, Cout): the float64 conv of the codes cast to int32, then to fp32."""
    t, b, l, r = pad
    xd = F.pad(xq.permute(0, 3, 1, 2).double().contiguous(), (l, r, t, b))
    acc = F.conv2d(xd, wq.permute(0, 3, 1, 2).double().contiguous(),
                   stride=strides)
    return acc.to(torch.int32).float().permute(0, 2, 3, 1)


def int8_epilogue(acc: torch.Tensor, scale: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  out_dtype: torch.dtype) -> torch.Tensor:
    """fp32(acc) (N, Ho, Wo, Cout) * scale + bias rounded to out_dtype, one
    operation at a time; differentiable in scale and bias."""
    y = acc * scale
    if bias is not None:
        y = y + bias
    return y.to(out_dtype).contiguous()


def int8_conv2d_nhwc_plain(xq: torch.Tensor, wq: torch.Tensor,
                           scale: torch.Tensor, bias: Optional[torch.Tensor],
                           strides: Tuple[int, int], pad: Pad,
                           out_dtype: torch.dtype) -> torch.Tensor:
    """Codes xq (N, H, W, Cp), wq (Cout, kh, kw, Cp) -> y (N, Ho, Wo, Cout):
    ``int8_epilogue`` of ``int8_accumulate_plain``."""
    return int8_epilogue(int8_accumulate_plain(xq, wq, strides, pad), scale,
                         bias, out_dtype)


# ------------------------------------------------------------------ kernels
def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so, seconds, out = nvcc_build(SOURCE)
    if seconds:
        build_seconds, build_log = seconds, out
    lib = ctypes.CDLL(str(so))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.int8_conv2d_forward.argtypes = [p, p, p, p, p, i] + [i] * 17 + [p]
    lib.int8_conv2d_forward.restype = i
    lib.int8_quantize_forward.argtypes = [p, i, p, i, p, ll, i, i, p]
    lib.int8_quantize_forward.restype = i
    _lib = lib
    return lib


def _on_device(t: torch.Tensor, x: torch.Tensor, name: str) -> None:
    if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous fp32 on {x.device}, got "
                         f"{t.dtype} on {t.device}")


def quantize_nhwc_cuda(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The quantize kernel: x (N, H, W, C) contiguous fp32/bf16 on the card,
    s (C,) or one fp32 value on x's device -> codes (N, H, W, Cp)."""
    global quantize_launches
    if not x.is_cuda:
        raise ValueError(f"quantize_nhwc_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quantize_nhwc_cuda takes fp32 or bf16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (N, H, W, C) tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[-1]
    _on_device(s, x, "s")
    if s.numel() not in (1, c):
        raise ValueError(f"s holds {s.numel()} scales for {c} channels")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return quantize_nhwc_cuda(x, s)
    lib = build()
    cp = padded_channels(c)
    q = torch.empty(x.shape[:-1] + (cp,), dtype=torch.int8, device=x.device)
    rc = lib.int8_quantize_forward(
        x.data_ptr(), int(x.dtype == torch.bfloat16), s.data_ptr(),
        int(s.numel() == c and s.ndim == 1), q.data_ptr(),
        x.numel() // c, c, cp, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_quantize_forward failed with CUDA error {rc}")
    quantize_launches += 1
    return q


def int8_conv2d_nhwc_cuda(xq: torch.Tensor, wq: torch.Tensor,
                          scale: torch.Tensor, bias: Optional[torch.Tensor],
                          strides: Tuple[int, int], pad: Pad,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The conv kernel on codes xq (N, H, W, Cp) and wq (Cout, kh, kw, Cp),
    Cp a multiple of 16, both contiguous int8 on the card."""
    global conv_launches
    for name, t in (("xq", xq), ("wq", wq)):
        if not t.is_cuda:
            raise ValueError(f"int8_conv2d_nhwc_cuda needs CUDA tensors, "
                             f"{name} is on {t.device}")
        if t.dtype != torch.int8 or t.ndim != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous 4-D int8, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if wq.device != xq.device:
        raise ValueError(f"wq on {wq.device}, xq on {xq.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_conv2d_nhwc_cuda writes fp32 or bf16, not {out_dtype}")
    n, h, w, cp = xq.shape
    cout, kh, kw, wcp = wq.shape
    if cp % CHANNEL_ALIGN or wcp != cp:
        raise ValueError(f"input channels {cp} and weight channels {wcp} "
                         f"must match and be a multiple of {CHANNEL_ALIGN}")
    _on_device(scale, xq, "scale")
    if bias is not None:
        _on_device(bias, xq, "bias")
    for t in (scale,) + (() if bias is None else (bias,)):
        if t.shape != (cout,):
            raise ValueError(f"scale and bias must be ({cout},), got {tuple(t.shape)}")
    if min(strides) < 1 or min(pad) < 0:
        raise ValueError(f"strides {strides} and padding {pad}")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("xq and wq must be 16-byte aligned")
    if xq.device.index != torch.cuda.current_device():
        with torch.cuda.device(xq.device):
            return int8_conv2d_nhwc_cuda(xq, wq, scale, bias, strides, pad,
                                         out_dtype)
    bf16 = out_dtype == torch.bfloat16
    ho, wo, how = _geometry(h, w, cp, cout, kh, kw, tuple(strides),
                            tuple(pad), 2 if bf16 else 4)
    lib = build()
    y = torch.empty((n, ho, wo, cout), dtype=out_dtype, device=xq.device)
    rc = lib.int8_conv2d_forward(
        xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(), int(bf16),
        n, h, w, cp, cout, kh, kw, strides[0], strides[1], pad[0], pad[2],
        ho, wo, *how, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_conv2d_forward failed with CUDA error {rc}")
    conv_launches += 1
    return y


# ----------------------------------------------------------------- dispatch
@torch.library.custom_op("wftk::int8_quantize", mutates_args=(),
                         device_types="cpu")
def _int8_quantize_op(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return quantize_nhwc_plain(x, s)


@_int8_quantize_op.register_fake
def _(x, s):
    return x.new_empty(x.shape[:-1] + (padded_channels(x.shape[-1]),),
                       dtype=torch.int8)


@torch.library.custom_op("wftk::int8_conv2d", mutates_args=(),
                         device_types="cpu")
def _int8_conv2d_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bias: Optional[torch.Tensor], strides: Sequence[int],
                    pad: Sequence[int], out_dtype: torch.dtype
                    ) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return int8_conv2d_nhwc_plain(xq, wq, scale, bias, tuple(strides),
                                  tuple(pad), out_dtype)


@_int8_conv2d_op.register_fake
def _(xq, wq, scale, bias, strides, pad, out_dtype):
    n, h, w, _ = xq.shape
    cout, kh, kw, _ = wq.shape
    ho, wo = out_size(h, w, kh, kw, tuple(strides), tuple(pad))
    return xq.new_empty((n, ho, wo, cout), dtype=out_dtype)


def _conv_setup_context(ctx, inputs, output):
    xq, wq, scale, bias, strides, pad, out_dtype = inputs
    ctx.save_for_backward(xq, wq, scale, bias)
    ctx.args = (list(strides), list(pad), out_dtype)


def _conv_backward(ctx, g):
    """The autograd of the plain version. The codes carry no gradient (they
    are rounded), so it flows only through the epilogue, to scale and bias,
    as ``jax.grad`` of the JAX int8 convs gives it: fp32(acc) is recomputed
    by the op at a unit scale and no bias (the kernel on the card, exact)
    and ``int8_epilogue`` differentiated."""
    xq, wq, scale, bias = ctx.saved_tensors
    strides, pad, out_dtype = ctx.args
    acc = _conv_op(xq, wq, torch.ones_like(scale), None, strides, pad,
                   torch.float32)
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip((scale, bias), ctx.needs_input_grad[2:4])]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(
            int8_epilogue(acc, *leaves, out_dtype), wanted, g))
    return (None, None) + tuple(
        next(grads) if t is not None and t.requires_grad else None
        for t in leaves) + (None, None, None)


_int8_conv2d_op.register_autograd(_conv_backward,
                                  setup_context=_conv_setup_context)

# The CUDA implementations are the kernels' wrappers, registered at the
# dispatcher's CUDA key as they are: ``register_kernel``'s Python wrapper
# (an aliasing check and a dynamo guard) would add its host time to every
# launch. The ops' overloads are looked up once.
_CUDA = torch.library.Library("wftk", "FRAGMENT")
_CUDA.impl("int8_quantize", quantize_nhwc_cuda, "CUDA")
_CUDA.impl("int8_conv2d", int8_conv2d_nhwc_cuda, "CUDA")
_quantize_op = torch.ops.wftk.int8_quantize.default
_conv_op = torch.ops.wftk.int8_conv2d.default


def quantize_nhwc(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int8 codes of x (N, H, W, C) through the op ``wftk::int8_quantize``:
    the kernel on a CUDA tensor, the plain version on a CPU tensor. The
    codes carry no gradient."""
    return _quantize_op(*(t.detach() if t.requires_grad else t
                          for t in (x, s)))


def int8_conv2d_nhwc(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor], strides: Tuple[int, int],
                     pad: Pad, out_dtype: torch.dtype) -> torch.Tensor:
    """The int8 conv with its epilogue through the op ``wftk::int8_conv2d``:
    the kernel on CUDA tensors, the plain version on CPU tensors. pad is
    (top, bottom, left, right). Differentiable in scale and bias."""
    return _conv_op(xq, wq, scale, bias, strides, pad, out_dtype)
