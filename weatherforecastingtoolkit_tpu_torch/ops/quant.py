"""int8 quantized convolution (counterpart of
weatherforecastingtoolkit_tpu/ops/quant.py): ``QConv`` with all five modes
and mixed per-layer specs, the functional W8A8 convs and calibration.

Modes: ``native`` (flax ``nn.Conv`` numerics: input, kernel and bias promote
to one dtype), ``int8`` (per-tensor dynamic activation scale), ``calibrate``
(native compute, records each conv's per-input-channel abs-max),
``int8_static`` (calibrated per-input-channel scales folded into the
weights) and ``fake_quant`` (``int8_static`` numerics in float math with
straight-through gradients, for quantization-aware fine-tuning). A mixed
spec is a tuple of (fnmatch pattern over the conv's flax path, mode) pairs;
the first match wins and unmatched convs run ``native``.

The functional entry points keep the JAX layouts: x (N, H, W, Cin), kernel
(kh, kw, Cin, Cout). Every int8 conv is the same three steps as in JAX:
weights quantized per output channel (max|w| / 127) with plain torch ops
(on every call of the functional convs, once per weight for a ``QConv``,
as XLA folds the weight side of the JAX package's convs into constants),
activations quantized to int8 codes, an int8 x int8 -> int32 conv, and the
fp32 epilogue ``acc * scale + bias`` rounded to x's dtype.
``ops/cuda/int8_conv.py`` holds the last two steps: on a CUDA tensor its
hand-written kernels run them (or raise), on a CPU tensor their plain
versions. ``calibrate`` and ``fake_quant`` are plain PyTorch everywhere.

Every scale is an IEEE fp32 division by 127, as the JAX source writes it
(``jax.jit`` may turn a division by a constant into a product with its
reciprocal; PyTorch on CUDA does so for a Python-number divisor; neither
happens here), and every round is half to even.
"""

from __future__ import annotations

import fnmatch
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .cuda import int8_conv as _kernels

CONV_MODES = ("native", "int8", "int8_static", "calibrate", "fake_quant")
# modes whose convs hold calibration scales (act_absmax)
_SCALED = ("int8_static", "fake_quant", "calibrate")

ConvMode = Union[str, Tuple[Tuple[str, str], ...]]
Padding = Union[str, int, Sequence[Tuple[int, int]]]


def resolve_conv_mode(mode: ConvMode, path: Sequence[str]) -> str:
    """Resolve a (possibly mixed) conv-mode spec for the conv at ``path``
    (the flax module path, e.g. ("encoder", "mid_block", "resnets_0",
    "conv1")). String specs apply globally; tuple specs are (pattern, mode)
    pairs matched with fnmatch against "/".join(path); unmatched paths run
    "native"."""
    if isinstance(mode, str):
        return mode
    p = "/".join(path)
    for pat, m in mode:
        if fnmatch.fnmatch(p, pat):
            return m
    return "native"


def mixed_mode_uses(mode: ConvMode, target: str) -> bool:
    """True if ``mode`` is (or can resolve to) ``target`` anywhere."""
    if isinstance(mode, str):
        return mode == target
    return any(m == target for _pat, m in mode)


def as_padding(padding: Padding, kernel_size: Tuple[int, int],
               strides: Tuple[int, int], hw: Tuple[int, int]
               ) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of a JAX padding argument: "SAME",
    "VALID", an int, or ((top, bottom), (left, right))."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return (0, 0, 0, 0)
        if padding.upper() != "SAME":
            raise ValueError(f"padding {padding!r}")
        out = []
        for k, s, n in zip(kernel_size, strides, hw):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out += [total // 2, total - total // 2]
        return tuple(out)
    if isinstance(padding, int):
        return (padding,) * 4
    (t, b), (l, r) = padding
    return (int(t), int(b), int(l), int(r))


def _div127(t: torch.Tensor) -> torch.Tensor:
    # a tensor divisor on t's device: an IEEE division on every device
    return t / torch.full((), 127.0, device=t.device)


def _w_scale(kf: torch.Tensor) -> torch.Tensor:
    """Per-output-channel weight scale max|w| / 127 (1 for an all-zero
    channel) of an fp32 kernel with Cout first."""
    w_absmax = torch.amax(kf.abs(), dim=(1, 2, 3))
    return torch.where(w_absmax > 0, _div127(w_absmax),
                       torch.ones_like(w_absmax))


def _weight_scale(w: torch.Tensor, s_a: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(kf, s_w): w (Cout, kh, kw, Cin) in fp32 with the per-input-channel
    activation scales s_a folded in when given, and its per-output-channel
    scale; differentiable in w, as in JAX."""
    kf = w.float()
    if s_a is not None:
        kf = kf * s_a
    return kf, _w_scale(kf)


def _weight_codes(w: torch.Tensor, s_a: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes of w (Cout, kh, kw, Cin), with the
    per-input-channel activation scales s_a folded in when given. Returns
    (codes int8 (Cout, kh, kw, Cin), s_w fp32 (Cout,))."""
    kf, s_w = _weight_scale(w, s_a)
    wq = torch.round(kf / s_w[:, None, None, None]).to(torch.int8)
    return wq.contiguous(), s_w


def _act_scale(act_absmax: torch.Tensor) -> torch.Tensor:
    """Per-input-channel activation scale of a calibrated conv."""
    return _div127(act_absmax.float().clamp_min(1e-12))


def _int8_operands(w: torch.Tensor, bias: Optional[torch.Tensor],
                   act_absmax: Optional[torch.Tensor], device: torch.device
                   ) -> Tuple[torch.Tensor, torch.Tensor,
                              Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The weight side of an int8 conv on w (Cout, kh, kw, Cin): the codes
    with Cin padded to 16 (the (Cout, K) matrix the kernel reads), s_w or,
    with act_absmax, the folded per-output-channel scale, the fp32 bias and
    the per-input-channel activation scale s_a (None when dynamic). The
    scale and the bias are differentiable in w and bias; the codes, rounded,
    carry no gradient."""
    s_a = None if act_absmax is None else _act_scale(act_absmax.to(device))
    wq, scale = _weight_codes(w, s_a)
    b = None if bias is None else bias.float()
    return _kernels.pad_channels(wq).contiguous(), scale, b, s_a


def _conv_int8(x: torch.Tensor, operands, strides: Tuple[int, int],
               pad: Tuple[int, int, int, int]) -> torch.Tensor:
    """The int8 conv on x (N, H, W, Cin) with the weight side of
    ``_int8_operands``: static (per-input-channel scales s_a) or dynamic (s_a
    None: one per-tensor scale from max|x|, computed on x's device)."""
    wq, scale, b, s_a = operands
    if s_a is None:
        # max|x| as JAX writes it: its gradient goes to the largest |x|
        # (aminmax would read x once, but has no derivative in torch 2.11)
        x_absmax = torch.amax(torch.abs(x)).float()
        s_x = torch.where(x_absmax > 0, _div127(x_absmax),
                          torch.ones_like(x_absmax))
        scale = s_x * scale
        xq = _kernels.quantize_nhwc(x, s_x)
    else:
        xq = _kernels.quantize_nhwc(x, s_a)
    return _kernels.int8_conv2d_nhwc(xq, wq, scale, b, strides, pad, x.dtype)


def _hwio(kernel: torch.Tensor) -> torch.Tensor:
    """(kh, kw, Cin, Cout) -> (Cout, kh, kw, Cin)."""
    return kernel.permute(3, 0, 1, 2)


def _strides(strides) -> Tuple[int, int]:
    return (strides,) * 2 if isinstance(strides, int) else tuple(strides)


def int8_conv(x: torch.Tensor, kernel: torch.Tensor, bias, strides,
              padding: Padding) -> torch.Tensor:
    """Dynamically quantized NHWC conv: int8 codes, int32 accumulation, fp32
    epilogue. x: (N, H, W, Cin); kernel: (kh, kw, Cin, Cout) in fp32/bf16.
    Returns x.dtype. An all-zero tensor maps to scale 1 (outputs 0)."""
    st = _strides(strides)
    pad = as_padding(padding, tuple(kernel.shape[:2]), st, tuple(x.shape[1:3]))
    return _conv_int8(x, _int8_operands(_hwio(kernel), bias, None, x.device),
                      st, pad)


def int8_conv_static(x: torch.Tensor, kernel: torch.Tensor, bias, strides,
                     padding: Padding, act_absmax: torch.Tensor
                     ) -> torch.Tensor:
    """Statically calibrated W8A8 conv: per-INPUT-channel activation scales
    (act_absmax (Cin,) / 127) folded into the weights, whose product is then
    quantized per output channel; activations are clipped to [-127, 127]."""
    st = _strides(strides)
    pad = as_padding(padding, tuple(kernel.shape[:2]), st, tuple(x.shape[1:3]))
    return _conv_int8(x, _int8_operands(_hwio(kernel), bias, act_absmax,
                                        x.device), st, pad)


def _ste_round(v: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (identity)."""
    return v + (torch.round(v) - v).detach()


def _fake_quant(x: torch.Tensor, w: torch.Tensor, bias, strides,
                pad: Tuple[int, int, int, int],
                act_absmax: torch.Tensor) -> torch.Tensor:
    """``fake_quant_conv`` on x (N, Cin, H, W) and w (Cout, Cin, kh, kw)."""
    s_a = _act_scale(act_absmax.to(x.device))
    v = _ste_round(x.float() / s_a[:, None, None])
    # jnp.clip's maximum/minimum: half the gradient where v sits on a bound
    lim = torch.full((), 127.0, device=x.device)
    xq = torch.minimum(torch.maximum(v, -lim), lim)
    kf = w.float() * s_a[:, None, None]
    s_w = _w_scale(kf.detach())
    wq = _ste_round(kf / s_w[:, None, None, None])
    y = F.conv2d(F.pad(xq, (pad[2], pad[3], pad[0], pad[1])), wq,
                 stride=strides)
    y = y * s_w[:, None, None]
    if bias is not None:
        y = y + bias.float()[:, None, None]
    return y.to(x.dtype)


def fake_quant_conv(x: torch.Tensor, kernel: torch.Tensor, bias, strides,
                    padding: Padding, act_absmax: torch.Tensor
                    ) -> torch.Tensor:
    """Quantization-aware-training forward: ``int8_conv_static`` numerics in
    float math. Rounds are straight-through, the activation clip passes the
    gradient inside [-127, 127] (half of it on a bound, as jnp.clip does),
    and the weight scale s_w is a constant (detached). x: (N, H, W, Cin);
    kernel: (kh, kw, Cin, Cout)."""
    st = _strides(strides)
    pad = as_padding(padding, tuple(kernel.shape[:2]), st, tuple(x.shape[1:3]))
    y = _fake_quant(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1), bias,
                    st, pad, act_absmax)
    return y.permute(0, 2, 3, 1)


def calibrate(model_apply: Callable, model: nn.Module,
              batches: Iterable) -> Dict[str, torch.Tensor]:
    """Per-conv per-input-channel abs-max over calibration batches.

    ``model`` is built with conv_mode="calibrate"; ``model_apply(model,
    batch)`` runs it. Maxima start at zero and accumulate across batches.
    Returns {conv path: act_absmax (Cin,) fp32}, the scales an
    ``int8_static`` (or ``fake_quant``) model loads with ``load_qscales``;
    the parameters are untouched."""
    convs = [m for m in model.modules()
             if isinstance(m, QConv) and m.resolved == "calibrate"]
    for m in convs:
        m.act_absmax.zero_()
    n = 0
    with torch.no_grad():
        for batch in batches:
            model_apply(model, batch)
            n += 1
    if n == 0:
        raise ValueError("calibrate() needs at least one batch")
    return {m.path: m.act_absmax.clone() for m in convs}


def qscales_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The JAX ``qscales`` (or ``qstats``) collection, nested dicts of numpy
    arrays ``{"encoder": {"conv_in": {"act_absmax": ...}}}``, as the port's
    {conv path: act_absmax} dict."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if k == "act_absmax":
                out["/".join(prefix)] = torch.tensor(v, dtype=torch.float32)
            else:
                walk(v, prefix + [k])

    walk(tree.get("qscales", tree), [])
    return out


class QConv(nn.Module):
    """A 2-D conv with ``weight`` (out, in, kh, kw) and ``bias`` (out,), the
    names and layout of ``nn.Conv2d``, in the mode its spec resolves to.

    ``padding`` is an int or ((top, bottom), (left, right)). The flax path
    (``set_path``) resolves a mixed spec; a conv built outside a model
    resolves against the empty path. Convs whose mode reads calibration
    scales hold them in ``act_absmax`` (Cin,) fp32, a non-persistent buffer
    (ones until loaded, as JAX's default), so ``state_dict`` is the same in
    every mode; dtype casts of the module leave it fp32.

    In ``int8`` and ``int8_static`` mode the weight side of the conv (the
    padded codes, s_w or the folded scale, the fp32 bias, the activation
    scales) is built once and kept, not rebuilt on every call, with the
    same code as the functional convs (so the same bits). It is rebuilt
    when the ``data_ptr``, dtype, device or version counter of ``weight``,
    ``bias`` or ``act_absmax`` changes: an in-place edit, ``load_state_dict``,
    ``load_qscales``, ``.to(dtype)`` or ``.to(device)``. Edits through
    ``.data`` bypass the version counter and are not seen. Inference tensors
    (parameters made under ``torch.inference_mode``) have no version
    counter, so such a conv builds its weight side on every call. The cache
    is no buffer: ``state_dict`` is the same in every mode. Gradients are
    JAX's: while autograd records, the scale and the bias are rebuilt from
    ``weight`` and ``bias`` (the codes stay cached: rounded, they carry no
    gradient), so weight, bias and, in ``int8``, x (through its scale)
    get the gradients ``jax.grad`` of the JAX convs gives.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: Union[int, Tuple[int, int]],
                 stride: int = 1, padding=0, bias: bool = True,
                 mode: ConvMode = "native"):
        super().__init__()
        kh, kw = ((kernel_size,) * 2 if isinstance(kernel_size, int)
                  else tuple(kernel_size))
        self.stride = (stride, stride)
        self.pad = ((padding,) * 4 if isinstance(padding, int)
                    else tuple(p for pair in padding for p in pair))
        self.mode = mode
        self.path: Optional[str] = None
        self.resolved: Optional[str] = None
        self.register_buffer("act_absmax", None, persistent=False)
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kh, kw))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self._int8_cache = None  # (key, weight side) of the int8 modes
        if not self.weight.is_meta:
            self.set_path("")

    def set_path(self, path: str) -> None:
        """Resolve the mode for the flax path ``path`` ("a/b/conv") and give
        the conv its scales when that mode reads them."""
        mode = resolve_conv_mode(self.mode, path.split("/") if path else ())
        if mode not in CONV_MODES:
            raise ValueError(f"conv mode {mode!r} not in {CONV_MODES}")
        self.path, self.resolved = path, mode
        absmax = None
        if mode in _SCALED:
            fill = 0.0 if mode == "calibrate" else 1.0
            absmax = torch.full((self.weight.shape[1],), fill,
                                device=self.weight.device)
        self.register_buffer("act_absmax", absmax, persistent=False)

    def _apply(self, fn, recurse=True):
        absmax = self.act_absmax
        out = super()._apply(fn, recurse)
        if absmax is not None:  # follow the weight's device, stay fp32
            self.act_absmax = absmax.to(self.weight.device)
        self._int8_cache = None
        return out

    def _int8_weight_side(self, device: torch.device):
        """The ``_int8_operands`` of this conv on `device`, from the cache
        while weight, bias and act_absmax are unchanged. When autograd
        records and weight or bias requires grad, the scale and the fp32
        bias are rebuilt from them with the same code (the same bits), so
        that gradients reach weight and bias as ``jax.grad`` gives them; the
        cached codes carry no gradient either way."""
        absmax = self.act_absmax if self.resolved == "int8_static" else None
        tensors = [t for t in (self.weight, self.bias, absmax)
                   if t is not None]
        key = operands = None
        if not any(t.is_inference() for t in tensors):
            key = (self.resolved, device) + tuple(
                (t.data_ptr(), t.dtype, t.device, t._version)
                for t in tensors)
            if self._int8_cache is not None and self._int8_cache[0] == key:
                operands = self._int8_cache[1]
        if operands is None:
            with torch.no_grad():
                operands = _int8_operands(self.weight.permute(0, 2, 3, 1),
                                          self.bias, absmax, device)
            if key is not None:
                self._int8_cache = (key, operands)
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (self.weight, self.bias)
                if t is not None):
            wq, _, _, s_a = operands
            _, scale = _weight_scale(self.weight.permute(0, 2, 3, 1), s_a)
            b = None if self.bias is None else self.bias.float()
            operands = (wq, scale, b, s_a)
        return operands

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mode = self.resolved
        if mode in ("int8", "int8_static"):
            xn = x.permute(0, 2, 3, 1)
            if not xn.is_contiguous():
                xn = xn.contiguous()
            return _conv_int8(xn, self._int8_weight_side(xn.device),
                              self.stride, self.pad).permute(0, 3, 1, 2)
        if mode == "fake_quant":
            return _fake_quant(x, self.weight, self.bias, self.stride,
                               self.pad, self.act_absmax)
        if mode == "calibrate":
            with torch.no_grad():
                torch.maximum(self.act_absmax,
                              torch.amax(x.detach().float().abs(),
                                         dim=(0, 2, 3)),
                              out=self.act_absmax)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        t, b, l, r = self.pad
        if t == b and l == r:
            return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                            self.stride, (t, l))
        return F.conv2d(F.pad(x.to(dtype), (l, r, t, b)),
                        self.weight.to(dtype), bias, self.stride)
