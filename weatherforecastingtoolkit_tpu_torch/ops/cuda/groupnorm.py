"""GroupNorm + optional SiLU: the hand-written Hopper kernel, its plain
PyTorch version, and the autograd wrapper.

Replaces the TPU kernel
``weatherforecastingtoolkit_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel``
(launched by ``_gn_silu_forward``, public ``fused_group_norm_silu``). It
computes the same function: per (sample, group) fp32 mean and variance,
normalise, per-channel fp32 affine, optional SiLU, one cast back to the input
dtype.

On the H100 the kernel is bound by device-memory bytes: it must read x once
and write y once, and does about ten flops per element. Its design (split
statistics pass, deterministic Chan combine, vectorised apply pass; no float
atomics) is described in ``csrc/groupnorm_silu.cu``.

Dispatch: a CPU tensor takes ``group_norm_silu_reference``; a CUDA tensor
launches the kernel or raises. The kernel is built with ``nvcc`` for
``sm_90a`` at first use into ``_build/`` (keyed by a hash of the source) and
bound with ``ctypes``. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CSRC, nvcc_build

SOURCE = CSRC / "groupnorm_silu.cu"

# Number of kernel launches since the last reset (a caller sets it to 0).
launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None


def group_norm_silu_reference(x: torch.Tensor, scale: torch.Tensor,
                              bias: torch.Tensor, groups: int, eps: float,
                              silu: bool) -> torch.Tensor:
    """Plain version on NCHW, a copy of ``_gn_silu_reference``: statistics,
    affine and SiLU in fp32, one cast to x's dtype at the end."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    affine = (c,) + (1,) * (x.ndim - 2)
    y = xn * scale.float().reshape(affine) + bias.float().reshape(affine)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so, seconds, out = nvcc_build(SOURCE)
    if seconds:
        build_seconds, build_log = seconds, out
    lib = ctypes.CDLL(str(so))
    fn = lib.gn_silu_forward
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, ll, ll, ll, i, ctypes.c_float,
                   i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _chunks(n: int, c: int, hw: int, groups: int, vec: int,
            channels_last: bool) -> int:
    """Blocks per sample (channels_last) or per (sample, group) (NCHW) in the
    statistics pass: enough to fill the card at N=1, at least four loads a
    thread. Any value >= 1 gives the same statistics."""
    target = 4 * torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count
    if channels_last:
        tpr = c // vec
        rows = 1 if tpr >= 256 else 256 // tpr  # as csrc launch()
        want, most = -(-target // n), -(-hw // (4 * rows))
    else:
        want = -(-target // (n * groups))
        most = -(-(c // groups) * hw // (4 * 256 * vec))
    return max(1, min(want, most, 65535))


def group_norm_silu_cuda(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, groups: int, eps: float,
                         silu: bool) -> torch.Tensor:
    """Launch the kernel on x's device and PyTorch's current stream."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"group_norm_silu_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_silu_cuda takes fp32 or bf16, got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"expected (N, C, H, W), got {tuple(x.shape)}")
    n, c, h, w = x.shape
    if c % groups or scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"C={c}, groups={groups}, scale {tuple(scale.shape)},"
                         f" bias {tuple(bias.shape)}")
    if x.is_contiguous():
        channels_last = False
    elif x.is_contiguous(memory_format=torch.channels_last):
        channels_last = True
    else:
        raise ValueError("x must be contiguous NCHW or channels_last")
    lib = build()
    y = torch.empty_like(x, memory_format=torch.channels_last if channels_last
                         else torch.contiguous_format)
    if x.numel() == 0:
        return y
    hw = h * w
    vec = 16 // x.element_size()
    if ((c if channels_last else hw) % vec or x.data_ptr() % 16
            or y.data_ptr() % 16):
        vec = 1
    if channels_last and c // vec > 1024:
        raise ValueError(f"channels_last with C={c} exceeds one block's threads")
    f32 = dict(device=x.device, dtype=torch.float32)
    s = scale.detach().to(**f32).contiguous()
    b = bias.detach().to(**f32).contiguous()
    with torch.cuda.device(x.device):
        chunks = _chunks(n, c, hw, groups, vec, channels_last)
        part = torch.empty(n * groups * chunks * 3, **f32)
        mean_rstd = torch.empty(n * groups * 2, **f32)
        rc = lib.gn_silu_forward(
            x.data_ptr(), y.data_ptr(), s.data_ptr(), b.data_ptr(),
            part.data_ptr(), mean_rstd.data_ptr(), n, c, hw, groups, eps,
            int(silu), int(channels_last), int(x.dtype == torch.bfloat16),
            vec, chunks, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gn_silu_forward failed with CUDA error {rc}")
    launches += 1
    return y


class GroupNormSiLUFunction(torch.autograd.Function):
    """Forward: the kernel (plain version for a CPU tensor). Backward: the
    autograd of the plain version, as the JAX ``_bwd`` differentiates
    ``_gn_silu_reference``."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (groups, eps, silu)
        if x.device.type == "cpu":
            return group_norm_silu_reference(x, scale, bias, groups, eps, silu)
        return group_norm_silu_cuda(x, scale, bias, groups, eps, silu)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) for t, need in
                      zip((x, scale, bias), ctx.needs_input_grad[:3])]
            y = group_norm_silu_reference(*leaves, *ctx.args).float()
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, g.float()))
        return tuple(next(grads) if t.requires_grad else None
                     for t in leaves) + (None, None, None)


def group_norm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-6,
                    silu: bool = True) -> torch.Tensor:
    """GroupNorm + optional SiLU over (N, C, H, W), NCHW or channels_last.

    A CPU tensor runs the plain version; a CUDA tensor the Hopper kernel.
    Differentiable in x, scale and bias."""
    return GroupNormSiLUFunction.apply(x, scale, bias, groups, eps, silu)
