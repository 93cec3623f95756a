"""Advection-diffusion residual loss: the hand-written Hopper kernel.

Replaces the TPU kernel
``weatherforecastingtoolkit_tpu/ops/pallas/stencil.py::_stencil_kernel``
(launched by ``advection_diffusion_loss(use_pallas=True)``). The plain
version, the dispatch and the autograd wrapper live in ``ops/stencil.py``.

On the H100 the kernel is bound by device-memory bytes (x read once, 14 flops
per interior element and pair) and, at the training batch, by launch latency.
Its design (one block per frame pair and band of rows reading x in place,
per-block partials, a fixed-order second pass; no float atomics) is described
in ``csrc/advection_stencil.cu``.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` (keyed by a hash of the source) and bound with ``ctypes``.
``launches`` counts calls that launched it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .build import CSRC, nvcc_build

SOURCE = CSRC / "advection_stencil.cu"
# Interior rows per block: 8 bands of a 128-row frame.
BAND_ROWS = 16

# Number of kernel launches since the last reset (a caller sets it to 0).
launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    so, seconds, out = nvcc_build(SOURCE)
    if seconds:
        build_seconds, build_log = seconds, out
    lib = ctypes.CDLL(str(so))
    fn = lib.advection_stencil_forward
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def advection_stencil_cuda(x: torch.Tensor,
                           params: torch.Tensor) -> torch.Tensor:
    """Mean squared residual of x (B, T, C, H, W) fp32 on the card; params
    holds (u, v, kappa) as three fp32 values on x's device. Returns a 0-d
    fp32 tensor. Launches on PyTorch's current stream; no host sync."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"advection_stencil_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"advection_stencil_cuda takes fp32, got {x.dtype}")
    if x.ndim != 5:
        raise ValueError(f"expected (B, T, C, H, W), got {tuple(x.shape)}")
    b, t, c, h, w = x.shape
    if t < 2:
        raise ValueError("need at least 2 frames for a temporal difference")
    if h < 3 or w < 3:
        raise ValueError(f"need H >= 3 and W >= 3 for the interior, got {h}x{w}")
    if (params.device != x.device or params.dtype != torch.float32
            or params.shape != (3,)):
        raise ValueError("params must be 3 fp32 values on x's device, got "
                         f"{tuple(params.shape)} {params.dtype} {params.device}")
    x = x.contiguous()
    params = params.contiguous()
    lib = build()
    bands = -(-(h - 2) // BAND_ROWS)
    f32 = dict(device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        part = torch.empty(b * c * (t - 1) * bands, **f32)
        out = torch.empty((), **f32)
        rc = lib.advection_stencil_forward(
            x.data_ptr(), params.data_ptr(), part.data_ptr(), out.data_ptr(),
            b, t, c, h, w, BAND_ROWS, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"advection_stencil_forward failed with CUDA error {rc}")
    launches += 1
    return out
