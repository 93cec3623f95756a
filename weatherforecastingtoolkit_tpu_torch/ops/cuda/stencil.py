"""Advection-diffusion residual loss: the hand-written Hopper kernel.

Replaces the TPU kernel
``weatherforecastingtoolkit_tpu/ops/pallas/stencil.py::_stencil_kernel``
(launched by ``advection_diffusion_loss(use_pallas=True)``). The plain
version and the custom op ``wftk::advection_stencil``, whose CUDA
implementation is ``advection_stencil_cuda_scalars``, live in
``ops/stencil.py``.

On the H100 the kernel is bound by device-memory bytes (x read once, 14 flops
per interior element and pair) and, at the training batch, by launch latency.
Its design, in ``csrc/advection_stencil.cu``: one launch; a block owns
(b, c, band of rows) and walks t with a ring of frames' bands in shared
memory, so each frame is read once; the last block to finish sums the
per-block partials in a fixed order (an integer ticket, no float atomics).
``_band`` picks the band height and the ring depth from the shape.

The wrapper keeps the kernel's ticket counters: slots of one zeroed buffer a
device, which the kernel leaves at zero. Two launches that may run at once
never share a slot. Eager launches take one slot per stream (a stream runs
them one after another). A launch captured into a CUDA graph takes a slot of
its capture and stream, kept for the life of the process, so a replay on any
stream shares it with no eager launch and no other graph. Replays of one
graph must not overlap one another, as for any CUDA graph: they share its
memory. The wrapper allocates only the output and the partials, and enters
no device context when x lies on the current device.

The kernel is built with ``nvcc`` for ``sm_90a`` at first use into
``_build/`` (keyed by a hash of the source) and bound with ``ctypes``.
``launches`` counts calls that launched it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .build import CSRC, nvcc_build

SOURCE = CSRC / "advection_stencil.cu"
# Band height: enough bands for about TARGET_BLOCKS blocks, within
# [MIN_BAND_ROWS, MAX_BAND_ROWS]; the ring of bands fits SMEM_BUDGET bytes
# and holds at most MAX_RING frames (the kernel's kMaxRing). At the training
# batch of 2 that is 2-row bands (126 blocks; the fastest of 1, 2 and 4 rows
# on the H100, and faster than one cluster of 16 blocks whose sums meet in
# distributed shared memory), at 32 16-row bands (256 blocks).
TARGET_BLOCKS = 256
MIN_BAND_ROWS, MAX_BAND_ROWS = 2, 64
SMEM_BUDGET = 96 * 1024
MAX_RING = 16
# ticket counters a device: one per stream that has launched the kernel
# eagerly, and one per (capture, stream) of the CUDA graphs that hold it
COUNTER_SLOTS = 4096

# Number of kernel launches since the last reset (a caller sets it to 0).
launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None
_counters: Dict[int, torch.Tensor] = {}            # device -> zeroed slots
# (device, capture id or 0 when eager, stream) -> slot
_slots: Dict[Tuple[int, int, int], int] = {}


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
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, p, ll, i, i, i, i, ll, ll, ll, i, i, i, i,
                   p]
    fn.restype = ctypes.c_int
    lib.advection_stencil_capture_id.argtypes = [p]
    lib.advection_stencil_capture_id.restype = ctypes.c_ulonglong
    _lib = lib
    return lib


def _band(b: int, c: int, t: int, h: int, w: int) -> Tuple[int, int]:
    """(interior rows a block, frames kept on chip) for x (B, T, C, H, W),
    planned at 4 bytes an element (a bf16 band takes half of it)."""
    row_bytes = 4 * w
    rows = max(MIN_BAND_ROWS, -(-(h - 2) * b * c // TARGET_BLOCKS))
    rows = min(rows, MAX_BAND_ROWS, h - 2)
    while rows > 1 and 2 * (rows + 2) * row_bytes > SMEM_BUDGET:
        rows //= 2
    if 2 * (rows + 2) * row_bytes > SMEM_BUDGET:
        raise ValueError(f"W={w} is too wide for the stencil kernel's ring")
    ring = min(t, MAX_RING, SMEM_BUDGET // ((rows + 2) * row_bytes))
    return rows, max(ring, 2)


def _ticket(index: int, capture: int, stream: int) -> int:
    """Address of the zeroed ticket counter of a launch on (device, stream):
    ``capture`` is the id of the CUDA graph capture the launch is recorded
    into, 0 for an eager launch."""
    key = (index, capture, stream)
    slot = _slots.get(key)
    if slot is None:
        if index not in _counters:
            if capture:
                raise RuntimeError("call advection_stencil_cuda once outside "
                                   "CUDA graph capture first")
            _counters[index] = torch.zeros(COUNTER_SLOTS, dtype=torch.int32,
                                           device=torch.device("cuda", index))
            torch.cuda.synchronize(index)
        slot = sum(1 for d, _, _ in _slots if d == index)
        if slot >= COUNTER_SLOTS:
            raise RuntimeError(f"more than {COUNTER_SLOTS} streams and CUDA "
                               "graph captures launched the stencil kernel "
                               "on one device")
        _slots[key] = slot
    return _counters[index].data_ptr() + 4 * slot


def _check(x: torch.Tensor) -> torch.Tensor:
    """Refuse what the kernel does not take; x with each (H, W) frame dense
    (a copy only when it is not)."""
    if not x.is_cuda:
        raise ValueError(f"advection_stencil_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"advection_stencil_cuda takes fp32 or bf16, got {x.dtype}")
    if x.ndim != 5:
        raise ValueError(f"expected (B, T, C, H, W), got {tuple(x.shape)}")
    b, t, c, h, w = x.shape
    if t < 2:
        raise ValueError("need at least 2 frames for a temporal difference")
    if h < 3 or w < 3:
        raise ValueError(f"need H >= 3 and W >= 3 for the interior, got {h}x{w}")
    if x.stride(4) != 1 or x.stride(3) != w:
        x = x.contiguous()
    return x


def _launch(x: torch.Tensor, u: int, v: int, kappa: int) -> torch.Tensor:
    """Launch on x (checked) with u, v, kappa as device addresses."""
    global launches
    index = x.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(x, u, v, kappa)
    lib = build()
    b, t, c, h, w = x.shape
    sb, st, sc = x.stride()[:3]
    rows, ring = _band(b, c, t, h, w)
    per16 = 16 // x.element_size()      # elements a 16-byte copy
    vec4 = w % per16 == 0 and x.data_ptr() % 16 == 0 and not (
        sb % per16 or st % per16 or sc % per16)
    part = torch.empty(b * c * -(-(h - 2) // rows), device=x.device)
    out = torch.empty((), device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    capture = (lib.advection_stencil_capture_id(stream)
               if torch.cuda.is_current_stream_capturing() else 0)
    rc = lib.advection_stencil_forward(
        x.data_ptr(), u, v, kappa, part.data_ptr(),
        _ticket(index, capture, stream),
        out.data_ptr(), b, t, c, h, w, sb, st, sc, rows, ring, int(vec4),
        int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"advection_stencil_forward failed with CUDA error {rc}")
    launches += 1
    return out


def advection_stencil_cuda(x: torch.Tensor,
                           params: torch.Tensor) -> torch.Tensor:
    """Mean squared residual of x (B, T, C, H, W) fp32 or bf16 on the card
    (bf16 differences, fp32 residual, as ``ops/stencil.py`` says); params
    holds (u, v, kappa) as three fp32 values on x's device. Returns a 0-d
    fp32 tensor. Launches on PyTorch's current stream; no host sync."""
    x = _check(x)
    if (params.device != x.device or params.dtype != torch.float32
            or params.shape != (3,)):
        raise ValueError("params must be 3 fp32 values on x's device, got "
                         f"{tuple(params.shape)} {params.dtype} {params.device}")
    params = params.contiguous()          # held until the launch
    p = params.data_ptr()
    return _launch(x, p, p + 4, p + 8)


def advection_stencil_cuda_scalars(x: torch.Tensor, u: torch.Tensor,
                                   v: torch.Tensor,
                                   kappa: torch.Tensor) -> torch.Tensor:
    """As ``advection_stencil_cuda`` with u, v and kappa as three one-element
    fp32 tensors on x's device, read where they lie: no kernel packs them."""
    x = _check(x)
    for s in (u, v, kappa):
        if s.device != x.device or s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError("u, v and kappa must be one fp32 value each on "
                             f"x's device, got {s.dtype} {s.device} "
                             f"{tuple(s.shape)}")
    return _launch(x, u.data_ptr(), v.data_ptr(), kappa.data_ptr())
