"""GroupNorm + optional SiLU: the hand-written Hopper kernel, its plain
PyTorch version, and the autograd wrapper.

Replaces the TPU kernel
``weatherforecastingtoolkit_tpu/ops/pallas/groupnorm.py::_gn_silu_kernel``
(launched by ``_gn_silu_forward``, public ``fused_group_norm_silu``). It
computes the same function: per (sample, group) fp32 mean and variance,
normalise, per-channel fp32 affine, optional SiLU, one cast back to the input
dtype.

On the H100 the kernel is bound by device-memory bytes: it must read x once
and write y once, and does about ten flops per element. Its design, in
``csrc/groupnorm_silu.cu``: one launch per call, one thread-block cluster per
slab (a sample times a run of whole groups) held in the cluster's shared
memory, so that x is read once; the cluster's blocks merge their partial
statistics through distributed shared memory in a fixed order (the same bits
every run). ``_plan`` cuts the call into slabs and clusters; it is pure, so
the CPU tests check it at every serving call shape. The kernel reads scale
and bias in their own dtype (fp32 or bf16), so the wrapper launches nothing
but the kernel and allocates only y. NCHW, unaligned views and shapes a
cluster cannot hold take a two-pass path (three launches).

Dispatch: a CPU tensor takes ``group_norm_silu_reference``; a CUDA tensor
launches the kernel or raises. The kernel is built with ``nvcc`` for
``sm_90a`` at first use into ``_build/`` (keyed by a hash of the source) and
bound with ``ctypes``. ``launches`` counts calls that launched it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from .build import CSRC, nvcc_build

SOURCE = CSRC / "groupnorm_silu.cu"

# The cluster kernel's limits (csrc/groupnorm_silu.cu): bytes of a block's
# shared memory kept for its static arrays and the system's share, groups a
# slab, and the channel runs it takes (one sector to 256 bytes).
STATIC_SMEM = 8192
MAX_SLAB_GROUPS = 64
RUN_BYTES = (32, 64, 128, 256)
# A block's share of a slab: 64 KB leaves room for three blocks an SM. The
# widest run (of 64 bytes or more) whose slab fits clusters of up to 8 such
# blocks wins, as longer runs use DRAM better; a frame too large for that
# (128x128) takes the widest run that fits clusters of 16. This is the
# best of the runs and cluster sizes tried on the H100 (PERF.md).
BLOCK_BYTES = 64 * 1024

# Number of kernel launches since the last reset (a caller sets it to 0).
launches = 0
# The last nvcc run in this process: seconds and output (ptxas -v).
build_seconds = 0.0
build_log = ""
_lib: Optional[ctypes.CDLL] = None
# device index -> (SMs, shared memory a block can opt into, largest cluster)
_limits: Dict[int, Tuple[int, int, int]] = {}


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
                   i, i, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    lib.gn_silu_device_limits.argtypes = [i, ctypes.POINTER(ctypes.c_int)]
    lib.gn_silu_device_limits.restype = ctypes.c_int
    _lib = lib
    return lib


def _device_limits(lib: ctypes.CDLL, index: int) -> Tuple[int, int, int]:
    """(SMs, shared memory a block can opt into, 16 or 8: the largest
    cluster the kernel schedules), asked once per device."""
    if index not in _limits:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(index):
            rc = lib.gn_silu_device_limits(index, out)
        if rc != 0:
            raise RuntimeError(f"gn_silu_device_limits failed with CUDA error {rc}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _limits[index] = (sms, out[0], out[1])
    return _limits[index]


def _plan(n: int, c: int, hw: int, groups: int, elem_bytes: int,
          smem_per_block: int, max_cluster: int) -> Tuple[int, int, int, int]:
    """Cut a channels_last call into slabs for the cluster kernel.

    Returns (groups per slab k, cluster size, positions per block, vec):
    - k * C/G channels a position form the slab's run: 32, 64, 128 or 256
      bytes, so a run is whole sectors of 16-byte vectors and starts on a
      16-byte boundary;
    - the run is the widest of at least 64 bytes whose slab (H*W positions
      times the run) fits a cluster of at most 8 blocks of BLOCK_BYTES
      each; failing that the widest that fits at most ``max_cluster`` (16
      where the card schedules it) such blocks; failing that the narrowest
      that fits at most ``max_cluster`` blocks of all their shared memory;
    - the cluster size is the fewest blocks that hold the slab;
    - vec: elements in a 16-byte vector.
    (0, 0, 0, vec) means the two-pass path (vec 1 when C is not a multiple
    of the vector). Pure: no CUDA, so the CPU tests check every call shape.
    """
    vec = 16 // elem_bytes
    if c % vec or c % groups:
        return 0, 0, 0, 1 if c % vec else vec
    run_of = (c // groups) * elem_bytes
    runs = [r for r in RUN_BYTES if r % run_of == 0 and groups % (r // run_of)
            == 0 and r // run_of <= MAX_SLAB_GROUPS]

    def fit(run: int, budget: int, most: int) -> int:
        cs = 1
        while cs <= most and -(-hw // cs) * run > budget:
            cs *= 2
        return cs if cs <= most else 0

    full = smem_per_block - STATIC_SMEM
    wide = [r for r in runs if r >= 64][::-1]
    choice = next(((run, cs) for budget, most, order in (
        (BLOCK_BYTES, min(8, max_cluster), wide),
        (BLOCK_BYTES, max_cluster, runs[::-1]),
        (full, max_cluster, runs))
        for run in order for cs in [fit(run, budget, most)] if cs), None)
    if choice is None:
        return 0, 0, 0, vec
    run, cs = choice
    return run // run_of, cs, -(-hw // cs), vec


def _chunks(n: int, c: int, hw: int, groups: int, vec: int,
            channels_last: bool, sms: int) -> int:
    """Two-pass path: blocks per sample (channels_last) or per (sample,
    group) (NCHW) in the statistics pass: enough to fill the card at N=1, at
    least four loads a thread. Any value >= 1 gives the same statistics."""
    target = 4 * sms
    if channels_last:
        tpr = c // vec
        rows = 1 if tpr >= 256 else 256 // tpr  # as csrc launch_two_pass()
        want, most = -(-target // n), -(-hw // (4 * rows))
    else:
        want = -(-target // (n * groups))
        most = -(-(c // groups) * hw // (4 * 256 * vec))
    return max(1, min(want, most, 65535))


def _param(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """scale or bias as the kernel reads it: (C,) contiguous fp32 or bf16 on
    x's device (no copy when it is that already)."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    if t.device != x.device or not t.is_contiguous():
        t = t.to(x.device).contiguous()
    return t


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
    s, b = _param(scale, x), _param(bias, x)
    if s.dtype != b.dtype:
        s, b = s.float(), b.float()
    index = x.device.index
    sms, smem, max_cluster = _device_limits(lib, index)
    hw = h * w
    aligned = x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    k = cs = ppb = chunks = 0
    part = mean_rstd = None
    if channels_last and aligned:
        k, cs, ppb, vec = _plan(n, c, hw, groups, x.element_size(), smem,
                                max_cluster)
    if not cs:                                    # the two-pass path
        vec = 16 // x.element_size()
        if (c if channels_last else hw) % vec or not aligned:
            vec = 1
        if channels_last and c // vec > 1024:
            raise ValueError(f"channels_last with C={c} exceeds one block's threads")
        chunks = _chunks(n, c, hw, groups, vec, channels_last, sms)
        part = torch.empty(n * groups * chunks * 3, device=x.device)
        mean_rstd = torch.empty(n * groups * 2, device=x.device)
    args = (x.data_ptr(), y.data_ptr(), s.data_ptr(), b.data_ptr(),
            0 if part is None else part.data_ptr(),
            0 if mean_rstd is None else mean_rstd.data_ptr(),
            n, c, hw, groups, eps, int(silu), int(channels_last),
            int(x.dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
            vec, k, cs, ppb, chunks)
    if index == torch.cuda.current_device():
        rc = lib.gn_silu_forward(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(index):
            rc = lib.gn_silu_forward(
                *args, torch.cuda.current_stream().cuda_stream)
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
