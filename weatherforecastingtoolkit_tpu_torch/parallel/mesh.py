"""Process group, device mesh and data-parallel helpers (counterpart of
weatherforecastingtoolkit_tpu/parallel/mesh.py).

JAX writes one global program and lets GSPMD partition it; here every
process runs its own rows of the batch and the collectives are explicit:

  * ``init_distributed`` starts the process group (``tcp://`` rendezvous;
    NCCL on the card, gloo on the CPU); ``make_mesh`` builds a
    ``DeviceMesh`` of ``('dp',)`` or ``('dp', 'mp')`` over its processes, a
    mesh of one when no group was started;
  * a batch is split over ``'dp'`` (``shard_batch``: this rank's rows of a
    global batch, the global batch being the ranks' rows in rank order) and
    the parameters are the same on every rank (``replicate``);
  * inside ``data_parallel(mesh)`` a train step averages its gradients over
    ``'dp'`` (``reduce_gradients``, in flattened buckets), and draws its
    noise for the global batch from the shared generator, keeping its own
    rows (``randn_rows``), so a step on N ranks is the one-process step on
    the concatenated batch, as JAX's sharded step is.

A tensor-parallel ``'mp'`` axis shards the bottleneck dense layers: flax
keeps a dense kernel as (in, out) and torch as (out, in), so JAX's
``P(None, 'mp')`` over the output features is ``Shard(0)`` of a torch
``Linear.weight`` (``mp_dense_spec``, torch's ``ColwiseParallel``); its
row-parallel partner is ``Shard(1)`` (``RowwiseParallel``).
"""

from __future__ import annotations

import contextlib
import datetime
from collections.abc import Mapping
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.device import DeviceLike, resolve_device

# Gradients are averaged in buckets of at most this many bytes: a few
# collectives a step rather than one per parameter.
BUCKET_BYTES = 64 << 20
# How long a collective or a rendezvous waits before it fails.
TIMEOUT = datetime.timedelta(seconds=300)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     device: DeviceLike = None) -> None:
    """Join the process group at ``coordinator_address`` ("host:port") as
    rank ``process_id`` of ``num_processes``. No-op when the address is
    None (single process). The backend is NCCL when ``device`` is the card
    (the default) and gloo on the CPU, unless one is named; on the card the
    process takes GPU ``process_id % device_count``."""
    if coordinator_address is None:
        return
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def make_mesh(axes: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over every process of the group, axes named
    ``axes``; ``shape`` defaults to (world, 1, ...). ValueError when the
    shape does not hold the world. Without a process group it starts one of
    a single process, so single-process callers get a mesh of one."""
    device_type = device_type or resolve_device(None).type
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1,
                                timeout=TIMEOUT)
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} processes")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _dim(mesh: DeviceMesh, axis: str = "dp") -> int:
    return mesh.mesh_dim_names.index(axis)


def dp_group(mesh: DeviceMesh) -> dist.ProcessGroup:
    return mesh.get_group(_dim(mesh))


def dp_size(mesh: DeviceMesh) -> int:
    return mesh.size(_dim(mesh))


def dp_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(_dim(mesh))


def dp_sharding(mesh: DeviceMesh) -> List:
    """Placements sharding dim 0 (the batch) over 'dp', replicated over the
    other axes (JAX ``P('dp')``)."""
    return [Shard(0) if name == "dp" else Replicate()
            for name in mesh.mesh_dim_names]


def replicated(mesh: DeviceMesh) -> List:
    return [Replicate() for _ in mesh.mesh_dim_names]


def mp_dense_spec(mesh: DeviceMesh, axis: str = "mp") -> List:
    """Placements of a column-parallel ``Linear.weight`` (out, in): its
    output features over ``axis`` (JAX ``P(None, 'mp')`` on flax's
    (in, out) kernel)."""
    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows of every array of a global batch (the ranks' rows
    in rank order make the global batch)."""
    size, rank = dp_size(mesh), dp_rank(mesh)

    def rows(a):
        if not hasattr(a, "shape") or not len(a.shape):
            return a
        if a.shape[0] % size:
            raise ValueError(f"batch of {a.shape[0]} does not split over "
                             f"{size} ranks")
        n = a.shape[0] // size
        return a[rank * n:(rank + 1) * n]

    return _tree_map(rows, batch)


def local(t: torch.Tensor) -> torch.Tensor:
    """The tensor this rank holds: a DTensor's local shard, else t."""
    return t.to_local() if isinstance(t, DTensor) else t


@torch.no_grad()
def replicate(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Broadcast dp-rank 0's parameters and buffers to the other ranks of
    its 'dp' group, in place (a tensor-parallel leaf keeps its own 'mp'
    shard)."""
    group = dp_group(mesh)
    src = dist.get_global_rank(group, 0)
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(local(t).data, src=src, group=group)
    return module


# -- the data-parallel step ---------------------------------------------------
_ACTIVE: Optional[DeviceMesh] = None


@contextlib.contextmanager
def data_parallel(mesh: Optional[DeviceMesh]) -> Iterator[None]:
    """Within the block, ``reduce_gradients`` averages over ``mesh``'s
    'dp' axis and ``randn_rows`` draws for the global batch (no-op with
    ``mesh=None``)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, mesh if mesh is not None else _ACTIVE
    try:
        yield
    finally:
        _ACTIVE = prev


def active_mesh() -> Optional[DeviceMesh]:
    return _ACTIVE


def is_sharded(t: torch.Tensor) -> bool:
    """True for a leaf that ``parallel/fsdp.py`` holds as this rank's shard
    (its gradient arrives already reduced)."""
    return getattr(t, "_fsdp", None) is not None


def _buckets(tensors: Sequence[torch.Tensor]) -> Iterator[List[torch.Tensor]]:
    """Consecutive runs of tensors of one dtype and device, each run at
    most BUCKET_BYTES (a larger tensor alone)."""
    run, nbytes = [], 0
    for t in tensors:
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or nbytes + t.nbytes > BUCKET_BYTES):
            yield run
            run, nbytes = [], 0
        run.append(t)
        nbytes += t.nbytes
    if run:
        yield run


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     mesh: Optional[DeviceMesh] = None) -> None:
    """Average ``tensors`` over the 'dp' axis in place, one collective a
    flattened bucket. No-op without a mesh (given or active)."""
    mesh = mesh if mesh is not None else _ACTIVE
    if mesh is None:
        return
    group, size = dp_group(mesh), dp_size(mesh)
    for run in _buckets([local(t) for t in tensors]):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        torch._foreach_copy_(run, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in run]), run)])


def reduce_gradients(grads: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor]) -> None:
    """Average the gradients of the replicated parameters over 'dp' in
    place (a sharded parameter's gradient arrives reduced by its gather's
    backward). No-op outside ``data_parallel``."""
    if _ACTIVE is not None:
        all_reduce_mean_([g for g, p in zip(grads, params)
                          if not is_sharded(p)])


def randn_rows(shape: Sequence[int], generator: Optional[torch.Generator],
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``torch.randn(shape)`` for this rank's rows: inside
    ``data_parallel`` the draw is for the global batch (every rank draws
    it from the same generator) and the rank keeps its rows."""
    if _ACTIVE is None:
        return torch.randn(tuple(shape), generator=generator, device=device,
                           dtype=dtype)
    size, rank = dp_size(_ACTIVE), dp_rank(_ACTIVE)
    n = shape[0]
    full = torch.randn((size * n,) + tuple(shape[1:]), generator=generator,
                       device=device, dtype=dtype)
    return full[rank * n:(rank + 1) * n]


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the 'dp' ranks inside ``data_parallel`` (a new
    tensor), else ``t``."""
    if _ACTIVE is None:
        return t
    t = t.clone()
    dist.all_reduce(t, group=dp_group(_ACTIVE))
    return t


def agree_min(n: int, mesh: Optional[DeviceMesh]) -> int:
    """The smallest ``n`` over the ranks of ``mesh``'s 'dp' axis (one
    all-reduce); ``n`` without a mesh."""
    if mesh is None:
        return n
    t = torch.tensor([n], device=_device_of(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=dp_group(mesh))
    return int(t.item())


def _device_of(mesh: DeviceMesh) -> torch.device:
    """Where a collective's tensor lives: NCCL takes CUDA tensors, gloo
    CPU tensors (and CUDA ones for all-reduce and broadcast only)."""
    if dist.get_backend(dp_group(mesh)) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on every rank; under gloo the gather goes through the host.
    Returns a tensor on t's device."""
    group = dp_group(mesh)
    src = t.contiguous().to(_device_of(mesh))
    parts = [torch.empty_like(src) for _ in range(dp_size(mesh))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)
