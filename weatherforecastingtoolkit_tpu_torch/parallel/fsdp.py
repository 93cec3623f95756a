"""Fully-sharded data parallelism, ZeRO-3 style (counterpart of
weatherforecastingtoolkit_tpu/parallel/fsdp.py, where GSPMD inserts the
collectives from the shardings of the state).

Every large leaf of the training state (parameters, optimizer moments, a
GAN's discriminator in ``extra``) is held as this rank's shard along one
dim chosen from its shape alone (``fsdp_spec``); leaves under
``MIN_SHARD_ELEMS`` stay replicated. A sharded parameter keeps its name and
place in its module (``named_parameters`` yields the shard, so optimizer
states line up with it), and reading the attribute (``conv.weight``)
all-gathers the full tensor through an autograd function whose backward
reduce-scatters the gradient (averaged over 'dp') back onto the shard. So
the optimizer updates shards, the full tensor lives only while it is used,
and the step is the data-parallel step.

Why not ``torch.distributed.fsdp.fully_shard``: it reduce-scatters in hooks
that fire when autograd accumulates into ``.grad``, and the GAN step takes
its gradients with ``torch.autograd.grad``, which accumulates nothing; its
bf16 copies also come from ``functional_call`` (``ops/amp.py``), which
swaps the very parameters FSDP2 manages. Here ``ops/amp.py::cast_floats``
casts the gathered full parameter (``unsharded``), as JAX casts the
all-gathered array: the same rounding as unsharded, and the gradient
reaches the fp32 shard through the cast and then the reduce-scatter.

The rule is JAX's on torch layouts: the largest dim divisible by the axis
size; on a tie the output features, dim 0 of a torch conv or linear weight
(JAX's "last dim" of flax's (kh, kw, cin, cout) kernel).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import DeviceLike, resolve_device
from .mesh import dp_group, dp_rank, dp_size, is_sharded

# Leaves smaller than this stay replicated: sharding tiny biases and scales
# buys nothing and costs a gather each.
MIN_SHARD_ELEMS = 4096


def fsdp_spec(shape, axis_size: int, axis: str = "dp",
              min_shard_elems: int = MIN_SHARD_ELEMS) -> Tuple:
    """The spec of a torch-layout leaf: a tuple with ``axis`` at the dim to
    shard (the largest divisible by ``axis_size``, ties to the first, i.e.
    the output features) and None elsewhere; () for a replicated leaf
    (small, or no dim divides)."""
    if not shape or int(np.prod(shape)) < min_shard_elems:
        return ()
    best = None
    for d, n in enumerate(shape):
        if n % axis_size == 0 and (best is None or n > shape[best]):
            best = d
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis
    return tuple(spec)


def _shard_dim(shape, mesh: DeviceMesh, min_shard_elems: int
               ) -> Optional[int]:
    spec = fsdp_spec(tuple(shape), dp_size(mesh), "dp", min_shard_elems)
    return spec.index("dp") if spec else None


def fsdp_sharding(leaf, mesh: DeviceMesh,
                  min_shard_elems: int = MIN_SHARD_ELEMS):
    """The placements of a leaf of this shape on ``mesh`` (1-D 'dp')."""
    d = _shard_dim(getattr(leaf, "shape", ()), mesh, min_shard_elems)
    return [Replicate()] if d is None else [Shard(d)]


@dataclasses.dataclass(frozen=True)
class ShardInfo:
    """Kept on a shard (``tensor._fsdp``): its dim, the full tensor's shape
    and strides, the 'dp' mesh it is split over."""
    dim: int
    shape: Tuple[int, ...]
    stride: Tuple[int, ...]
    mesh: DeviceMesh


class _Gather(torch.autograd.Function):
    """Forward: the full tensor from the ranks' shards (all-gather along
    ``dim``). Backward: the gradient's slice of this rank, summed over the
    ranks (reduce-scatter) and divided by their number: the gradient of the
    mean of the ranks' losses."""

    @staticmethod
    def forward(ctx, shard, info: ShardInfo):
        ctx.info, ctx.shard = info, (shard.shape, shard.stride())
        group, size = dp_group(info.mesh), dp_size(info.mesh)
        moved = shard.movedim(info.dim, 0).contiguous()
        if dist.get_backend(group) == "nccl":
            out = moved.new_empty((size * moved.shape[0],) + moved.shape[1:])
            dist.all_gather_into_tensor(out, moved, group=group)
        else:
            parts = [torch.empty_like(moved) for _ in range(size)]
            dist.all_gather(parts, moved, group=group)
            out = torch.cat(parts)
        # in the full parameter's memory format (the VAE's conv weights are
        # channels_last): another layout can take another conv algorithm,
        # other bits in bf16
        full = out.new_empty_strided(info.shape, info.stride)
        return full.copy_(out.movedim(0, info.dim))

    @staticmethod
    def backward(ctx, g):
        info = ctx.info
        group, size = dp_group(info.mesh), dp_size(info.mesh)
        moved = g.movedim(info.dim, 0).contiguous()
        if dist.get_backend(group) == "nccl":
            out = moved.new_empty((moved.shape[0] // size,) + moved.shape[1:])
            dist.reduce_scatter_tensor(out, moved, group=group)
        else:   # gloo: all-reduce, keep this rank's slice
            dist.all_reduce(moved, group=group)
            out = moved.chunk(size)[dp_rank(info.mesh)]
        # in the shard's memory format, as its optimizer moments: the
        # optimizer's fused _foreach kernels take matching layouts only (the
        # per-tensor fallback rounds otherwise)
        grad = out.new_empty_strided(*ctx.shard)
        return grad.copy_(out.div(size).movedim(0, info.dim)), None


def unsharded(t: torch.Tensor) -> torch.Tensor:
    """The full tensor of a shard (all-gathered, differentiable); any
    other tensor as it is."""
    info = getattr(t, "_fsdp", None)
    return t if info is None else _Gather.apply(t, info)


_CLASSES = {}


def _sharded_class(cls: type, names: Tuple[str, ...]) -> type:
    """``cls`` with a property per sharded parameter name that returns the
    gathered full tensor of whatever ``_parameters[name]`` holds (a tensor
    swapped in by ``functional_call`` as it is)."""
    key = (cls, names)
    if key not in _CLASSES:
        def prop(name):
            return property(lambda self: unsharded(self._parameters[name]))
        _CLASSES[key] = type(cls.__name__, (cls,),
                             {n: prop(n) for n in names})
    return _CLASSES[key]


def _shard_of(t: torch.Tensor, dim: int, mesh: DeviceMesh) -> torch.Tensor:
    return t.detach().chunk(dp_size(mesh), dim)[dp_rank(mesh)].clone()


def shard_module(module: nn.Module, mesh: DeviceMesh,
                 min_shard_elems: int = MIN_SHARD_ELEMS,
                 device: DeviceLike = None) -> nn.Module:
    """Replace, in place, each parameter that ``fsdp_spec`` shards by this
    rank's shard, and move the module to ``device``."""
    for sub in module.modules():
        names = []
        for name, p in list(sub._parameters.items()):
            if p is None or is_sharded(p):
                continue
            d = _shard_dim(p.shape, mesh, min_shard_elems)
            if d is None:
                continue
            shard = nn.Parameter(_shard_of(p, d, mesh),
                                 requires_grad=p.requires_grad)
            shard._fsdp = ShardInfo(d, tuple(p.shape), p.stride(), mesh)
            sub._parameters[name] = shard
            names.append(name)
        if names:
            sub.__class__ = _sharded_class(type(sub), tuple(names))
    return module.to(resolve_device(device))


def shard_tree(tree: Any, mesh: DeviceMesh,
               min_shard_elems: int = MIN_SHARD_ELEMS,
               device: DeviceLike = None) -> Any:
    """Every leaf at its shape-derived sharding on ``device``: modules in
    place (``shard_module``), tensors (optimizer moments, which mirror the
    parameters' shapes and so land on the same shards) replaced by their
    shards; generators, scalars and None unchanged."""
    dev = resolve_device(device)
    if isinstance(tree, nn.Module):
        return shard_module(tree, mesh, min_shard_elems, dev)
    if isinstance(tree, torch.Tensor):
        d = None if is_sharded(tree) else _shard_dim(tree.shape, mesh,
                                                      min_shard_elems)
        if d is None:
            return tree.to(dev)
        shard = _shard_of(tree, d, mesh).to(dev)
        shard._fsdp = ShardInfo(d, tuple(tree.shape), tree.stride(), mesh)
        return shard
    if isinstance(tree, Mapping):
        return {k: shard_tree(v, mesh, min_shard_elems, dev)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, mesh, min_shard_elems, dev)
                          for v in tree)
    return tree


def shard_train_state(state, mesh: DeviceMesh,
                      min_shard_elems: int = MIN_SHARD_ELEMS,
                      device: DeviceLike = None):
    """A TrainState for fully-sharded training: params, opt_state and extra
    (e.g. a GAN's discriminator and its moments) sharded; step and rng as
    they are."""
    def sh(t):
        return shard_tree(t, mesh, min_shard_elems, device)
    return state.replace(params=sh(state.params), opt_state=sh(state.opt_state),
                         extra=sh(state.extra))


def init_sharded(init_fn, seed: int, mesh: DeviceMesh,
                 min_shard_elems: int = MIN_SHARD_ELEMS,
                 device: DeviceLike = None) -> Any:
    """``init_fn(seed, cpu)``'s tree with each leaf sharded onto ``device``.

    The port draws initial values with numpy, one leaf after another from
    one stream per model (leaf k's values depend on the draws before it),
    so the leaves are drawn whole on the host and only this rank's shard of
    each goes to the device: the full state never sits on the device."""
    return shard_tree(init_fn(seed, torch.device("cpu")), mesh,
                      min_shard_elems, device)


def _leaves(tree: Any):
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def shard_fraction(tree: Any) -> float:
    """Bytes of ``tree`` held by this rank / the tree's global bytes: 1.0
    replicated, about 1/N fully sharded over N ranks."""
    here = total = 0
    for t in _leaves(tree):
        here += t.nbytes
        info = getattr(t, "_fsdp", None)
        total += (t.nbytes if info is None
                  else int(np.prod(info.shape)) * t.element_size())
    return here / total if total else 1.0
