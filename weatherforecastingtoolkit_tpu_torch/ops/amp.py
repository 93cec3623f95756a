"""bf16 mixed-precision training helpers: fp32 master parameters, bf16
compute (counterpart of weatherforecastingtoolkit_tpu/ops/amp.py).

The recipe is the JAX package's, explicit casting and not ``torch.autocast``:
every fp32 parameter and the input are cast to bf16, the whole network runs
in bf16, and its outputs are cast to fp32 for the loss. autocast picks a
dtype per operation and would compute another function. bf16 has fp32's
exponent range, so there is no loss scaling: the cast is differentiable and
gradients reach the fp32 masters through it.

A module runs on bf16 copies of its parameters through
``torch.func.functional_call`` (``cast_call``); the optimizer keeps updating
the fp32 masters.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable

import torch
from torch import nn
from torch.func import functional_call


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def cast_floats(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Cast every fp32 tensor leaf of a tensor, dict, list or tuple to
    ``dtype``; everything else unchanged. An ``nn.Module`` gives the dict
    {name: parameter} of its parameters, cast: the dict ``functional_call``
    takes. The casts are differentiable."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    return _tree_map(lambda a: a.to(dtype) if a.dtype == torch.float32 else a,
                     tree)


def to_f32(tree: Any) -> Any:
    """Cast floating tensor leaves back to fp32 (loss math, metrics)."""
    return _tree_map(lambda a: a.float() if a.is_floating_point() else a, tree)


class _Bound(nn.Module):
    """fn(module, *args) as a module's forward, so that ``functional_call``
    swaps the parameters for every use of the module inside fn (its
    ``encode``, ``decode``, ... and not only its ``forward``)."""

    def __init__(self, module: nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self, *args, **kwargs):
        return self.fn(self.module, *args, **kwargs)


def cast_call(fn: Callable, module: nn.Module, *args,
              dtype: torch.dtype = torch.bfloat16, **kwargs):
    """fn(module, *args, **kwargs) with the module's fp32 parameters replaced
    by ``dtype`` copies for the call and the fp32 tensors among args cast;
    the outputs come back as fn returns them (cast them with ``to_f32``).
    Gradients reach the fp32 parameters through the casts."""
    params = {f"module.{k}": v for k, v in cast_floats(module, dtype).items()}
    return functional_call(_Bound(module, fn), params,
                           cast_floats(args, dtype), cast_floats(kwargs, dtype))


def mixed_loss(loss_fn: Callable) -> Callable:
    """Wrap a Task loss_fn(model, batch, rng, step) for bf16 compute: the
    model's parameters and the batch are cast to bf16 (the fp32 masters stay
    outside); the loss and aux come back fp32. The loss reduction runs in
    the dtype the wrapped fn produces: a task wanting fp32 reductions over
    bf16 activations casts explicitly (as ``reconstruction_task`` and
    ``make_vae_gan_task`` do)."""

    def wrapped(model, batch, rng, step):
        loss, aux = cast_call(lambda m, b: loss_fn(m, b, rng, step), model,
                              batch)
        return loss.float(), to_f32(aux)

    return wrapped
