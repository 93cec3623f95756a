"""Data-parallel and member-parallel serving, and the exported pipeline
(counterpart of weatherforecastingtoolkit_tpu/parallel/serving.py).

The rollout is independent per sample, and the ensemble per member, so
both scale out with no collective inside the model: each rank runs its rows
(or its members) through the single-card program and the results are
gathered. ``export_pipeline`` writes the pipeline as a ``torch.export``
program with a symbolic batch, which ``load_pipeline`` serves without the
model code. Each hand-written kernel is a custom op the program calls:
``torch.ops.wftk.group_norm_silu`` (``ops/cuda/groupnorm.py``),
``wftk::int8_quantize`` and ``wftk::int8_conv2d`` (``ops/cuda/int8_conv.py``)
and ``wftk::advection_stencil`` (``ops/stencil.py``), registered when those
modules are imported. So the int8 pipelines export as the bf16 and fp32
ones do: the weight codes of each int8 conv enter the program as constants
(``ops/quant.py::QConv`` builds them outside the trace).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from .mesh import all_gather_rows, dp_rank, dp_size, replicate


def make_dp_serving_fn(pipeline: Callable, mesh: DeviceMesh,
                       params=None) -> Callable:
    """Wrap pipeline(params, frames) for dp-sharded batch serving.

    Returns serve(frames, params=None) -> np.ndarray of the whole batch's
    predictions on every rank, where frames (B, T, C, H, W) is the global
    host batch. A batch not divisible by the dp size is padded with its last
    sample, and the padding stripped after. A module given as ``params`` is
    replicated from rank 0."""
    size, rank = dp_size(mesh), dp_rank(mesh)
    if isinstance(params, nn.Module):
        replicate(params, mesh)
    fixed = params

    def serve(frames, params=None):
        p = params if params is not None else fixed
        if p is None:
            raise ValueError("params must be given at build or call time")
        b = frames.shape[0]
        pad = (-b) % size
        if pad:
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], pad, axis=0)], axis=0)
        n = frames.shape[0] // size
        out = pipeline(p, frames[rank * n:(rank + 1) * n])
        return all_gather_rows(out, mesh)[:b].cpu().numpy()

    return serve


def make_member_parallel_ensemble(*, mesh: DeviceMesh, n_members: int,
                                  **ensemble_kw) -> Callable:
    """Ensemble members split over the ranks (probabilistic serving).

    Takes ``make_ensemble_pipeline``'s keywords (``n_members`` apart; it must
    divide by the mesh size). Returns ensemble(fc_params, frames, seed,
    noise_std) -> (B, n_members, T_out, C, H, W) on every rank: rank r runs
    shard r's n_members / size members with the generator
    ``models/rollout.py::batch_generator(seed, r)`` (seeded by numpy's
    SeedSequence([seed, r]): the counterpart of ``jax.random.split(key,
    n)[r]``, each shard its own stream), and the shards are gathered
    shard-major."""
    from ..models.rollout import batch_generator, make_ensemble_pipeline

    size, rank = dp_size(mesh), dp_rank(mesh)
    if n_members % size:
        raise ValueError(f"n_members={n_members} must be divisible by the "
                         f"mesh size {size}")
    n_local = n_members // size
    local = make_ensemble_pipeline(n_members=n_local, **ensemble_kw)

    def ensemble(fc_params, frames, seed: int, noise_std: float):
        out = local(fc_params, frames,
                    batch_generator(seed, rank, ensemble_kw.get("device")),
                    noise_std)                       # (B, n_local, ...)
        shards = all_gather_rows(out.transpose(0, 1).contiguous(), mesh)
        return shards.transpose(0, 1)                # (B, n_members, ...)

    ensemble.members_per_rank = n_local
    return ensemble


class _Exported(nn.Module):
    """pipeline(params, frames) as a module's forward: the forecaster
    ``params`` (a module) is its submodule; the frozen VAE the pipeline
    closes over is held as constants of the exported program."""

    def __init__(self, fn: Callable, params):
        super().__init__()
        self.fn, self.params = fn, params

    def forward(self, frames):
        return self.fn(self.params, frames)


def export_pipeline(pipeline: Callable, params, example_frames, path: str,
                    batch_symbolic: bool = True) -> torch.export.ExportedProgram:
    """Write pipeline(params, frames) to ``path`` as a ``torch.export``
    program (``torch.export.save``), loadable and servable without the
    model code (``load_pipeline``); returns the program.

    The pipelines run under ``torch.inference_mode``, which export does not
    trace: the undecorated function is exported (``__wrapped__``), and the
    loaded program runs under inference mode. ``batch_symbolic=True``
    exports the batch dim as the symbol ``b``, so one program serves any
    batch size."""
    fn = getattr(pipeline, "__wrapped__", pipeline)
    frames = torch.as_tensor(example_frames)
    dynamic = ({"frames": {0: torch.export.Dim("b")}} if batch_symbolic
               else None)
    with torch.no_grad():
        program = torch.export.export(_Exported(fn, params), (frames,),
                                      dynamic_shapes=dynamic)
    torch.export.save(program, path)
    return program


def load_pipeline(path: str) -> Callable:
    """Load an ``export_pipeline`` program; returns call(frames) ->
    predictions (the forecaster's weights are inside the program)."""
    # register the custom ops a program may call: wftk::group_norm_silu,
    # wftk::int8_quantize, wftk::int8_conv2d and wftk::advection_stencil
    from ..ops import stencil  # noqa: F401
    from ..ops.cuda import groupnorm, int8_conv  # noqa: F401

    module = torch.export.load(path).module()

    @torch.inference_mode()
    def call(frames):
        return module(torch.as_tensor(frames))

    return call
