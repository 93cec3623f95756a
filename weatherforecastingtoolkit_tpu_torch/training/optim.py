"""Optimizer, LR schedules and the LR range test (counterpart of
weatherforecastingtoolkit_tpu/training/optim.py, which builds them from
optax).

The port computes what optax computes, step for step:
  * schedules are plain functions of the optimizer-update count, with the
    values of ``optax.warmup_cosine_decay_schedule`` and
    ``optax.cosine_onecycle_schedule``;
  * ``adam`` is ``optax.adam``; ``adamw`` is
    ``optax.chain(clip_by_global_norm(c), adamw(...))`` wrapped
    in ``optax.MultiSteps(k)`` when k > 1. The schedule is read at the update
    count before it is incremented (the first update uses ``schedule(0)``);
    clipping scales by ``max_norm / norm`` only when norm >= max_norm, with
    no epsilon (``clip_grad_norm_`` adds 1e-6); weight decay reaches every
    parameter (optax's mask is None); MultiSteps averages k micro-gradients
    and updates on the k-th.
Updates run in place with ``torch._foreach_*`` ops (a few launches for all
parameters). The update count lives on the host, so reading the schedule
costs no device sync; the clip factor stays on the device.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..parallel.mesh import DTensor, dp_group, is_sharded, local

Schedule = Callable[[int], float]


def cosine_warmup_schedule(start_lr: float, peak_lr: float, final_lr: float,
                           total_steps: int, warmup_steps: int) -> Schedule:
    """Linear start_lr -> peak_lr over warmup_steps, then one cosine
    half-cycle peak_lr -> final_lr ending at total_steps."""
    warmup = max(1, int(warmup_steps))
    decay = max(int(total_steps), warmup + 1) - warmup
    alpha = 0.0 if peak_lr == 0.0 else final_lr / peak_lr

    def schedule(count: int) -> float:
        if count < warmup:
            frac = 1.0 - max(count, 0) / warmup
            return (start_lr - peak_lr) * frac + peak_lr
        c = min(count - warmup, decay)
        cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return peak_lr * ((1.0 - alpha) * cos + alpha)

    return schedule


def one_cycle_schedule(start_lr: float, peak_lr: float, final_lr: float,
                       total_steps: int, rampup_steps: int) -> Schedule:
    """Cosine start_lr -> peak_lr over the ramp, cosine peak_lr -> final_lr
    to total_steps, final_lr after."""
    total = max(1, int(total_steps))
    pct_start = max(1, int(rampup_steps)) / total
    if pct_start < 0.2:
        print(f"[optim] warning: rampup {pct_start:.0%} of total steps; "
              "the reference recommends >= 20%")
    bounds = [0, int(pct_start * total), total]
    values = [start_lr, peak_lr, final_lr]

    def schedule(count: int) -> float:
        if count >= bounds[-1]:
            return values[-1]
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                a, b = values[i], values[i + 1]
                return b + (a - b) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return 0.0

    return schedule


def global_norm(tensors: Sequence[torch.Tensor],
                params: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """L2 norm over a list of tensors, on their device (no host sync).

    Given the ``params`` the tensors are gradients of, the norm is global
    over the shards: a gradient of an FSDP-sharded parameter
    (``parallel/fsdp.py``) has its square summed over 'dp', one of a
    tensor-parallel parameter (a DTensor) over the mesh axes it is split
    on, and a replicated one counts once. Each leaf's norm is the square
    root of its summed square, and the result the norm of the leaves'
    norms, as unsharded: one rank gives the unsharded bits."""
    tensors = list(tensors)
    norms = [n.float() for n in torch._foreach_norm(
        [local(t) for t in tensors])]
    groups = {}   # the process groups a square sums over -> its indices
    for i, p in enumerate(tensors if params is None else params):
        if is_sharded(p):
            groups.setdefault((dp_group(p._fsdp.mesh),), []).append(i)
        elif isinstance(p, DTensor):
            key = tuple(p.device_mesh.get_group(d) for d, pl in
                        enumerate(p.placements) if pl.is_shard())
            groups.setdefault(key, []).append(i)
    for key, idx in groups.items():
        if not key:
            continue
        squares = torch.stack([norms[i] for i in idx]) ** 2
        for group in key:
            torch.distributed.all_reduce(squares, group=group)
        for i, sq in zip(idx, torch.sqrt(squares)):
            norms[i] = sq
    return torch.linalg.vector_norm(torch.stack(norms))


def count_params(params: Union[torch.nn.Module, Sequence[torch.Tensor]]) -> int:
    if isinstance(params, torch.nn.Module):
        params = list(params.parameters())
    return int(sum(p.numel() for p in params))


class AdamW:
    """Clip + AdamW + accumulation over a fixed list of parameters.

    ``init(params)`` gives the state (a dict, checkpointed with the rest of
    the training state); ``update(params, grads, state)`` updates params and
    state in place and returns True when an optimizer update was applied
    (False on the first k-1 micro-steps of an accumulation window)."""

    def __init__(self, learning_rate: Union[float, Schedule],
                 weight_decay: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, grad_clip: Optional[float] = None,
                 accumulate_steps: int = 1, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.weight_decay, self.beta1, self.beta2 = weight_decay, beta1, beta2
        self.grad_clip, self.eps = grad_clip, eps
        self.accumulate_steps = max(1, int(accumulate_steps))

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        params = [local(p) for p in params]
        state = {"count": 0, "mini_step": 0,
                 "mu": [torch.zeros_like(p) for p in params],
                 "nu": [torch.zeros_like(p) for p in params]}
        if self.accumulate_steps > 1:
            state["acc"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict) -> bool:
        k = self.accumulate_steps
        held = params   # as given: the norm needs their shardings
        params, grads = [local(p) for p in params], [local(g) for g in grads]
        if k > 1:
            # Welford mean of the micro-gradients, as MultiSteps
            acc, n = state["acc"], state["mini_step"]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), float(n + 1)))
            state["mini_step"] = (n + 1) % k
            if n + 1 < k:
                return False
            grads = acc
        if self.grad_clip is not None:
            norm = global_norm(grads, held)
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = torch._foreach_mul(grads, scale)
        lr = self.learning_rate
        lr = float(lr(state["count"]) if callable(lr) else lr)
        b1, b2 = self.beta1, self.beta2
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        state["count"] += 1
        t = state["count"]
        mu_hat = torch._foreach_div(mu, 1.0 - b1 ** t)
        denom = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - b2 ** t))
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(step, params, alpha=self.weight_decay)
        torch._foreach_add_(params, step, alpha=-lr)
        if k > 1:
            torch._foreach_zero_(state["acc"])
        return True


def adamw(learning_rate: Union[float, Schedule], weight_decay: float = 0.01,
          beta1: float = 0.9, beta2: float = 0.999,
          grad_clip: Optional[float] = None,
          accumulate_steps: int = 1) -> AdamW:
    """AdamW with optional global-norm clipping and gradient accumulation."""
    return AdamW(learning_rate, weight_decay, beta1, beta2, grad_clip,
                 accumulate_steps)


def adam(learning_rate: Union[float, Schedule], b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8) -> AdamW:
    """``optax.adam``: Adam with no weight decay and no clipping."""
    return AdamW(learning_rate, weight_decay=0.0, beta1=b1, beta2=b2, eps=eps)


def lr_range_test(loss_at_lr: Callable[[float], float], start_lr: float = 1e-7,
                  end_lr: float = 1.0, num_iter: int = 100,
                  output_dir: Optional[str] = None):
    """Exponential LR sweep. ``loss_at_lr(lr)`` performs one optimization
    step at that LR and returns the (smoothed) loss. Returns (lrs, losses)
    and writes lr_range_test.png when output_dir is given and matplotlib
    imports. Rule of thumb from the reference: pick ~1/10 of the explosion
    point."""
    lrs = np.exp(np.linspace(np.log(start_lr), np.log(end_lr), num_iter))
    losses = []
    best = None
    for lr in lrs:
        loss = float(loss_at_lr(float(lr)))
        losses.append(loss)
        best = loss if best is None else min(best, loss)
        if not np.isfinite(loss) or loss > 4 * best:
            break  # diverged
    lrs = lrs[: len(losses)]
    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)
        try:
            import matplotlib
        except ImportError:
            print("[optim] matplotlib is absent: lr_range_test.png not written")
            return np.asarray(lrs), np.asarray(losses)
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        ax.plot(lrs, losses)
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("loss")
        fig.savefig(os.path.join(output_dir, "lr_range_test.png"))
        plt.close(fig)
    return np.asarray(lrs), np.asarray(losses)
