"""Config-driven training harness: one train step, epochs, eval, resume
(counterpart of weatherforecastingtoolkit_tpu/training/trainer.py).

A Task owns the model and the loss; the Trainer runs its train step
(forward, backward, clip, update, grad norm, EMA) eagerly on one device,
with the JAX Trainer's cadences: derived total steps, fraction-based
checkpoint/val/histogram cadences, limit_*_batches, overfit_batches,
auto-resume from the newest loadable checkpoint, the SIGTERM preemption
checkpoint, save-last plus drain, and the crash-retry loop.

How the port's objects stand for the JAX ones:
  * params are an ``nn.Module``; ``Task.init_params(seed, device)`` builds
    it and ``Task.loss_fn(model, batch, rng, step)`` returns (loss, aux);
  * ``TrainState.rng`` is a ``torch.Generator`` on the trainer's device;
  * the optimizer (``training/optim.py``) updates params and its state in
    place, so there is nothing to donate;
  * aux scalars stay on the device and are read at the logging cadence
    only, so the step itself makes no host sync.

``validate`` averages the loss and, for a task with an ``eval_fn``,
``metrics.calc_metrics`` over the validation batches, as JAX's does.

Data parallelism: with ``mesh`` (``parallel/mesh.py::make_mesh``) every
process is one 'dp' rank, its loader yields its own rows of the global
batch, and the state is replicated (broadcast from rank 0). The step runs
under ``data_parallel(mesh)``: the gradients are averaged over 'dp' in a
few flattened buckets before the clip, the update and the EMA (a custom
step such as the GAN's reduces its own), the noise is drawn for the global
batch, and the aux scalars are averaged, so N ranks take the one-process
step on the concatenated batch. Every rank runs the same number of steps
(the fewest batches any rank has). ``trainer.fsdp`` (with a mesh) creates
the state sharded (``parallel/fsdp.py``) and resumes straight into the
shards. Rank 0 logs and writes the replicated checkpoints.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.fsdp import shard_train_state
from ..parallel.mesh import (agree_min, all_reduce_mean_, data_parallel,
                             dp_rank, dp_sharding, local, reduce_gradients,
                             replicate)
from ..utils.config import Config
from ..utils.device import DeviceLike, resolve_device
from .checkpoint import (CheckpointManager, find_latest_ckpt, new_run_id,
                         run_dir_for)
from .logging import RunLogger
from .optim import (adamw, cosine_warmup_schedule, global_norm,
                    one_cycle_schedule)


@dataclasses.dataclass
class TrainState:
    step: int
    params: torch.nn.Module
    opt_state: Dict[str, Any]
    rng: torch.Generator
    extra: Any = None  # task-specific (e.g. {"ema_params": {name: tensor}})

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Task:
    """A trainable objective.

    init_params(seed, device) -> nn.Module (the trainable parameters)
    loss_fn(model, batch, rng, step) -> (loss, aux_scalars)
    eval_fn(model, batch, rng) -> (pred, target) in pixel space
    (B, T, C, H, W) [0, 1], for metrics; may be None for loss-only
    validation.
    """

    name: str
    init_params: Callable[[int, torch.device], torch.nn.Module]
    loss_fn: Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]
    eval_fn: Optional[Callable[..., Tuple[torch.Tensor, torch.Tensor]]] = None
    # optional fully-custom step: (state, batch, tx) -> (state, aux)
    custom_train_step: Optional[Callable] = None
    # optional extra-state builder: (seed, params) -> state kept in
    # TrainState.extra, built at init so resume templates include it
    init_extra: Optional[Callable] = None


def build_optimizer(cfg: Config, total_steps: int):
    """Returns (optimizer, schedule fn or constant LR)."""
    sched_name = cfg.optim.get("schedule", "cosine_warmup")
    if sched_name == "cosine_warmup":
        p = cfg.cosine_warmup
        warmup = int(p.warmup_ratio * total_steps) if "warmup_ratio" in p \
            else int(p.warmup_steps)
        sched = cosine_warmup_schedule(p.start_lr, p.peak_lr, p.final_lr,
                                       total_steps, warmup)
    elif sched_name == "one_cycle":
        p = cfg.one_cycle
        ramp = int(p.get("rampup_ratio", 0.3) * total_steps)
        sched = one_cycle_schedule(p.start_lr, p.peak_lr, p.final_lr,
                                   total_steps, ramp)
    elif sched_name == "constant":
        sched = cfg.optim.lr
    else:
        raise ValueError(f"Unknown schedule {sched_name}")
    return adamw(sched, weight_decay=cfg.optim.get("weight_decay", 0.01),
                 beta1=cfg.optim.get("beta1", 0.9),
                 beta2=cfg.optim.get("beta2", 0.999),
                 grad_clip=cfg.optim.get("grad_clip", None),
                 accumulate_steps=int(cfg.trainer.get("accumulate_grad_batches", 1))), sched


def derive_steps(cfg: Config, n_train_batches: int, n_val_batches: int,
                 n_test_batches: int = 0) -> Config:
    """Total-step derivation incl. limit_*_batches scaling
    (reference experiments/ae_s2/train.py:270-282)."""
    accum = int(cfg.trainer.get("accumulate_grad_batches", 1))
    epochs = int(cfg.trainer.max_epochs)
    cfg = cfg.merge({})  # deep copy
    t = cfg.trainer
    overfit = int(t.get("overfit_batches", 0) or 0)
    if overfit > 0:  # epoch length becomes the overfit batch count
        n_train_batches = min(n_train_batches, overfit)
    t.total_train_steps = int(n_train_batches * epochs / accum)
    t.total_val_steps = int(n_val_batches * epochs / accum)
    t.total_test_steps = int(n_test_batches * epochs / accum)
    for key, tot in (("limit_train_batches", "total_train_steps"),
                     ("limit_val_batches", "total_val_steps"),
                     ("limit_test_batches", "total_test_steps")):
        frac = t.get(key, None)
        if frac is not None:
            t[tot] = int(t[tot] * float(frac))
    return cfg


def _ema_of(params: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of each parameter; an FSDP shard's copy is tagged as the same
    shard (``parallel/fsdp.py``), so the EMA is saved and restored sharded
    as the params are."""
    def copy(p):
        t = p.detach().clone()
        if hasattr(p, "_fsdp"):
            t._fsdp = p._fsdp
        return t
    return {k: copy(p) for k, p in params.named_parameters()}


class _NoLogger:
    """The logger of a rank other than 0: every call does nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


class Trainer:
    def __init__(self, cfg: Config, task: Task, mesh: Any = None,
                 run_id: Optional[str] = None, resume: bool = False, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        # trainer.fsdp shards the state over 'dp'; without a mesh it is
        # ignored, as in JAX
        self.fsdp = mesh is not None and bool(cfg.trainer.get("fsdp", False))
        self.rank0 = mesh is None or dist.get_rank() == 0
        # trainer.ema_decay=d keeps an exponential moving average of the
        # params in TrainState.extra (ema = d*ema + (1-d)*params), updated in
        # the train step, checkpointed and resumed with everything else. It
        # ticks once per OPTIMIZER UPDATE: under accumulate_grad_batches=k it
        # is gated on the same boundary as the update.
        self.ema_decay = cfg.trainer.get("ema_decay", None)
        if self.ema_decay is not None:
            if task.custom_train_step is not None or task.init_extra is not None:
                raise ValueError(
                    "trainer.ema_decay needs the default train step (the "
                    "task already owns custom_train_step/extra state)")
            task = dataclasses.replace(
                task, init_extra=lambda seed, params: {
                    "ema_params": _ema_of(params)})
        self.task = task
        self.total_steps = int(cfg.trainer.total_train_steps)
        # trainer.donate is accepted and changes nothing: the optimizer
        # updates params and its state in place, so there is no second copy
        # of the state to donate
        self.tx, self.schedule = build_optimizer(cfg, self.total_steps)
        self._resume_state = None
        self.preempted = False  # set by fit()'s SIGTERM handler

        exp_path = cfg.get("experiment_path", ".")
        exp_name = cfg.get("experiment_name", task.name)
        if resume:
            template = self._init_state(int(cfg.get("seed", 0)))
            # ema_decay toggled mid-run must neither lose the run nor fall
            # back to an OLDER checkpoint that happens to match the template
            # when the newest one is convertible
            alternates = []
            if self.ema_decay is not None:
                # older checkpoints may predate ema_decay: restore without
                # it, seed the shadow from the restored params
                def _seed_ema(restored):
                    print("[trainer] checkpoint predates ema_decay: seeding "
                          "ema_params from restored params")
                    return restored.replace(
                        extra={"ema_params": _ema_of(restored.params)})
                alternates.append((template.replace(extra=None), _seed_ema))
            elif self.task.init_extra is None:
                # newer checkpoints may carry an ema_params tree the template
                # lacks (ema_decay turned off): restore with it, drop it
                def _drop_ema(restored):
                    print("[trainer] checkpoint carries ema_params but "
                          "ema_decay is off: dropping the shadow tree")
                    return restored.replace(extra=None)
                alternates.append((template.replace(
                    extra={"ema_params": _ema_of(template.params)}), _drop_ema))
            restored, found_id, step = find_latest_ckpt(
                exp_path, exp_name, template, alternates=tuple(alternates),
                mesh=mesh)
            if restored is not None:
                print(f"[trainer] resuming run {found_id} at step {step}")
                self._resume_state = restored
                run_id = found_id
            else:
                print("[trainer] no checkpoint found, starting from scratch")
        self.run_id = run_id or new_run_id()
        if mesh is not None:   # one run directory: rank 0's
            ids = [self.run_id]
            dist.broadcast_object_list(ids, src=0)
            self.run_id = ids[0]
        self.run_dir = run_dir_for(exp_path, exp_name, self.run_id)
        self.logger = (RunLogger(self.run_dir, project=cfg.get("project_name"),
                                 name=exp_name, resume_id=self.run_id)
                       if self.rank0 else _NoLogger())
        # async by default: save() blocks only for the device->host copy;
        # the disk write overlaps the next training steps (under a mesh
        # saves end at a barrier)
        self.ckpt = CheckpointManager(
            self.run_dir,
            async_save=bool(cfg.trainer.get("async_checkpoint", True)),
            mesh=mesh)
        if self.rank0:
            Config(cfg).save(f"{self.run_dir}/config.yaml")

    @staticmethod
    def ema_params(state: TrainState) -> Dict[str, torch.Tensor]:
        """The EMA shadow weights when trainer.ema_decay is set, else the raw
        params, as {name: tensor}: the weights to serve/eval with."""
        if isinstance(state.extra, dict) and "ema_params" in state.extra:
            return state.extra["ema_params"]
        return dict(state.params.named_parameters())

    # -- state ----------------------------------------------------------------
    def _init_state(self, seed: int) -> TrainState:
        """The fresh state; under ``trainer.fsdp`` built on the host and
        sharded leaf by leaf onto the device (``shard_train_state``)."""
        p_seed, e_seed, s_seed = (int(s) for s in
                                  np.random.SeedSequence(seed).generate_state(3))
        build = torch.device("cpu") if self.fsdp else self.device
        params = self.task.init_params(p_seed, build)
        extra = (self.task.init_extra(e_seed, params)
                 if self.task.init_extra is not None else None)
        rng = torch.Generator(device=self.device).manual_seed(s_seed)
        state = TrainState(step=0, params=params,
                           opt_state=self.tx.init(list(params.parameters())),
                           rng=rng, extra=extra)
        if self.fsdp:
            state = shard_train_state(state, self.mesh, device=self.device)
        return state

    def init_state(self) -> TrainState:
        state = (self._resume_state if self._resume_state is not None
                 else self._init_state(int(self.cfg.get("seed", 0))))
        if self.mesh is not None and not self.fsdp:
            # every rank starts from rank 0's parameters (fresh or resumed)
            for module in [state.params] + [
                    v for v in (state.extra or {}).values()
                    if isinstance(v, torch.nn.Module)]:
                replicate(module, self.mesh)
        return state

    def batch_sharding(self):
        """The placements of a batch over the mesh (dim 0 over 'dp'), None
        without one; each rank's loader yields its own rows."""
        return None if self.mesh is None else dp_sharding(self.mesh)

    # -- steps ------------------------------------------------------------------
    def _train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with data_parallel(self.mesh):
            if self.task.custom_train_step is not None:
                state, aux = self.task.custom_train_step(state, batch, self.tx)
            else:
                state, aux = self._default_step(state, batch)
            # the global batch's scalars (the replicated ones stay as they are)
            all_reduce_mean_([v for v in aux.values()
                              if isinstance(v, torch.Tensor)])
        return state, aux

    def _default_step(self, state: TrainState, batch
                      ) -> Tuple[TrainState, Dict]:
        params = list(state.params.parameters())
        for p in params:
            p.grad = None
        loss, aux = self.task.loss_fn(state.params, batch, state.rng,
                                      state.step)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        aux["loss"] = loss.detach()
        reduce_gradients(grads, params)
        aux["grad_norm"] = global_norm(grads, params)  # the unclipped grads
        applied = self.tx.update(params, grads, state.opt_state)
        if self.ema_decay is not None and applied:
            d = float(self.ema_decay)
            ema = [local(t) for t in state.extra["ema_params"].values()]
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [local(p).detach() for p in params],
                                    alpha=1.0 - d)
        state.step += 1
        return state, aux

    # -- loops ------------------------------------------------------------------
    def fit(self, train_loader, val_loader=None,
            state: Optional[TrainState] = None) -> TrainState:
        from ..data.prefetch import device_prefetch, to_device

        cfg = self.cfg
        state = state if state is not None else self.init_state()
        start_step = int(state.step)
        # state.step counts MICRO-steps (one per batch); total_train_steps
        # counts OPTIMIZER UPDATES (derive_steps already divided by accum), so
        # every cadence and the stop condition are scaled by `accum`.
        accum = max(1, int(cfg.trainer.get("accumulate_grad_batches", 1)))
        log_every = accum * max(1, int(cfg.logging.get("log_every_n_steps", 50)))
        save_every = accum * max(1, int(self.total_steps *
                                 float(cfg.trainer.get("save_every_n_steps", 0.1))))
        val_every = accum * max(1, int(self.total_steps *
                                float(cfg.logging.get("val_every_n", 0.25))))
        limit = cfg.trainer.get("limit_train_batches", None)
        epochs = int(cfg.trainer.max_epochs)
        # overfit_batches=N: repeat the SAME first N batches every epoch
        # (read straight off the loader, then kept on the device)
        overfit = int(cfg.trainer.get("overfit_batches", 0) or 0)
        overfit_cache = None
        if overfit > 0:
            overfit_cache = [to_device(b, self.device) for b in
                             itertools.islice(iter(train_loader), overfit)]
        hist_frac = cfg.logging.get("param_histograms_every_n", None)
        hist_every = (accum * max(1, int(self.total_steps * float(hist_frac)))
                      if hist_frac else None)

        # Preemption: catch SIGTERM, finish the in-flight step, write a final
        # checkpoint and return; --resume continues from that step.
        # (Handlers only install in the main thread; elsewhere a no-op.)
        self.preempted = False
        prev_handler = None
        handler_installed = False
        if bool(cfg.trainer.get("checkpoint_on_preempt", True)):
            import signal as _signal

            def _on_term(signum, frame):
                self.preempted = True

            try:
                prev_handler = _signal.signal(_signal.SIGTERM, _on_term)
                handler_installed = True
            except ValueError:  # not the main thread
                pass

        step = start_step
        t_last = time.time()
        done = False
        last_saved = None  # step of the most recent periodic save
        try:
            for epoch in range(epochs):
                if done:
                    break
                if overfit_cache is not None:
                    batches = overfit_cache
                    n_batches = len(overfit_cache)
                else:
                    if hasattr(train_loader, "set_epoch"):
                        train_loader.set_epoch(epoch)
                    n_batches = len(train_loader)
                    if limit is not None:
                        n_batches = (int(n_batches * float(limit)) if limit <= 1
                                     else int(limit))
                    batches = device_prefetch(train_loader, device=self.device)
                agreed = agree_min(n_batches, self.mesh)
                if agreed < n_batches:
                    print(f"[trainer] rank {dp_rank(self.mesh)}: dropping "
                          f"{n_batches - agreed} batches of epoch {epoch}: "
                          f"every rank runs {agreed}")
                    n_batches = agreed
                for i, batch in enumerate(batches):
                    if i >= n_batches:
                        break
                    state, aux = self._train_step(state, batch)
                    step = int(state.step)
                    updates = step // accum  # optimizer updates so far
                    if hist_every is not None and step % hist_every == 0:
                        self._log_param_histograms(state, batch, step)
                    if step % log_every == 0:
                        aux = {k: float(v) for k, v in aux.items()}
                        # the schedule advances once per optimizer update
                        aux["lr"] = float(self.schedule(updates)) \
                            if callable(self.schedule) else float(self.schedule)
                        aux["steps_per_sec"] = log_every / max(1e-9, time.time() - t_last)
                        t_last = time.time()
                        self.logger.log_scalars(aux, step, prefix="train")
                    if step % save_every == 0:
                        self.ckpt.save(step, state)
                        last_saved = step
                    if val_loader is not None and step % val_every == 0:
                        self.validate(state, val_loader, step, log_images=True)
                    if self.preempted:
                        print(f"[trainer] SIGTERM at step {step}: writing "
                              "preemption checkpoint and stopping")
                        done = True
                        break
                    if updates >= self.total_steps:
                        done = True
                        break
            # save_last, unless the periodic save just wrote this step; then
            # DRAIN, so the final checkpoint is on disk when fit() returns
            if last_saved != max(step, 1):
                self.ckpt.save(max(step, 1), state, force=True)
            self.ckpt.wait_until_finished()
        finally:
            if handler_installed:
                import signal as _signal
                _signal.signal(_signal.SIGTERM,
                               prev_handler if prev_handler is not None
                               else _signal.SIG_DFL)
        return state

    def _log_param_histograms(self, state: TrainState, batch, step: int
                              ) -> None:
        """Per-parameter weight + gradient histograms (opt-in via
        logging.param_histograms_every_n; wandb.watch analog). Gradients are
        recomputed by a separate forward/backward at this cadence only; for
        custom-step tasks only weights are probed."""
        named = {f"weight/{k}": p.detach().cpu().numpy()
                 for k, p in state.params.named_parameters()}
        if self.task.custom_train_step is None:
            try:
                names, params = zip(*state.params.named_parameters())
                loss, _ = self.task.loss_fn(state.params, batch, state.rng,
                                            state.step)
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                for k, g in zip(names, grads):
                    if g is not None:
                        named[f"grad/{k}"] = g.cpu().numpy()
            except Exception as e:  # noqa: BLE001 — diagnostics must not kill
                print(f"[trainer] grad histogram probe failed: "
                      f"{type(e).__name__}: {e}")
        self.logger.log_histograms(named, step)

    def validate(self, state: TrainState, val_loader, step: int,
                 tag: str = "val", max_batches: Optional[int] = None,
                 log_images: bool = False) -> Dict[str, float]:
        """Mean loss over the validation batches and, for a task with an
        ``eval_fn``, the mean of ``calc_metrics`` over them; with
        ``log_images`` the first batch's panels as PNGs."""
        from ..data.prefetch import device_prefetch
        from ..metrics import calc_metrics

        losses = []
        metric_sums: Dict[str, float] = {}
        n_metric = 0
        limit = max_batches or self.cfg.trainer.get("limit_val_batches", None)
        if limit is not None:
            # fractions (<1.0) scale the loader length; ints are batch counts
            limit = int(limit) if limit >= 1 else max(1, int(limit * len(val_loader)))
        if self.mesh is not None:   # every rank the same number of batches
            limit = agree_min(min(limit or len(val_loader), len(val_loader)),
                              self.mesh)
        for i, batch in enumerate(device_prefetch(val_loader,
                                                  device=self.device)):
            if limit is not None and i >= limit:
                break
            with torch.no_grad():
                loss, _aux = self.task.loss_fn(state.params, batch, state.rng, 0)
            losses.append(float(loss))
            if self.task.eval_fn is not None:
                with torch.no_grad():
                    pred, target = self.task.eval_fn(state.params, batch,
                                                     state.rng)
                for k, v in calc_metrics(pred, target).items():
                    metric_sums[k] = metric_sums.get(k, 0.0) + v
                n_metric += 1
                if log_images and i == 0:
                    self.logger.log_images(pred.float().cpu().numpy(),
                                           target.float().cpu().numpy(),
                                           f"{tag}_panels", step)
        out = {"loss": float(np.mean(losses)) if losses else float("nan")}
        if n_metric:
            out.update({k: v / n_metric for k, v in metric_sums.items()})
        if self.mesh is not None:   # the mean over the ranks
            vals = torch.tensor(list(out.values()), dtype=torch.float64,
                                device=self.device)
            all_reduce_mean_([vals], self.mesh)
            out = dict(zip(out, vals.tolist()))
        self.logger.log_scalars(out, step, prefix=tag)
        return out

    def test(self, state: TrainState, test_loader, step: Optional[int] = None
             ) -> Dict[str, float]:
        return self.validate(state, test_loader, step or int(state.step),
                             tag="test", log_images=True)

    def close(self):
        self.logger.close()
        self.ckpt.close()


def run_with_retry(main_fn: Callable[[], None], max_retries: int = 100,
                   backoff_s: float = 5.0) -> None:
    """Bash-free supervision: rerun `main_fn` until it completes
    (reference experiments/ae_v2/run.sh:17-45 rerun-until-'done' loop)."""
    for attempt in range(max_retries):
        try:
            main_fn()
            print("done")
            return
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — supervision must survive anything
            print(f"[supervisor] attempt {attempt} crashed: {type(e).__name__}: {e}; "
                  f"retrying in {backoff_s}s with resume")
            time.sleep(backoff_s)
    raise RuntimeError("run_with_retry exhausted retries")
