"""Checkpoint save/restore with corruption-tolerant latest-checkpoint discovery
(counterpart of weatherforecastingtoolkit_tpu/training/checkpoint.py, which
stores with orbax).

  * periodic + save_last checkpoints into the run dir, the newest
    ``max_to_keep`` kept;
  * ``find_latest_ckpt``: scan every run's checkpoints newest first, try to
    restore each, skip corrupt ones, and try ``alternates`` templates before
    moving on (so toggling EMA mid-run keeps the newest step);
  * external torch checkpoint reading with key-prefix surgery.

Storage is ``torch.save`` of a host snapshot of the state: dataclasses and
dicts become dicts, an ``nn.Module`` its state dict, a ``torch.Generator``
its state, a tensor a CPU copy. Each step is the directory
``checkpoints/<step>/`` holding ``state.pt``, written under a temporary name
and renamed into place, so a reader never sees half a step. Restoring holds
the snapshot to a template of the same structure (keys, shapes, dtypes) and
loads it into the template's modules and generators in place.

Under a mesh (``Trainer(mesh=...)``) a replicated state is written by rank 0
alone as above while the other ranks wait at a barrier, and read by every
rank. A state holding FSDP shards (``parallel/fsdp.py``) is written by every
rank, each its own shards, through ``torch.distributed.checkpoint`` into the
same ``checkpoints/<step>/`` (``.metadata`` plus the ranks' files), and
read back straight into a sharded template's shards: the full state never
materialises.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
import time
from collections.abc import Mapping
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import is_sharded

_FILE = "state.pt"
_DCP_META = ".metadata"   # torch.distributed.checkpoint's index file


def run_dir_for(experiment_path: str, experiment_name: str, run_id: str) -> str:
    return os.path.join(experiment_path, "outputs", experiment_name, "runs",
                        f"run-{run_id}")


def new_run_id() -> str:
    return f"{int(time.time())}-{os.getpid()}"


def snapshot(obj: Any) -> Any:
    """A host copy of a training state, made of dicts, lists, CPU tensors
    and Python scalars (what ``torch.load(weights_only=True)`` reads)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, torch.nn.Module):
        return {k: snapshot(v) for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if dataclasses.is_dataclass(obj):
        return {f.name: snapshot(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, Mapping):
        return {k: snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [snapshot(v) for v in obj]
    return obj


def _check(template: Any, saved: Any, path: str = "") -> None:
    """Raise ValueError where ``saved`` does not have ``template``'s
    structure, shapes or dtypes."""
    where = path or "<root>"
    if isinstance(template, torch.Generator):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: expected a generator state")
        return
    if isinstance(template, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            raise ValueError(f"{where}: expected a tensor, got {type(saved).__name__}")
        if saved.shape != template.shape or saved.dtype != template.dtype:
            raise ValueError(f"{where}: saved {tuple(saved.shape)} {saved.dtype}, "
                             f"template {tuple(template.shape)} {template.dtype}")
        return
    if isinstance(template, torch.nn.Module):
        template = template.state_dict()
    elif dataclasses.is_dataclass(template):
        template = {f.name: getattr(template, f.name)
                    for f in dataclasses.fields(template)}
    if isinstance(template, Mapping):
        if not isinstance(saved, Mapping) or set(saved) != set(template):
            got = sorted(saved) if isinstance(saved, Mapping) else type(saved).__name__
            raise ValueError(f"{where}: saved keys {got} != template keys "
                             f"{sorted(template)}")
        for k in template:
            _check(template[k], saved[k], f"{path}/{k}")
        return
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"{where}: saved sequence does not match the template")
        for i, (t, s) in enumerate(zip(template, saved)):
            _check(t, s, f"{path}/{i}")
        return
    if (template is None) != (saved is None):
        raise ValueError(f"{where}: saved {saved!r} where the template has {template!r}")


def _restore(template: Any, saved: Any) -> Any:
    """``saved`` loaded into (a copy of) ``template``; modules and generators
    are loaded in place. Call ``_check`` first."""
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if isinstance(template, torch.Tensor):
        return saved.to(template.device)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(saved, strict=True)
        return template
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _restore(getattr(template, f.name), saved[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        return {k: _restore(template[k], saved[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(t, s) for t, s in zip(template, saved))
    return saved


class CheckpointManager:
    """Checkpoints of one run: save(step, state), restore(template, step).

    ``save`` copies the state to the host before it returns. With
    ``async_save=True`` a background thread then writes it, overlapping the
    next training steps; each save first drains the previous write, so at
    most one is in flight and saves land in order. restore()/close() drain
    too; ``wait_until_finished`` re-raises a failed write."""

    def __init__(self, run_dir: str, max_to_keep: int = 5,
                 async_save: bool = False, mesh: Any = None):
        self.ckpt_dir = os.path.abspath(os.path.join(run_dir, "checkpoints"))
        self.max_to_keep = max_to_keep
        self.mesh = mesh
        # under a mesh every save ends at a barrier, so it is synchronous
        self.async_save = async_save and mesh is None
        self.rank0 = mesh is None or dist.get_rank() == 0
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, str(step))

    def all_steps(self):
        return sorted(int(d) for d in os.listdir(self.ckpt_dir)
                      if d.isdigit() and os.path.isdir(self._step_dir(int(d))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, force: bool = False) -> None:
        self.wait_until_finished()
        if step in self.all_steps():
            if not force:
                return  # periodic save already wrote this step
            self._barrier()   # every rank has seen the step before it goes
            if self.rank0:
                shutil.rmtree(self._step_dir(step))  # save_last: overwrite
        if self.mesh is not None:
            if _has_shards(state):
                self._save_sharded(step, state)
            elif self.rank0:
                self._write(step, snapshot(state))
            self._barrier()
            return
        snap = snapshot(state)
        if self.async_save:
            self._thread = threading.Thread(target=self._write_guarded,
                                            args=(step, snap), daemon=True)
            self._thread.start()
        else:
            self._write(step, snap)

    def _write_guarded(self, step: int, snap: Any) -> None:
        try:
            self._write(step, snap)
        except BaseException as e:  # noqa: BLE001 — re-raised on wait
            self._error = e

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def _save_sharded(self, step: int, state: Any) -> None:
        """Every rank writes its shards (and rank 0 the replicated leaves)
        into one temporary directory, renamed into place by rank 0."""
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.ckpt_dir, f".{step}.tmp")
        if self.rank0:
            shutil.rmtree(tmp, ignore_errors=True)
        self._barrier()
        dcp.save(_dcp_entries(state), checkpoint_id=tmp)
        self._barrier()
        if self.rank0:
            os.replace(tmp, self._step_dir(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def _write(self, step: int, snap: Any) -> None:
        tmp = os.path.join(self.ckpt_dir, f".{step}.tmp-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
        torch.save(snap, os.path.join(tmp, _FILE))
        os.replace(tmp, self._step_dir(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(old), ignore_errors=True)

    def load(self, step: int) -> Any:
        """The raw snapshot of ``step`` (raises on a corrupt file)."""
        return torch.load(os.path.join(self._step_dir(step), _FILE),
                          map_location="cpu", weights_only=True)

    def restore(self, target: Any, step: Optional[int] = None) -> Any:
        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.ckpt_dir}")
        if _has_shards(target):
            return restore_sharded(self._step_dir(step), target)
        saved = self.load(step)
        _check(target, saved)
        return _restore(target, saved)

    def is_saving_in_progress(self) -> bool:
        """True while an async write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait_until_finished()


def restore_params(run_dir: str, module: torch.nn.Module) -> int:
    """Load the params of a run directory's newest checkpoint into
    ``module`` in place, as a frozen stage-1 model is loaded; returns the
    step. Raises FileNotFoundError for a missing run or one without
    checkpoints, and ValueError where the saved params' names, shapes or
    dtypes differ from the module's: it never leaves the module's own
    weights in place of a run's."""
    if not os.path.isdir(os.path.join(run_dir, "checkpoints")):
        raise FileNotFoundError(f"no run directory with checkpoints at "
                                f"{run_dir}")
    mgr = CheckpointManager(run_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"No checkpoints in {mgr.ckpt_dir}")
    saved = mgr.load(step)
    if not isinstance(saved, Mapping) or "params" not in saved:
        raise ValueError(f"{mgr._step_dir(step)} holds no training state")
    _check(module, saved["params"], "params")
    _restore(module, saved["params"])
    return step


def find_latest_ckpt(experiment_path: str, experiment_name: str, target: Any,
                     alternates: Tuple = (), mesh: Any = None,
                     ) -> Tuple[Optional[Any], Optional[str], Optional[int]]:
    """Scan every run's checkpoints newest-first; return the first one that
    restores: (state, run_id, step). Corrupt checkpoints are skipped.

    ``alternates`` is a sequence of (template, convert_fn) pairs tried on
    each candidate after ``target`` fails, newest candidate first, so a run
    whose newest checkpoint has a different-but-convertible structure (e.g.
    ema_decay toggled mid-run) resumes from that newest step via
    ``convert_fn(restored)`` instead of falling back to an older one.

    Under a ``mesh`` every rank walks rank 0's list of candidates, and a
    candidate (with a template) is taken only when every rank restored it
    with that template (one all-gather an attempt), so all ranks resume the
    same run, step and optimizer state, and a collective sharded read is
    never left waiting for a rank that moved on."""
    base = os.path.join(experiment_path, "outputs", experiment_name, "runs")
    candidates = (_candidates(base) if mesh is None or dist.get_rank() == 0
                  else None)
    if mesh is not None:
        box = [candidates]
        dist.broadcast_object_list(box, src=0)
        candidates = box[0]

    templates = [(target, None)] + list(alternates)
    mismatches = []
    for run_id, run_dir, step in candidates:
        step_dir = os.path.join(run_dir, "checkpoints", str(step))
        if os.path.exists(os.path.join(step_dir, _DCP_META)):
            from torch.distributed.checkpoint.api import CheckpointException

            # sharded: restore straight into each template's shards
            for tmpl, convert in templates:
                if not _has_shards(tmpl):
                    continue
                err = None
                try:
                    restored = restore_sharded(step_dir, tmpl)
                # corrupt or mismatched; a key the step lacks comes as a
                # CheckpointException, which derives from BaseException
                except (Exception, CheckpointException) as e:  # noqa: BLE001
                    err = f"{type(e).__name__}: {str(e)[:200]}"
                if _agreed(err is None, mesh) is True:
                    return (convert(restored) if convert is not None
                            else restored, run_id, step)
                print(f"[ckpt] skipping run-{run_id} step {step}: "
                      f"{err or 'another rank could not restore it'}")
            continue
        saved, choice, first_err = None, None, None
        try:
            saved = CheckpointManager(run_dir).load(step)
        except Exception as e:  # noqa: BLE001 — unreadable == corrupt
            first_err = (f"corrupt/unreadable ({type(e).__name__}: "
                         f"{str(e)[:200]})")
        for i, (tmpl, _) in enumerate(templates if saved is not None else ()):
            try:
                _check(tmpl, saved)
            except ValueError as e:
                first_err = first_err or e
                continue
            choice = i
            break
        agreed = _agreed(choice, mesh)
        if agreed is not None:
            tmpl, convert = templates[agreed]
            restored = _restore(tmpl, saved)
            return (convert(restored) if convert is not None else restored,
                    run_id, step)
        if saved is None:
            print(f"[ckpt] skipping run-{run_id} step {step}: {first_err}")
        elif choice is not None:
            print(f"[ckpt] skipping run-{run_id} step {step}: another rank "
                  "could not restore it")
        else:
            print(f"[ckpt] skipping run-{run_id} step {step}: TEMPLATE "
                  f"MISMATCH ({str(first_err)[:200]})")
            mismatches.append((run_id, step, str(first_err)))
    if mismatches:
        print("[ckpt] WARNING: checkpoints exist but NONE match the resume "
              "template — this is a model/optimizer/task structure change, "
              "not corruption. Resuming from scratch would lose "
              f"{len(mismatches)} checkpoint(s); first error:\n"
              f"  {mismatches[0][2][:300]}")
    return None, None, None


def _candidates(base: str) -> list:
    """Every run's checkpoint steps under ``base``, newest first:
    [(run_id, run_dir, step)]."""
    if not os.path.isdir(base):
        return []
    found = []  # (mtime, run_id, run_dir, step)
    for d in os.listdir(base):
        m = re.match(r"run-(.+)", d)
        ckpt_root = os.path.join(base, d, "checkpoints")
        if not (m and os.path.isdir(ckpt_root)):
            continue
        for item in os.listdir(ckpt_root):
            step_dir = os.path.join(ckpt_root, item)
            if item.isdigit() and os.path.isdir(step_dir):
                found.append((os.path.getmtime(step_dir), m.group(1),
                              os.path.join(base, d), int(item)))
    return [c[1:] for c in sorted(found, reverse=True)]


def _agreed(value: Any, mesh: Any) -> Any:
    """``value`` when every rank holds the same one (one all-gather over
    the group), else None; ``value`` itself without a mesh."""
    if mesh is None:
        return value
    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    return value if all(v == value for v in values) else None


def _has_shards(obj: Any) -> bool:
    if isinstance(obj, torch.Tensor):
        return is_sharded(obj)
    if isinstance(obj, torch.nn.Module):
        return any(is_sharded(p) for p in obj.parameters())
    if dataclasses.is_dataclass(obj):
        return any(_has_shards(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, Mapping):
        return any(_has_shards(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_has_shards(v) for v in obj)
    return False


def _dcp_tensor(t: torch.Tensor):
    """A leaf as ``torch.distributed.checkpoint`` takes it, sharing t's
    storage (a load writes into it): a shard as the DTensor it is a part of
    (its dim over 'dp'), anything else as it is (replicated)."""
    info = getattr(t, "_fsdp", None)
    if info is None:
        return t.detach()
    from torch.distributed.tensor import DTensor, Replicate, Shard

    placements = [Shard(info.dim) if name == "dp" else Replicate()
                  for name in info.mesh.mesh_dim_names]
    stride = torch.empty(info.shape, device="meta").stride()
    return DTensor.from_local(t.detach(), info.mesh, placements,
                              run_check=False, shape=torch.Size(info.shape),
                              stride=stride)


def _dcp_entries(obj: Any, path: str = "state", out=None) -> dict:
    """The flat {path: leaf} that torch.distributed.checkpoint saves and
    loads: modules give their state_dict's tensors (the shards), a
    generator its state."""
    out = {} if out is None else out
    if isinstance(obj, torch.Tensor):
        out[path] = _dcp_tensor(obj)
    elif isinstance(obj, torch.nn.Module):
        for k, v in obj.state_dict(keep_vars=True).items():
            out[f"{path}/{k}"] = _dcp_tensor(v)
    elif isinstance(obj, torch.Generator):
        out[path] = obj.get_state()
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            _dcp_entries(getattr(obj, f.name), f"{path}/{f.name}", out)
    elif isinstance(obj, Mapping):
        for k, v in obj.items():
            _dcp_entries(v, f"{path}/{k}", out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _dcp_entries(v, f"{path}/{i}", out)
    elif obj is not None:
        out[path] = obj
    return out


def _dcp_apply(template: Any, flat: dict, path: str = "state") -> Any:
    """``template`` with the scalars of a loaded ``flat`` (its tensors were
    loaded in place)."""
    if isinstance(template, torch.Generator):
        template.set_state(flat[path])
        return template
    if isinstance(template, (torch.Tensor, torch.nn.Module)) or template is None:
        return template
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _dcp_apply(getattr(template, f.name), flat,
                               f"{path}/{f.name}")
            for f in dataclasses.fields(template)})
    if isinstance(template, Mapping):
        return {k: _dcp_apply(v, flat, f"{path}/{k}")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_dcp_apply(v, flat, f"{path}/{i}")
                              for i, v in enumerate(template))
    return flat[path]


def restore_sharded(step_dir: str, template: Any) -> Any:
    """Load a sharded checkpoint into ``template`` (built sharded on every
    rank, collectively): each rank reads its own shards in place."""
    import torch.distributed.checkpoint as dcp

    flat = _dcp_entries(template)
    dcp.load(flat, checkpoint_id=step_dir)
    return _dcp_apply(template, flat)


def strip_prefixes(key: str, prefixes=("module.", "net.")) -> str:
    for p in prefixes:
        if key.startswith(p):
            key = key[len(p):]
    return key


def load_torch_state_dict(path: str, submodel: Optional[str] = None) -> dict:
    """Read a torch checkpoint into {clean_key: np.ndarray}: optionally
    select checkpoint['model'][submodel], then strip module./net. prefixes
    (reference pipeline/helpers.py:14-32 ``load_checkpoint_cascast``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and submodel is not None and "model" in ckpt:
        ckpt = ckpt["model"][submodel]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    out = {}
    for k, v in ckpt.items():
        out[strip_prefixes(str(k))] = np.asarray(v.detach().cpu().numpy()) \
            if hasattr(v, "detach") else np.asarray(v)
    return out
