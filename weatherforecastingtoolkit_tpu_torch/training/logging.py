"""Experiment logging: JSONL scalars and histograms (+ optional wandb), a
copy of weatherforecastingtoolkit_tpu/training/logging.py, which imports no
JAX.

The primary backend is a local JSONL file per run; W&B attaches iff `wandb`
is importable and WANDB_API_KEY is set in the environment. The VIL image
panels (``log_images``) wait for the metrics slice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np


def _try_wandb():
    if not os.environ.get("WANDB_API_KEY"):
        return None
    try:
        import wandb
        return wandb
    except ImportError:
        return None


class RunLogger:
    """Scalar + image logger bound to one run directory."""

    def __init__(self, run_dir: str, project: Optional[str] = None,
                 name: Optional[str] = None, resume_id: Optional[str] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        os.makedirs(os.path.join(run_dir, "media"), exist_ok=True)
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._wandb = _try_wandb()
        if self._wandb is not None:
            self._wandb.init(project=project, name=name, dir=run_dir,
                             resume="allow", id=resume_id)

    def log_scalars(self, metrics: Dict[str, float], step: int,
                    prefix: Optional[str] = None) -> None:
        if prefix:
            metrics = {f"{prefix}_{k}": v for k, v in metrics.items()}
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_histograms(self, named_arrays: Dict[str, np.ndarray], step: int,
                       prefix: Optional[str] = None, bins: int = 64) -> None:
        """Per-parameter weight/gradient histograms (the reference's
        `wandb.watch(log='all')`, pipeline/helpers.py:227-235). Local backend:
        one JSONL record per logging event in histograms.jsonl with fixed-bin
        counts + range per tensor; wandb backend gets native Histograms."""
        rec = {"step": int(step), "time": time.time()}
        wb = {}
        for name, v in named_arrays.items():
            v = np.asarray(v, dtype=np.float64).ravel()
            key = f"{prefix}_{name}" if prefix else name
            if v.size == 0 or not np.all(np.isfinite(v)):
                rec[key] = {"non_finite": True}
                continue
            counts, edges = np.histogram(v, bins=bins)
            rec[key] = {"counts": counts.tolist(),
                        "min": float(edges[0]), "max": float(edges[-1]),
                        "mean": float(v.mean()), "std": float(v.std())}
            if self._wandb is not None:
                wb[key] = self._wandb.Histogram(np_histogram=(counts, edges))
        path = os.path.join(self.run_dir, "histograms.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None and wb:
            self._wandb.log(wb, step=step)

    def log_images(self, predicted, target, label: str, step: int,
                   batch_idxs: int = 4) -> None:
        """3xT VIL panels need matplotlib and the VIL colormap, which the
        metrics slice of the port brings; until then this raises."""
        raise NotImplementedError(
            "RunLogger.log_images waits for the port's metrics slice "
            "(matplotlib panels with the VIL colormap)")

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def read_jsonl_metrics(run_dir: str):
    path = os.path.join(run_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
