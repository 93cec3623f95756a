"""Experiment logging: JSONL scalars, histograms and VIL image panels (+
optional wandb), a copy of weatherforecastingtoolkit_tpu/training/
logging.py, which imports no JAX.

The primary backend is a local JSONL file per run; W&B attaches iff `wandb`
is importable and WANDB_API_KEY is set in the environment. ``log_images``
imports matplotlib when it is called, as the JAX module does: where
matplotlib is absent it raises ImportError.
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
        """3xT panels: original / reconstruction / abs diff with the VIL
        colormap (reference pipeline/helpers.py:155-225). predicted/target:
        (B, T, H, W) or (B, T, 1, H, W) in [0, 1]."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from ..data.colormap import vil_cmap

        predicted = np.asarray(predicted)
        target = np.asarray(target)
        if predicted.ndim == 5:
            predicted = predicted[:, :, 0]
        if target.ndim == 5:
            target = target[:, :, 0]

        in_range = np.mean((target >= 0) & (target <= 1))
        if in_range < 0.9:
            print(f"[logging] warning: target data not in [0,1]: {in_range:.2%}")

        tgt = (np.clip(target, 0, 1) * 255).astype(np.uint8)
        prd = (np.clip(predicted, 0, 1) * 255).astype(np.uint8)
        diff = np.abs(tgt.astype(float) - prd.astype(float)).clip(0, 255).astype(np.uint8)
        b_total, t_total = tgt.shape[:2]
        cmap, norm, _, _ = vil_cmap()

        for b in range(min(batch_idxs, b_total)):
            fig, axes = plt.subplots(3, t_total, figsize=(2 * t_total, 6),
                                     squeeze=False)
            for t in range(t_total):
                for row, (img, kw, title) in enumerate((
                        (tgt[b, t], dict(cmap=cmap, norm=norm), "orig"),
                        (prd[b, t], dict(cmap=cmap, norm=norm), "recon"),
                        (diff[b, t], dict(cmap="Reds", vmin=0, vmax=255), "absdiff"))):
                    ax = axes[row, t]
                    ax.imshow(img, **kw)
                    ax.set_title(f"{title} t={t}", fontsize=6)
                    ax.axis("off")
            fig.tight_layout()
            safe = label.replace("/", "_").replace(" ", "_")
            path = os.path.join(self.run_dir, "media",
                                f"{safe}_step{step}_b{b}.png")
            fig.savefig(path, dpi=72)
            if self._wandb is not None:
                self._wandb.log({label: self._wandb.Image(fig)}, step=step)
            plt.close(fig)

    def close(self) -> None:
        self._jsonl.close()
        if self._wandb is not None:
            self._wandb.finish()


def read_jsonl_metrics(run_dir: str):
    path = os.path.join(run_dir, "metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
