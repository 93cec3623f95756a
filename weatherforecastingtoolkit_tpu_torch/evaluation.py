"""Forecast evaluation protocol: headline metrics, persistence wins, and
VAE-ceiling fractions (counterpart of weatherforecastingtoolkit_tpu/
evaluation.py).

 * ``HEADLINE`` — the six displayed metrics; ``SCORED`` drops PSNR_ref so
   the PSNR family is not double-weighted in win counting / checkpoint
   selection (display-only convention metric, see metrics.py).
 * ``wins_and_score`` — wins out of 5 plus a mean signed relative margin vs
   persistence (the scalar used to pick checkpoints between raw/EMA trees).
 * ``ceiling_fraction`` — fraction of the VAE roundtrip ceiling the
   forecaster claims on a higher-is-better metric (encode->decode of the
   TARGET frames bounds any latent forecaster under a given autoencoder).
 * ``evaluate_protocol`` — one pass over eval batches producing model /
   persistence / ceiling metric dicts + wins/score: each batch's metrics
   are computed, then averaged over batches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

HEADLINE = ("SSIM", "PSNR", "PSNR_ref", "CRPS", "paper_CSI_M_POOL1",
            "paper_HSS_POOL1")
HIGHER = frozenset({"SSIM", "PSNR", "PSNR_ref", "paper_CSI_M_POOL1",
                    "paper_HSS_POOL1"})
# PSNR_ref (estimated-range convention) is display-only: scoring it too
# would double-weight the PSNR family and break comparability with the
# established "wins/5" protocol.
SCORED = tuple(k for k in HEADLINE if k != "PSNR_ref")


def wins_and_score(model_m: Dict[str, float], persist_m: Dict[str, float]):
    """(#scored-headline wins, mean signed relative margin vs persistence)."""
    wins, score = 0, 0.0
    for k in SCORED:
        m, p = float(model_m[k]), float(persist_m[k])
        margin = (m - p) / max(abs(p), 1e-9)
        if k not in HIGHER:
            margin = -margin
        wins += int(margin > 0)
        score += margin / len(SCORED)
    return wins, score


def ceiling_fraction(model_m: Dict[str, float], ceiling_m: Dict[str, float],
                     key: str = "paper_CSI_M_POOL1") -> float:
    """model[key] / ceiling[key] for a higher-is-better metric — how much of
    its own VAE ceiling the forecaster claims (1.0 = the autoencoder, not
    the forecaster, is the binding constraint)."""
    if key not in HIGHER:
        raise ValueError(f"ceiling_fraction is defined for higher-is-better "
                         f"metrics, got {key!r}")
    return float(model_m[key]) / max(float(ceiling_m[key]), 1e-9)


@dataclass
class EvalReport:
    model: Dict[str, float]
    persistence: Dict[str, float]
    ceiling: Optional[Dict[str, float]]
    wins: int
    score: float

    def ceiling_fractions(self):
        if self.ceiling is None:
            return {}
        return {k: ceiling_fraction(self.model, self.ceiling, k)
                for k in SCORED if k in HIGHER}

    def format_table(self, tag: str = "eval") -> str:
        cols = f"{'metric':<22}{'model':>10}{'persistence':>13}"
        if self.ceiling is not None:
            cols += f"{'vae-ceiling':>13}"
        lines = [f"[{tag}] {cols}{'better?':>9}"]
        for k in HEADLINE:
            if k not in self.model:
                continue
            better = ((self.model[k] > self.persistence[k]) if k in HIGHER
                      else (self.model[k] < self.persistence[k]))
            row = f"{k:<22}{self.model[k]:>10.4f}{self.persistence[k]:>13.4f}"
            if self.ceiling is not None:
                row += f"{self.ceiling[k]:>13.4f}"
            lines.append(f"[{tag}] {row}{str(better):>9}")
        lines.append(f"[{tag}] wins {self.wins}/{len(SCORED)}  "
                     f"score {self.score:+.4f}")
        return "\n".join(lines)


def evaluate_protocol(eval_fn: Callable, fc_params, batches,
                      roundtrip_fn: Optional[Callable] = None,
                      calc_metrics: Optional[Callable] = None) -> EvalReport:
    """Run the full protocol over eval batches.

    eval_fn(params, seq) -> (pred, target, persistence) pixel tensors
    (models/rollout.make_eval_fn); roundtrip_fn(params, target) ->
    reconstruction (the VAE ceiling; omit for pixel-space models). `params`
    is whatever the caller passes (e.g. (vae, forecaster)); both functions
    run under ``torch.inference_mode``.
    """
    if calc_metrics is None:
        from .metrics import calc_metrics as _cm
        calc_metrics = _cm

    sums = [dict(), dict(), dict()]
    n = 0
    for seq in batches:
        with torch.inference_mode():
            pred, target, persist = eval_fn(fc_params, seq)
            rec = (roundtrip_fn(fc_params, target)
                   if roundtrip_fn is not None else None)
        outs = (pred, persist) + ((rec,) if rec is not None else ())
        for store, out in zip(sums, outs):
            for k, v in calc_metrics(out, target).items():
                store[k] = store.get(k, 0.0) + float(v)
        n += 1
    n = max(n, 1)
    model_m, persist_m, ceil_m = [{k: v / n for k, v in s.items()}
                                  for s in sums]
    wins, score = wins_and_score(model_m, persist_m)
    return EvalReport(model=model_m, persistence=persist_m,
                      ceiling=ceil_m or None, wins=wins, score=score)
