"""Forecast-verification metric suite in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/metrics.py): CSI / HSS / CRPS / SSIM / PSNR.

Inputs are (B, T, C, H, W), or (B, N, T, C, H, W) with an ensemble axis, in
[0, 1]; the output is the JAX package's flat dict of Python floats with the
SEVIR VIL thresholds {16, 74, 133, 160, 181, 219}/255 (each rounded to fp32,
as jnp.asarray does), average pooling at scales {1, 4, 16} and the
``paper_*`` aggregates. As in JAX, every pooled field is computed once, the
six thresholds are broadcast into one contingency reduction a pool scale,
and the results reach the host in one copy at the end. The metrics run on
the tensors' device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .ops.pooling import avg_pool2d, max_pool2d
from .ops.ssim import psnr as _psnr_nchw
from .ops.ssim import ssim as _ssim_nchw

_EPS = 1e-8          # reference pipeline/metrics.py:7
_CRPS_EPS = 1e-10    # reference pipeline/metrics.py:21
VIL_THRESHOLDS = (16 / 255, 74 / 255, 133 / 255, 160 / 255, 181 / 255, 219 / 255)
POOL_SCALES = (1, 4, 16)


def _contingency(pred: torch.Tensor, target: torch.Tensor,
                 thresholds: torch.Tensor):
    """TP/FN/FP/TN over all thresholds at once: pred/target (M, H, W),
    thresholds (K,) -> four (K,) fp32 counts (>= thresholding; counted as
    integers, then cast, as JAX sums booleans)."""
    th = thresholds.reshape(-1, 1, 1, 1)
    p = pred[None] >= th
    t = target[None] >= th
    dims = (1, 2, 3)

    def count(m):
        return m.sum(dim=dims).to(torch.float32)

    return count(p & t), count(~p & t), count(p & ~t), count(~p & ~t)


def _csi(tp, fn, fp):
    return tp / (tp + fn + fp + _EPS)


def _hss(tp, fn, fp, tn):
    num = 2.0 * (tp * tn - fn * fp)
    den = (tp + fn) * (fn + tn) + (tp + fp) * (fp + tn) + _EPS
    return num / den


def _crps_gaussian(mean: torch.Tensor, std: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Gaussian CRPS (reference pipeline/metrics.py:18-41 formula)."""
    normed = (mean - target + _CRPS_EPS) / (std + _CRPS_EPS)
    cdf = torch.special.ndtr(normed)
    pdf = torch.exp(-0.5 * normed * normed) * (1.0 / math.sqrt(2.0 * math.pi))
    val = (std + _CRPS_EPS) * (normed * (2.0 * cdf - 1.0) + 2.0 * pdf
                               - 1.0 / math.sqrt(math.pi))
    return torch.mean(val)


def _ensemble_stats(e: torch.Tensor, n: int):
    """Mean and std (ddof=1; 0 for one member) over the member axis 1."""
    mean = torch.mean(e, dim=1)
    std = torch.std(e, dim=1, correction=1) if n > 1 else torch.zeros_like(mean)
    return mean, std


def _frames(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (M, H, W)."""
    return x.reshape((-1,) + tuple(x.shape[-2:]))


def _pool(x: torch.Tensor, pool_type: str, scale: int) -> torch.Tensor:
    if pool_type == "avg":
        return avg_pool2d(x, scale)
    if pool_type == "max":
        return max_pool2d(x, scale)
    return x


def _thresholds(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


@torch.no_grad()
def _calc_metrics(pred: torch.Tensor, target: torch.Tensor,
                  psnr_data_range: Optional[float]) -> Dict[str, torch.Tensor]:
    pred = torch.clamp(pred.float(), 0.0, 1.0)
    target = torch.clamp(target.float(), 0.0, 1.0)
    if pred.ndim == 6:
        n = pred.shape[1]
        ens, single = pred, torch.mean(pred, dim=1)
    else:
        n = 1
        ens, single = pred[:, None], pred
    results: Dict[str, torch.Tensor] = {}

    # CRPS at pool scales 1/4/16 (avg pooling), ensemble mean/std per pixel
    ens_flat, tgt_flat = _frames(ens), _frames(target)
    for scale, name in ((1, "CRPS"), (4, "CRPS_4"), (16, "CRPS_16")):
        e = ens_flat if scale == 1 else avg_pool2d(ens_flat, scale)
        g = tgt_flat if scale == 1 else avg_pool2d(tgt_flat, scale)
        e = e.reshape(tuple(ens.shape[:4]) + tuple(e.shape[-2:]))
        g = g.reshape(tuple(target.shape[:3]) + tuple(g.shape[-2:]))
        results[name] = _crps_gaussian(*_ensemble_stats(e, n), g)

    # SSIM / PSNR on (B*T, C, H, W)
    p_nchw = single.reshape((-1,) + tuple(single.shape[-3:]))
    t_nchw = target.reshape((-1,) + tuple(target.shape[-3:]))
    results["SSIM"] = _ssim_nchw(p_nchw, t_nchw, data_range=1.0)
    results["PSNR"] = _psnr_nchw(p_nchw, t_nchw, data_range=psnr_data_range)
    results["PSNR_ref"] = (results["PSNR"] if psnr_data_range is None
                           else _psnr_nchw(p_nchw, t_nchw, data_range=None))

    # CSI / HSS: 6 thresholds x 3 pool scales, one pass each scale
    th = _thresholds(VIL_THRESHOLDS, pred.device)
    p_flat = _frames(single)
    for scale in POOL_SCALES:
        suffix = "" if scale == 1 else f"_{scale}"
        pp = p_flat if scale == 1 else avg_pool2d(p_flat, scale)
        tt = tgt_flat if scale == 1 else avg_pool2d(tgt_flat, scale)
        tp, fn, fp, tn = _contingency(pp, tt, th)
        csi_v, hss_v = _csi(tp, fn, fp), _hss(tp, fn, fp, tn)
        for i in range(len(VIL_THRESHOLDS)):
            results[f"CSI_{i}{suffix}"] = csi_v[i]
            results[f"HSS_{i}{suffix}"] = hss_v[i]
        results[f"_csi_mean{suffix}"] = torch.mean(csi_v)
        results[f"_hss_mean{suffix}"] = torch.mean(hss_v)
    return results


def calc_metrics(pred, target, psnr_data_range=1.0) -> Dict[str, float]:
    """Drop-in analog of the reference ``calc_metrics``: pred, target
    (B, T, C, H, W) in [0, 1] (tensors or arrays); pred may carry an
    ensemble axis (B, N, T, C, H, W). Returns a flat dict of Python floats
    with the ``paper_*`` aggregates. ``PSNR`` uses psnr_data_range (1.0
    pins the [0, 1] clamp; None estimates the range per frame), and
    ``PSNR_ref`` always uses the reference's estimated range."""
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target, device=pred.device)
    raw = _calc_metrics(pred, target, psnr_data_range)
    keys = list(raw)
    values = torch.stack([raw[k].float() for k in keys]).cpu().tolist()
    raw = dict(zip(keys, values))
    results = {k: v for k, v in raw.items() if not k.startswith("_")}
    results["paper_SSIM"] = results["SSIM"]
    results["paper_PSNR"] = results["PSNR"]
    results["paper_CRPS"] = results["CRPS"]
    for pool_name, suffix in (("POOL1", ""), ("POOL4", "_4"), ("POOL16", "_16")):
        results[f"paper_CSI_M_{pool_name}"] = raw[f"_csi_mean{suffix}"]
        results[f"paper_CSI_181_{pool_name}"] = results[f"CSI_4{suffix}"]
        results[f"paper_CSI_219_{pool_name}"] = results[f"CSI_5{suffix}"]
        results[f"paper_HSS_{pool_name}"] = raw[f"_hss_mean{suffix}"]
    return results


def crps(pred, target, pool_type: str = "none", scale: int = 1) -> float:
    """Standalone Gaussian CRPS with optional avg/max pooling (reference
    ``crps``, pipeline/metrics.py:18-41). pred is (B, T, C, H, W) or
    (B, N, T, C, H, W); the ensemble std uses ddof=1, one member -> 0."""
    pred = torch.as_tensor(pred).float()
    target = torch.as_tensor(target, device=pred.device).float()
    if pred.ndim == 5:
        pred = pred[:, None]
    n = pred.shape[1]
    with torch.no_grad():
        pr = _pool(_frames(pred), pool_type, scale)
        gt = _pool(_frames(target), pool_type, scale)
        pr = pr.reshape(tuple(pred.shape[:4]) + tuple(pr.shape[-2:]))
        gt = gt.reshape(tuple(target.shape[:3]) + tuple(gt.shape[-2:]))
        return float(_crps_gaussian(*_ensemble_stats(pr, n), gt))


def _scores(pred, target, threshold, pool_type, scale):
    pred = torch.clamp(torch.as_tensor(pred).float(), 0, 1)
    target = torch.clamp(torch.as_tensor(target, device=pred.device).float(),
                         0, 1)
    with torch.no_grad():
        pp = _pool(_frames(pred), pool_type, scale)
        tt = _pool(_frames(target), pool_type, scale)
        return _contingency(pp, tt, _thresholds([threshold], pred.device))


def csi(pred, target, threshold, pool_type: str = "none", scale: int = 1
        ) -> float:
    tp, fn, fp, _ = _scores(pred, target, threshold, pool_type, scale)
    return float(_csi(tp, fn, fp)[0])


def hss(pred, target, threshold, pool_type: str = "none", scale: int = 1
        ) -> float:
    return float(_hss(*_scores(pred, target, threshold, pool_type, scale))[0])

