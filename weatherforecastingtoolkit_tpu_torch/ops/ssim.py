"""SSIM and PSNR on (N, C, H, W) images in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/ops/ssim.py).

Gaussian-window SSIM (kernel 11, sigma 1.5, k1=0.01, k2=0.03), VALID, fp32.
The separable blur is two products with banded matrices: fp32 matrix
products stay full fp32 on the card by default, where cuDNN would run an
fp32 convolution in TF32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _band(n: int, size: int, sigma: float, device) -> torch.Tensor:
    """(n - size + 1, n) matrix whose row i holds the window at i..i+size."""
    k = _gaussian_kernel1d(size, sigma)
    m = np.zeros((n - size + 1, n), np.float32)
    for i in range(n - size + 1):
        m[i, i:i + size] = k
    return torch.from_numpy(m).to(device)


def _blur_valid(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """Separable gaussian blur, VALID padding. x: (N, C, H, W) fp32."""
    bh = _band(x.shape[-2], size, sigma, x.device)
    bw = _band(x.shape[-1], size, sigma, x.device)
    return torch.matmul(torch.matmul(bh, x), bw.T)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over a batch of (N, C, H, W) images. Returns a scalar."""
    pred = pred.float()
    target = target.float()
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_p = _blur_valid(pred, kernel_size, sigma)
    mu_t = _blur_valid(target, kernel_size, sigma)
    mu_pp = _blur_valid(pred * pred, kernel_size, sigma)
    mu_tt = _blur_valid(target * target, kernel_size, sigma)
    mu_pt = _blur_valid(pred * target, kernel_size, sigma)

    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t

    num = (2 * mu_p * mu_t + c1) * (2 * cov + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2)
    return torch.mean(num / den)


def psnr(pred: torch.Tensor, target: torch.Tensor,
         data_range: Optional[float] = 1.0) -> torch.Tensor:
    """Per-image PSNR averaged over the batch. (N, C, H, W) -> scalar.
    data_range=None estimates the range per frame as the target's
    max - min, as the reference's bare torchmetrics PSNR did."""
    pred = pred.float()
    target = target.float()
    mse = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
    if data_range is None:
        rng = (torch.amax(target, dim=(1, 2, 3))
               - torch.amin(target, dim=(1, 2, 3))).clamp_min(1e-6)
    else:
        rng = data_range
    return torch.mean(10.0 * torch.log10(rng ** 2 / mse.clamp_min(1e-12)))
