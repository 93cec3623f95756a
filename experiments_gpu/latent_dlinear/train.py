"""Frozen-VAE latent DLinear forecasting (the Path-B flagship) on the
PyTorch/CUDA port (counterpart of experiments/latent_dlinear/train.py).

Capability of reference experiments/ae_s2/train.py (+ the
pretrained_ae_dlinear_sevir/_ind variants via dlinear.individual): encode with
a frozen VAE, persistence-anchor the latents, DLinear forecast, MSE in latent
space; validation decodes and logs the full metric dict. The frozen encode
runs the GroupNorm+SiLU kernel on the card (16 launches a step at the
config's reference width).

    python experiments_gpu/latent_dlinear/train.py dataset.sevir_dir=...
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from experiments_gpu.common import main  # noqa: E402
from experiments_gpu.latent_common import build_frozen_vae  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.tasks import (  # noqa: E402
    latent_forecast_task)


def build_task(cfg, dm=None, device=None):
    """The Task of the config; the frozen VAE on `device` (None: cuda)."""
    encode_apply, _encode_mode, decode_apply, latent_shape = build_frozen_vae(
        cfg, device)
    d = int(np.prod(latent_shape))
    # channel_fold=true: the reference's _indc_indp variant — latent channels
    # folded into the sequence axis, features = spatial positions, and (with
    # individual) one linear per position
    # (reference pretrained_ae_dlinear_indc_indp/train.py:73-89,161)
    channel_fold = bool(cfg.dlinear.get("channel_fold", False))
    c_lat = int(latent_shape[0])
    seq_mul = c_lat if channel_fold else 1
    feat = d // c_lat if channel_fold else d
    forecaster = DLinear(
        seq_len=cfg.dataset.input_frames * seq_mul,
        pred_len=cfg.dataset.pred_frames * seq_mul,
        kernel_size=cfg.dlinear.kernel_size,
        individual=cfg.dlinear.get("individual", False),
        channels=feat, device=device)
    return latent_forecast_task(
        frozen_ae_apply=encode_apply,
        forecaster=forecaster,
        input_frames=cfg.dataset.input_frames,
        pred_frames=cfg.dataset.pred_frames,
        latent_shape=latent_shape,
        decode_apply=decode_apply,
        channel_fold=channel_fold,
        name=cfg.experiment_name)


if __name__ == "__main__":
    main(__file__, build_task)
