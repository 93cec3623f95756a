"""Frozen-VAE + per-pixel Linear latent forecaster on the PyTorch/CUDA port
(counterpart of experiments/latent_linear/train.py).

Capability of reference experiments/v1_experiments/pretrained_ae_linear_sevir:
at each latent pixel, a Linear maps the stacked (T_in * C) features to
(T_out * C), with last-frame residual anchoring (train.py:67-98).

    python experiments_gpu/latent_linear/train.py dataset.sevir_dir=...
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from torch import nn  # noqa: E402

from experiments_gpu.common import main  # noqa: E402
from experiments_gpu.latent_common import build_frozen_vae  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.forecasters import (  # noqa: E402
    PerPixelLinear)
from weatherforecastingtoolkit_tpu_torch.training.tasks import (  # noqa: E402
    latent_forecast_task)


class FlatAdapter(nn.Module):
    """latent_forecast_task speaks (B, T, D); PerPixelLinear wants spatial."""

    def __init__(self, t_in: int, t_out: int, latent_shape: tuple, *,
                 device=None, seed: int = 0):
        super().__init__()
        self.t_in, self.t_out = t_in, t_out
        self.latent_shape = tuple(latent_shape)
        self.pixel_linear = PerPixelLinear(t_in, t_out, self.latent_shape[0],
                                           device=device, seed=seed)

    def forward(self, z):
        b = z.shape[0]
        c, h, w = self.latent_shape
        spatial = z.reshape(b, self.t_in, c, h, w)
        return self.pixel_linear(spatial).reshape(b, self.t_out, -1)


def build_task(cfg, dm=None, device=None):
    """The Task of the config; the frozen VAE on `device` (None: cuda)."""
    encode_apply, _m, decode_apply, latent_shape = build_frozen_vae(cfg, device)
    forecaster = FlatAdapter(t_in=cfg.dataset.input_frames,
                             t_out=cfg.dataset.pred_frames,
                             latent_shape=tuple(latent_shape), device=device)
    return latent_forecast_task(
        frozen_ae_apply=encode_apply, forecaster=forecaster,
        input_frames=cfg.dataset.input_frames,
        pred_frames=cfg.dataset.pred_frames,
        latent_shape=latent_shape, decode_apply=decode_apply,
        name=cfg.experiment_name)


if __name__ == "__main__":
    main(__file__, build_task)
