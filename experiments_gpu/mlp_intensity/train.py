"""Scalar storm-intensity forecasting with a time MLP on the PyTorch/CUDA
port (counterpart of experiments/mlp_intensity/train.py).

Capability of reference experiments/v1_experiments/prediff_mlp_sevir
(train.py:20-68): per-frame mean intensity of the VIL field, MLP maps the
input_frames intensities to pred_frames intensities, MSE loss.

    python experiments_gpu/mlp_intensity/train.py dataset.sevir_dir=...
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from weatherforecastingtoolkit_tpu_torch.models.forecasters import TimeMLP  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.tasks import Task, dequantize  # noqa: E402


def build_task(cfg, dm=None, device=None) -> Task:
    """The Task of the config. ``device`` is accepted for the command
    line's uniform call: ``init_params`` builds the MLP on the trainer's
    device."""
    t_in = cfg.dataset.input_frames
    t_out = cfg.dataset.pred_frames

    def intensities(batch):
        x = dequantize(batch["vil"])               # (B, T, C, H, W)
        return torch.mean(x, dim=(2, 3, 4))         # (B, T)

    def init_params(seed, dev):
        return TimeMLP(t_in=t_in, t_out=t_out,
                       hidden_dim=cfg.model.hidden_dim, device=dev, seed=seed)

    def loss_fn(model, batch, rng, step):
        s = intensities(batch)
        inp, tgt = s[:, :t_in], s[:, t_in:t_in + t_out]
        pred = model(inp)
        return torch.mean((pred - tgt) ** 2), {}

    return Task(name=cfg.experiment_name, init_params=init_params,
                loss_fn=loss_fn, eval_fn=None)


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
