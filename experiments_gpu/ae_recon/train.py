"""Frame-autoencoder reconstruction on the PyTorch/CUDA port (counterpart
of experiments/ae_recon/train.py): the model is ``cfg.model.name`` from the
port's registry, trained by ``reconstruction_task``.

``build_task(cfg, dm=None)`` builds the model from the config's model keys
(``experiments/ae_recon/config.yaml``) on the CPU from ``cfg.seed``;
``reconstruction_task`` hands the trainer a copy on the trainer's device.
The command-line entry point waits for the port's data slice, as
experiments_gpu/earthformer/train.py says.
"""

from __future__ import annotations

from weatherforecastingtoolkit_tpu_torch.models.registry import build_model
from weatherforecastingtoolkit_tpu_torch.training.tasks import (
    Task, reconstruction_task)


def build_task(cfg, dm=None) -> Task:
    kwargs = {k: v for k, v in cfg.model.items() if k != "name"}
    model = build_model(cfg.model.name, **kwargs, device="cpu",
                        seed=int(cfg.get("seed", 0)))
    return reconstruction_task(
        model, loss=cfg.get("loss", "l1"), name=cfg.experiment_name,
        mixed_precision=cfg.trainer.get("mixed_precision", False))
