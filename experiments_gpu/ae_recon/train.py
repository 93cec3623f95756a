"""Frame-autoencoder reconstruction on the PyTorch/CUDA port (counterpart
of experiments/ae_recon/train.py): the model is ``cfg.model.name`` from the
port's registry, trained by ``reconstruction_task``.

``build_task(cfg, dm=None)`` builds the model from the config's model keys
(``experiments/ae_recon/config.yaml``) on the CPU from ``cfg.seed``;
``reconstruction_task`` hands the trainer a copy on the trainer's device.
The command line (``experiments_gpu/common.py::main``) trains it from a
SEVIR tree, on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from weatherforecastingtoolkit_tpu_torch.models.registry import build_model  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.tasks import (  # noqa: E402
    Task, reconstruction_task)


def build_task(cfg, dm=None, device=None) -> Task:
    """The Task of the config. ``device`` is accepted for the command
    line's uniform call: the model is built on the CPU and
    ``reconstruction_task`` copies it to the trainer's device."""
    kwargs = {k: v for k, v in cfg.model.items() if k != "name"}
    model = build_model(cfg.model.name, **kwargs, device="cpu",
                        seed=int(cfg.get("seed", 0)))
    return reconstruction_task(
        model, loss=cfg.get("loss", "l1"), name=cfg.experiment_name,
        mixed_precision=cfg.trainer.get("mixed_precision", False))


if __name__ == "__main__":
    from experiments_gpu.common import main

    main(__file__, build_task)
