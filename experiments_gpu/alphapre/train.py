"""AlphaPre spectral amplitude/phase forecasting with the optional
advection-diffusion physics prior, on the PyTorch/CUDA port (counterpart of
experiments/alphapre/train.py).

``build_task(cfg, dm=None)`` builds the training Task from the experiment's
config (``experiments/alphapre/config.yaml``): AlphaPre at the config's
widths (``models/alphapre.py::get_model``) trained on its four-term loss,
and with ``physics_prior.enabled`` the prior
``weight * advection_diffusion_prior(pred, u, v, kappa)``, whose forward is
the hand-written Hopper stencil kernel on the card. The amplitude-loss
weight follows the trainer's step.

Drive it through ``Trainer.fit``::

    cfg = Config.load("experiments/alphapre/config.yaml")
    cfg = derive_steps(cfg, n_train_batches, n_val_batches)
    trainer = Trainer(cfg, build_task(cfg))
    state = trainer.fit(loader)   # batches {"vil": uint8 (B, 25, 1, H, W)}

The command-line entry point of the JAX experiment (``main`` in
experiments/common.py) waits for the port's data slice: it needs the SEVIR
data module and HDF5 reading, which the port does not have yet.
"""

from __future__ import annotations

import torch

from weatherforecastingtoolkit_tpu_torch.models.alphapre import get_model
from weatherforecastingtoolkit_tpu_torch.ops.stencil import (
    advection_diffusion_prior)
from weatherforecastingtoolkit_tpu_torch.training.tasks import Task, dequantize


def build_task(cfg, dm=None) -> Task:
    t_in, t_out = cfg.model.T_in, cfg.model.T_out
    prior = cfg.get("physics_prior", {})
    # (u, v, kappa) as device tensors, made once per device: a Python float
    # would be copied to the card, with a host sync, on every step
    coeffs = {}

    def split(batch):
        x = dequantize(batch["vil"])
        return x[:, :t_in], x[:, t_in:t_in + t_out]

    def init_params(seed, device):
        return get_model(cfg.model, device=device, seed=seed)

    def loss_fn(model, batch, rng, step):
        frames_in, frames_gt = split(batch)
        pred, loss = model.predict(frames_in, frames_gt, compute_loss=True,
                                   step=step)
        total = loss["total_loss"]
        aux = {k: v.detach() for k, v in loss.items() if k != "total_loss"}
        if prior.get("enabled", False):
            if pred.device not in coeffs:
                coeffs[pred.device] = torch.tensor(
                    [prior.get("u", 0.0), prior.get("v", 0.0),
                     prior.get("kappa", 0.05)], device=pred.device)
            u, v, kappa = coeffs[pred.device]
            p = advection_diffusion_prior(pred, u, v, kappa)
            total = total + prior.get("weight", 1e-3) * p
            aux["physics_prior"] = p.detach()
        return total, aux

    def eval_fn(model, batch, rng):
        frames_in, frames_gt = split(batch)
        with torch.no_grad():
            pred, _ = model.predict(frames_in)
        return torch.clamp(pred, 0.0, 1.0), frames_gt

    return Task(name=cfg.experiment_name, init_params=init_params,
                loss_fn=loss_fn, eval_fn=eval_fn)
