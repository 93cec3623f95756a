"""Earthformer-style cuboid-transformer nowcasting with the
advection-diffusion physics prior, on the PyTorch/CUDA port (counterpart of
experiments/earthformer/train.py, BASELINE.json config #5).

``build_task(cfg, dm=None)`` builds the training Task from the experiment's
config (``experiments/earthformer/config.yaml``): Earthformer at the
config's widths, the pixel loss, and with ``physics_prior.enabled`` the
prior ``weight * advection_diffusion_prior(pred, u, v, kappa)``, whose
forward is the hand-written Hopper stencil kernel on the card.

Drive it through ``Trainer.fit``::

    cfg = Config.load("experiments/earthformer/config.yaml")
    cfg = derive_steps(cfg, n_train_batches, n_val_batches)
    trainer = Trainer(cfg, build_task(cfg))
    state = trainer.fit(loader)   # batches {"vil": uint8 (B, 25, 1, H, W)}

The command-line entry point of the JAX experiment (``main`` in
experiments/common.py) waits for the port's data slice: it needs the SEVIR
data module and HDF5 reading, which the port does not have yet.
"""

from __future__ import annotations

import torch

from weatherforecastingtoolkit_tpu_torch.models.earthformer import Earthformer
from weatherforecastingtoolkit_tpu_torch.ops.stencil import (
    advection_diffusion_prior)
from weatherforecastingtoolkit_tpu_torch.training.tasks import (
    Task, dequantize, pixel_loss)


def build_task(cfg, dm=None) -> Task:
    m = cfg.model
    px = pixel_loss(cfg.get("loss", "mse"))
    prior = cfg.get("physics_prior", {})
    hw = cfg.dataset.get("img_size", 128)
    # (u, v, kappa) as device tensors, made once per device: a Python float
    # would be copied to the card, with a host sync, on every step
    coeffs = {}

    def split(batch):
        x = dequantize(batch["vil"])
        return x[:, :m.t_in], x[:, m.t_in:m.t_in + m.t_out]

    def init_params(seed, device):
        return Earthformer(t_in=m.t_in, t_out=m.t_out,
                           in_channels=m.in_channels, patch=m.patch,
                           dim=m.dim, depth=m.depth, num_heads=m.num_heads,
                           window=tuple(m.window),
                           residual_out=m.get("residual_out", False),
                           img_size=hw, device=device, seed=seed)

    def loss_fn(model, batch, rng, step):
        frames_in, frames_gt = split(batch)
        pred = model(frames_in)
        total = px(pred, frames_gt)
        aux = {}
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
            return model(frames_in), frames_gt

    return Task(name=cfg.experiment_name, init_params=init_params,
                loss_fn=loss_fn, eval_fn=eval_fn)
