"""Two-optimizer adversarial training (counterpart of
weatherforecastingtoolkit_tpu/training/gan.py).

One step does what the JAX step does: backward(rec_loss) and
backward(g_loss) for the generator, the adaptive weight from the two
gradients of its last layer, the generator update, backward(d_loss) for the
discriminator on the detached reconstruction, and the discriminator update
gated by ``disc_start``.

How the port keeps JAX's functional semantics with in-place optimizers:
every gradient is taken before any update (the adversarial loss and the
discriminator's loss see the discriminator before its update, the
discriminator trains on the reconstruction of the generator before its
update), with ``torch.autograd.grad`` with respect to the parameters each
gradient is for, so nothing accumulates in any ``.grad``. JAX runs the
generator forward twice with the same rng; the port shares one forward
between the two generator gradients (``retain_graph``), which gives the
same reconstruction.

State: the generator (and, with a KL term, the learnable ``logvar``) is
``TrainState.params`` (a ``VAEGANParams``), the only thing the trainer's
optimizer tracks; the discriminator and its optimizer state live in
``TrainState.extra`` (built by ``init_extra``), so ``--resume`` restores both
optimizers. Before ``disc_start`` the discriminator's gradients and its
updates are zero: its Adam moments stay at zero while the update count
advances, as in optax.

Loss scale is the JAX package's (and the reference's): with KL, the NLL is
the per-sample sum, batch-averaged, of rec_map / exp(logvar) + logvar, and
the KL term the batch mean; the perceptual distance (LPIPS or the
discriminator's feature matching) is broadcast onto the elementwise
reconstruction map before the reduction.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..models.losses.gan import (adaptive_weight, adopt_weight,
                                 feature_matching_distance, hinge_d_loss,
                                 vanilla_d_loss)
from ..ops.amp import cast_call
from .optim import global_norm
from .tasks import _frames, dequantize
from .trainer import Task, TrainState


class VAEGANParams(nn.Module):
    """The trained parameters of the GAN task: the generator ``gen`` and,
    with a KL term, the scalar ``logvar`` (zero at init), as the JAX
    task's {"gen": ..., "logvar": ...}."""

    def __init__(self, gen: nn.Module, learn_logvar: bool):
        super().__init__()
        self.gen = gen
        if learn_logvar:
            device = next(gen.parameters()).device
            self.logvar = nn.Parameter(torch.zeros((), device=device))


def leaf_by_path(module: nn.Module, path: str) -> torch.Tensor:
    """The parameter named ``path`` ("dec_out.weight"): the port's form of
    the JAX key path ("params", "dec_out", "kernel")."""
    return module.get_parameter(path)


def pixel_loss_map(kind: str) -> Callable:
    """Elementwise (un-reduced) pixel losses: the reconstruction loss stays
    a map until the final NLL reduction."""
    if kind == "l1":
        return lambda a, b: torch.abs(a - b)
    if kind == "mse":
        return lambda a, b: (a - b) ** 2
    if kind == "huber":
        def huber(a, b, delta=1.0):
            d = a - b
            ad = torch.abs(d)
            return torch.where(ad <= delta, 0.5 * d * d,
                               delta * (ad - 0.5 * delta))
        return huber
    raise ValueError(kind)


def _grads(loss, params, **kwargs):
    """d loss / d params, zeros where a parameter does not reach the loss
    (jax.grad's zeros)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True, **kwargs)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def make_vae_gan_task(
    *,
    name: str,
    generator_apply: Callable,   # (gen, frames, rng) -> (recon, kl or None)
    gen_init: Callable,          # (seed, device) -> gen module
    disc_apply: Callable,        # (disc, frames) -> logits
    disc_init: Callable,         # (seed, device) -> disc module
    disc_tx,                     # the discriminator's optimizer (optim.adam)
    last_layer_path: str,        # the generator's last-layer weight name
    eval_apply: Optional[Callable] = None,   # (gen, frames) -> recon
    pixel_loss: str = "l1",
    perceptual_apply: Optional[Callable] = None,  # (a, b) -> (B,1,1,1)
    perceptual_weight: float = 1.0,
    # (disc, frames) -> (logits, [feats]): the weight-free perceptual term,
    # L1 over the discriminator's own features, e.g.
    # lambda d, f: d(f, return_features=True)
    disc_feats_apply: Optional[Callable] = None,
    feature_matching_weight: float = 0.0,
    recon_weight: float = 1.0,
    kl_weight: Optional[float] = None,   # None: no KL, no learnable logvar
    disc_weight: float = 1.0,
    disc_factor: float = 1.0,
    disc_start: int = 0,
    disc_loss: str = "hinge",
    key: str = "vil",
    mixed_precision: bool = False,
) -> Task:
    """A Task whose ``custom_train_step`` runs the VAE-GAN update.

    mixed_precision=True runs the generator and the discriminator in bf16
    on copies of the fp32 master parameters (``ops/amp.py``); the NLL, KL
    and adaptive-weight math stays fp32."""
    d_loss_fn = hinge_d_loss if disc_loss == "hinge" else vanilla_d_loss
    use_kl = kl_weight is not None
    px_map = pixel_loss_map(pixel_loss)

    if mixed_precision:
        _gen_apply, _disc_apply = generator_apply, disc_apply

        def generator_apply(g, f, rng):  # noqa: F811 (bf16 compute)
            recon, kl = cast_call(_gen_apply, g, f, rng)
            return recon.float(), None if kl is None else kl.float()

        def disc_apply(d, f):  # noqa: F811
            return cast_call(_disc_apply, d, f).float()

        if disc_feats_apply is not None:
            _disc_feats_apply = disc_feats_apply

            def disc_feats_apply(d, f):  # noqa: F811
                logits, feats = cast_call(_disc_feats_apply, d, f)
                return logits.float(), [x.float() for x in feats]

    use_fm = disc_feats_apply is not None and feature_matching_weight > 0

    def init_params(seed, device):
        return VAEGANParams(gen_init(seed, device), use_kl)

    def init_extra(seed, params):
        disc = disc_init(seed, next(params.parameters()).device)
        return {"disc_params": disc,
                "disc_opt_state": disc_tx.init(list(disc.parameters()))}

    # ---- losses --------------------------------------------------------------
    def rec_loss_fn(gen, logvar, frames, rng, disc=None):
        recon, kl = generator_apply(gen, frames, rng)
        rec_map = recon_weight * px_map(recon, frames)
        aux = {}
        if perceptual_apply is not None and perceptual_weight > 0:
            a = recon.repeat(1, 3, 1, 1) if recon.shape[1] == 1 else recon
            b = frames.repeat(1, 3, 1, 1) if frames.shape[1] == 1 else frames
            p = perceptual_apply(a, b)
            aux["p_loss"] = torch.mean(p)
            rec_map = rec_map + perceptual_weight * p
        if use_fm and disc is not None:
            # the discriminator is held constant here: the gradients are
            # taken with respect to the generator only
            _, f_fake = disc_feats_apply(disc, recon)
            _, f_real = disc_feats_apply(disc, frames)
            fm = feature_matching_distance(f_fake, f_real)
            aux["fm_loss"] = torch.mean(fm)
            rec_map = rec_map + feature_matching_weight * fm
        rec = torch.mean(rec_map)
        aux["rec_loss"] = rec
        if use_kl:
            nll = torch.sum(rec_map / torch.exp(logvar) + logvar) / frames.shape[0]
            kl_term = torch.mean(kl) if kl is not None else 0.0
            total = nll + kl_weight * kl_term
            # logvar as it was before this step's update
            aux.update({"nll_loss": nll, "kl_loss": kl_term,
                        "logvar": logvar.detach().clone()})
        else:
            total = rec
        return total, recon, aux

    # ---- the two-optimizer step ------------------------------------------------
    def custom_train_step(state: TrainState, batch, tx):
        frames = _frames(dequantize(batch[key]))
        gen = state.params.gen
        disc = state.extra["disc_params"]
        logvar = state.params.logvar if use_kl else None
        gen_params = list(gen.parameters())
        last = leaf_by_path(gen, last_layer_path)
        i_last = next(i for i, p in enumerate(gen_params) if p is last)

        # the generator's two gradients, from one forward
        rec_total, recon, aux = rec_loss_fn(gen, logvar, frames, state.rng,
                                            disc)
        g_loss = -torch.mean(disc_apply(disc, recon))
        wrt = gen_params + ([logvar] if use_kl else [])
        rec_grads = _grads(rec_total, wrt, retain_graph=True)
        adv_grads = _grads(g_loss, gen_params)
        d_w = adaptive_weight(rec_grads[i_last], adv_grads[i_last],
                              disc_weight)
        gate = adopt_weight(disc_factor, state.step, disc_start)
        coef = d_w * gate
        gen_grads = list(torch._foreach_add(
            rec_grads[:len(gen_params)], torch._foreach_mul(adv_grads, coef)))

        # the discriminator's gradient on the detached reconstruction, gated
        # by disc_start: zero gradients keep Adam's moments at zero
        d_gate = adopt_weight(1.0, state.step, disc_start)
        disc_params = list(disc.parameters())
        with torch.set_grad_enabled(bool(d_gate)):
            logits_real = disc_apply(disc, frames)
            logits_fake = disc_apply(disc, recon.detach())
            d_loss = d_loss_fn(logits_real, logits_fake)
        d_grads = (_grads(d_loss, disc_params) if d_gate
                   else [torch.zeros_like(p) for p in disc_params])

        # the updates, after every gradient is taken
        grad_of = {id(p): g for p, g in zip(wrt, gen_grads + rec_grads[
            len(gen_params):])}
        params = list(state.params.parameters())   # logvar comes first
        tx.update(params, [grad_of[id(p)] for p in params], state.opt_state)
        # a closed gate zeroes the update too (optax: updates * 0): the
        # optimizer state advances on zero gradients, the parameters stay
        disc_tx.update(disc_params if d_gate
                       else [p.detach().clone() for p in disc_params],
                       d_grads, state.extra["disc_opt_state"])

        aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in aux.items()}
        aux.update({"loss": (rec_total + coef * g_loss).detach(),
                    "g_loss": g_loss.detach(), "d_weight": d_w,
                    "disc_loss": (d_gate * d_loss).detach(),
                    "logits_real": torch.mean(logits_real).detach(),
                    "logits_fake": torch.mean(logits_fake).detach(),
                    "disc_factor": gate, "grad_norm": global_norm(gen_grads)})
        state.step += 1
        return state, aux

    def eval_fn(model, batch, rng):
        x = dequantize(batch[key])
        apply = eval_apply or (lambda g, f: generator_apply(g, f, rng)[0])
        with torch.no_grad():
            recon = apply(model.gen, _frames(x))
        return recon.reshape(x.shape), x

    def loss_fn(model, batch, rng, step):
        # validation: the reconstruction objective only (the FM term needs
        # the live discriminator, which eval-by-params callers do not carry)
        frames = _frames(dequantize(batch[key]))
        logvar = model.logvar if use_kl else None
        total, _recon, aux = rec_loss_fn(model.gen, logvar, frames, rng)
        return total, aux

    return Task(name=name, init_params=init_params, loss_fn=loss_fn,
                eval_fn=eval_fn, custom_train_step=custom_train_step,
                init_extra=init_extra)
