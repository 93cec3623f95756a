"""Advection-diffusion physics prior (counterpart of
weatherforecastingtoolkit_tpu/ops/pallas/stencil.py).

    r = dx/dt + u * dx/dw + v * dx/dh - kappa * laplacian(x)
    loss = mean(r^2)

over the interior of every consecutive frame pair of x (B, T, C, H, W), with
central differences and the 5-point Laplacian.

Dispatch: a CPU tensor takes ``advection_diffusion_residual_reference``; a
CUDA tensor launches the Hopper kernel (``ops/cuda/stencil.py``) or raises.
Nothing falls back quietly. Both take fp32 or bf16 x. With bf16 x the
differences dt, dh, dw and lap are bf16 (each operation rounded, left to
right as written) and, as jnp promotes them with the TPU kernel's fp32 u, v
and kappa, the residual, its square and the mean are fp32.

``advection_diffusion_prior`` is differentiable in x, u, v and kappa: its
forward is the kernel, its backward the autograd of the plain version,
recomputed, as the JAX ``_prior_bwd`` differentiates the XLA version.
Pass u, v and kappa as fp32 tensors on x's device to keep the training step
free of host syncs: the kernel reads them where they lie, and a call is one
kernel launch. A Python float is copied to the device on every call.
"""

from __future__ import annotations

from typing import Union

import torch

from .cuda import stencil as _cuda

Scalar = Union[float, torch.Tensor]


def advection_diffusion_residual_reference(x: torch.Tensor, u: Scalar,
                                           v: Scalar, kappa: Scalar
                                           ) -> torch.Tensor:
    """Plain version, a copy of ``advection_diffusion_residual_xla``:
    x (..., T, H, W) -> mean squared interior residual. The differences are
    in x's dtype, the residual in fp32 (jnp's promotion with fp32 u, v,
    kappa; torch would keep a 0-d fp32 tensor times bf16 in bf16)."""
    x0 = x[..., :-1, :, :]
    x1 = x[..., 1:, :, :]
    dt = x1 - x0
    c = x0[..., 1:-1, 1:-1]
    dh = (x0[..., 2:, 1:-1] - x0[..., :-2, 1:-1]) * 0.5
    dw = (x0[..., 1:-1, 2:] - x0[..., 1:-1, :-2]) * 0.5
    lap = (x0[..., 2:, 1:-1] + x0[..., :-2, 1:-1] + x0[..., 1:-1, 2:]
           + x0[..., 1:-1, :-2] - 4.0 * c)
    f32 = torch.float32
    r = (dt[..., 1:-1, 1:-1].to(f32) + u * dw.to(f32) + v * dh.to(f32)
         - kappa * lap.to(f32))
    return torch.mean(r * r)


def _frames_reference(x: torch.Tensor, u: Scalar, v: Scalar,
                      kappa: Scalar) -> torch.Tensor:
    """(B, T, C, H, W) -> the plain version over (B*C, T, H, W)."""
    b, t, c, h, w = x.shape
    return advection_diffusion_residual_reference(
        x.transpose(1, 2).reshape(b * c, t, h, w), u, v, kappa)


def advection_diffusion_loss(x: torch.Tensor, u: Scalar, v: Scalar,
                             kappa: Scalar) -> torch.Tensor:
    """Mean squared advection-diffusion residual over (B, T, C, H, W)."""
    if x.ndim != 5:
        raise ValueError(f"expected (B, T, C, H, W), got {tuple(x.shape)}")
    if x.shape[1] < 2:
        raise ValueError("need at least 2 frames for a temporal difference")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the advection-diffusion prior takes fp32 or bf16, "
                        f"got {x.dtype}")
    if x.device.type == "cpu":
        return _frames_reference(x, u, v, kappa)
    u, v, kappa = (torch.as_tensor(s, dtype=torch.float32, device=x.device)
                   for s in (u, v, kappa))
    return _cuda.advection_stencil_cuda_scalars(x, u, v, kappa)


class AdvectionDiffusionPrior(torch.autograd.Function):
    """Forward: the kernel (plain version for a CPU tensor). Backward: the
    autograd of the plain version, recomputed under ``enable_grad``."""

    @staticmethod
    def forward(ctx, x, u, v, kappa):
        ctx.save_for_backward(x, u, v, kappa)
        return advection_diffusion_loss(x, u, v, kappa)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip(saved, ctx.needs_input_grad)]
            wanted = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad(_frames_reference(*leaves),
                                             wanted, g))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def advection_diffusion_prior(x: torch.Tensor, u: Scalar, v: Scalar,
                              kappa: Scalar) -> torch.Tensor:
    """Differentiable physics prior: the kernel forward, the plain
    version's autograd backward. Gradients reach x, u, v and kappa."""
    u, v, kappa = (torch.as_tensor(s, dtype=torch.float32, device=x.device)
                   for s in (u, v, kappa))
    return AdvectionDiffusionPrior.apply(x, u, v, kappa)
