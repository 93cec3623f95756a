"""AlphaPre: FFT amplitude/phase forecaster, in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/alphapre.py).

  * ``AmpTimeCell``: rfft2 over (H, W) (``norm="ortho"``), a complex linear
    mixing over T (real/imag matmuls, ReLU between), irfft2, a time-MLP bias;
  * ``AmpCell``: time-MLP residual + ``AmpTimeCell`` + a (T*C)-channel conv
    residual;
  * ``AmpliNet``: per-frame conv-in, an ``AmpCell`` stack, conv-out, a
    global time-MLP skip;
  * ``PhaseNet``: the future phase from the past phases and the (u, v)
    frequency grid (three ResNet branches); frames rebuilt from the last
    amplitude and the predicted phase;
  * ``AlphaMixer``: the low-frequency ``spec_mask`` recombination and a conv
    mixer;
  * ``AlphaPre.predict``: MSE + masked phase cosine + amplitude MSE (its
    weight a pure function of ``step``, decaying linearly to 0) + AmpliNet
    MSE.

All on (B, T, C, H, W), NCHW convs. The GroupNorms are flax ``nn.GroupNorm``
in JAX (eps 1e-6), so ``F.group_norm`` here; circular padding is
``F.pad(mode="circular")``; SELU and SiLU are torch's.

The spectra AlphaPre inverts are not Hermitian in their W=0 and W=W/2
columns (the learned complex mixing, and amplitudes times
``exp(1j * phase)``). ``irfft2`` is numpy's definition written out: a
complex inverse FFT over H, the real parts of those columns, an inverse
real FFT over W. XLA and pocketfft compute that; cuFFT's single-precision
2-D C2R does not for AmpTimeCell's (B, C, H, W_f, T) layout (0.099 from
float64 on xas, the sigmoid of AmpliNet's output, on an H100, the CPU 6e-6;
``chip_smoke.py`` phase 14), so ``torch.fft.irfft2`` is not used.
``torch.angle`` of rfft2 of real frames is pi at a real negative bin and 0
on an all-zero frame, on the CPU and on the card, as in JAX (the FFTs leave
+0 imaginary parts there); the phase of a bin whose value is rounding noise
is arbitrary on every device.

Weights are made from ``seed`` with flax's initializers (N(0, 0.02) for the
complex mixing); ``alphapre_state_dict_from_flax`` carries JAX-package
params across.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import group_norm, init_flax_defaults, normal_
from .transformer import transformer_state_dict_from_flax


def irfft2(spec: torch.Tensor, s: Tuple[int, int], dim=(-2, -1),
           norm: str = "backward") -> torch.Tensor:
    """``np.fft.irfft2(spec, s, axes=dim, norm=norm)`` for any spectrum: a
    complex inverse FFT over ``dim[0]``, the imaginary parts of the
    real-valued columns (W=0, and W=W/2 for an even W) dropped, then an
    inverse real FFT over ``dim[1]``."""
    hdim, wdim = dim
    y = torch.fft.ifft(spec, n=s[0], dim=hdim, norm=norm)
    im = y.imag
    wf = im.shape[wdim]
    last = wf - 1 if s[1] % 2 == 0 else wf
    parts = [torch.zeros_like(im.narrow(wdim, 0, 1)),
             im.narrow(wdim, 1, last - 1)]
    if last < wf:
        parts.append(torch.zeros_like(im.narrow(wdim, last, 1)))
    y = torch.complex(y.real, torch.cat(parts, dim=wdim))
    return torch.fft.irfft(y, n=s[1], dim=wdim, norm=norm)


def _conv1x1(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1)


# ----------------------------------------------------------------- primitives
class Block(nn.Module):
    """conv(k) + GroupNorm + SiLU on (N, C, H, W)."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 kernel_size: int = 3, padding_mode: str = "zeros"):
        super().__init__()
        self.pad = kernel_size // 2
        self.circular = padding_mode == "circular" and self.pad > 0
        self.proj = nn.Conv2d(dim_in, dim_out, kernel_size,
                              padding=0 if self.circular else self.pad)
        self.norm = group_norm(dim_out, min(groups, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.circular:
            x = F.pad(x, (self.pad,) * 4, mode="circular")
        return F.silu(self.norm(self.proj(x)))


class ResnetBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 kernel_size: int = 3, padding_mode: str = "zeros"):
        super().__init__()
        self.block1 = Block(dim_in, dim_out, groups, kernel_size, padding_mode)
        self.block2 = Block(dim_out, dim_out, groups, kernel_size,
                            padding_mode)
        self.res_conv = _conv1x1(dim_in, dim_out) if dim_in != dim_out \
            else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block2(self.block1(x))
        return h + (x if self.res_conv is None else self.res_conv(x))


class TimeMLP(nn.Module):
    """Linear-SELU-Linear over the trailing time axis."""

    def __init__(self, t_in: int, t_out: int, size_factor: float = 1.0):
        super().__init__()
        hidden = int(t_out * size_factor)
        self.fc1 = nn.Linear(t_in, hidden)
        self.fc2 = nn.Linear(hidden, t_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.selu(self.fc1(x)))


def _time_last(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C, H, W) -> (B, C, H, W, T)."""
    return x.permute(0, 2, 3, 4, 1)


def _time_second(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W, T) -> (B, T, C, H, W)."""
    return x.permute(0, 4, 1, 2, 3)


# ----------------------------------------------------------------- amplitude
class AmpTimeCell(nn.Module):
    def __init__(self, t_in: int, t_out: int, size_factor: int = 1):
        super().__init__()
        t_mid = t_out * size_factor
        self.w1 = nn.Parameter(torch.empty(2, t_in, t_mid))
        self.b1 = nn.Parameter(torch.empty(2, 1, 1, 1, t_mid))
        self.w2 = nn.Parameter(torch.empty(2, t_mid, t_out))
        self.b2 = nn.Parameter(torch.empty(2, 1, 1, 1, t_out))
        self.tmlp = TimeMLP(t_in, t_out, size_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T_in, C, H, W) -> (B, T_out, C, H, W)."""
        hw = tuple(x.shape[-2:])
        xt = _time_last(x)                                   # (B, C, H, W, T)
        bias = self.tmlp(xt)
        xf = torch.fft.rfft2(xt, dim=(2, 3), norm="ortho")

        def cmix(re, im, w, b):
            return (re @ w[0] - im @ w[1] + b[0],
                    re @ w[1] + im @ w[0] + b[1])

        r, i = cmix(xf.real, xf.imag, self.w1, self.b1)
        r, i = cmix(F.relu(r), F.relu(i), self.w2, self.b2)
        xt = irfft2(torch.complex(r, i), hw, dim=(2, 3), norm="ortho")
        return _time_second(xt + bias)


class AmpCell(nn.Module):
    def __init__(self, t_in: int, t_out: int, dim: int,
                 size_factor: float = 1.0):
        super().__init__()
        ch = t_out * dim
        self.tmlp = TimeMLP(t_in, t_out, size_factor)
        self.amptime = AmpTimeCell(t_in, t_out)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)
        self.norm = group_norm(ch, 4)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = _time_second(self.tmlp(_time_last(x)))
        x = self.amptime(x) + residual
        b, t, c, h, w = x.shape
        flat = x.reshape(b, t * c, h, w)
        flat = self.conv2(F.silu(self.norm(self.conv1(flat))))
        return flat.reshape(b, t, c, h, w) + x


class AmpliNet(nn.Module):
    def __init__(self, pre_seq_length: int, aft_seq_length: int, dim: int,
                 hidden_dim: int, n_layers: int = 3, mlp_ratio: float = 2.0):
        super().__init__()
        self.aft, self.dim, self.hidden = aft_seq_length, dim, hidden_dim
        self.n_layers = n_layers
        self.convin_0 = ResnetBlock(dim, hidden_dim)
        self.convin_1 = ResnetBlock(hidden_dim, hidden_dim)
        self.convin_2 = _conv1x1(hidden_dim, hidden_dim)
        self.tmlp = TimeMLP(pre_seq_length, aft_seq_length, mlp_ratio)
        for i in range(n_layers):
            t_in = pre_seq_length if i == 0 else aft_seq_length
            self.add_module(f"amp_{i}", AmpCell(t_in, aft_seq_length,
                                                hidden_dim))
        self.convout_0 = ResnetBlock(hidden_dim, hidden_dim)
        self.convout_1 = ResnetBlock(hidden_dim, hidden_dim)
        self.convout_2 = _conv1x1(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        hw = tuple(x.shape[3:])
        frames = x.reshape((b * t,) + tuple(x.shape[2:]))
        frames = self.convin_2(self.convin_1(self.convin_0(frames)))
        x = frames.reshape(b, t, self.hidden, *hw)
        xr = _time_second(self.tmlp(_time_last(x)))   # (B, T_out, hid, H, W)
        for i in range(self.n_layers):
            x = getattr(self, f"amp_{i}")(x)
        x = x + xr
        out = x.reshape((b * self.aft, self.hidden) + hw)
        out = self.convout_2(self.convout_1(self.convout_0(out)))
        return out.reshape(b, self.aft, self.dim, *hw)


# ----------------------------------------------------------------- phase
class PhaseNet(nn.Module):
    def __init__(self, input_shape: Tuple[int, int], pre_seq_length: int,
                 aft_seq_length: int, input_dim: int, hidden_dim: int):
        super().__init__()
        self.aft, self.input_dim = aft_seq_length, input_dim
        h, w = input_shape
        cin = pre_seq_length * input_dim + 2
        out_ch = input_dim * aft_seq_length
        uu, vv = torch.meshgrid(torch.fft.fftfreq(h), torch.fft.rfftfreq(w),
                                indexing="ij")
        self.register_buffer("uv", torch.stack([uu, vv])[None],
                             persistent=False)            # (1, 2, H, W_f)
        self.pha_conv0 = _conv1x1(cin, out_ch)
        for name, k, mode in (("phase_0", 1, "zeros"), ("phase_1", 1, "zeros"),
                              ("phase_2", 3, "circular")):
            self.add_module(f"{name}_0", ResnetBlock(cin, hidden_dim,
                                                     kernel_size=k,
                                                     padding_mode=mode))
            self.add_module(f"{name}_1", ResnetBlock(hidden_dim, hidden_dim,
                                                     kernel_size=k,
                                                     padding_mode=mode))
            self.add_module(f"{name}_2", _conv1x1(hidden_dim, out_ch))
        self.pha_conv1 = _conv1x1(4 * out_ch, out_ch)

    def _branch(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"{name}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor):
        b, t, c, h, w = x.shape
        x_fft = torch.fft.rfft2(x)                          # over (H, W)
        x_amps = torch.abs(x_fft)
        x_phas = torch.angle(x_fft) / math.pi               # pha_norm
        wf = x_phas.shape[-1]
        uv = self.uv.expand(b, 2, h, wf)
        x_puv = torch.cat([x_phas.reshape(b, t * c, h, wf), uv], dim=1)
        x_phast = self.pha_conv0(x_puv)
        x0 = x_phast + self._branch("phase_0", x_puv)
        x1 = x_phast * self._branch("phase_1", x_puv)
        x2 = x_phast * self._branch("phase_2", x_puv)
        pha_t = self.pha_conv1(torch.cat([x_phast, x0, x1, x2], dim=1))
        pha_t = pha_t.reshape(b, self.aft, self.input_dim, h, wf)
        pha_t = (x_phas[:, -1:] + pha_t) * math.pi           # pha_unnorm
        xt_fft = x_amps[:, -1:] * torch.exp(1j * pha_t)
        return irfft2(xt_fft, (h, w)), pha_t, x_amps


# ----------------------------------------------------------------- mixer
def make_spec_mask(h: int, w: int, spec_num: int) -> torch.Tensor:
    """Low-frequency mask over the rfft2 grid, (H, W//2 + 1)."""
    mask = np.zeros((h, w // 2 + 1), dtype=np.float32)
    mask[:spec_num, :spec_num] = 1.0
    mask[-spec_num:, :spec_num] = 1.0
    return torch.from_numpy(mask)


class AlphaMixer(nn.Module):
    def __init__(self, input_shape: Tuple[int, int], spec_num: int,
                 input_dim: int, hidden_dim: int, aft_seq_length: int):
        super().__init__()
        self.input_shape, self.input_dim = tuple(input_shape), input_dim
        mask = make_spec_mask(*self.input_shape, spec_num)
        self.register_buffer("spec_mask", mask, persistent=False)
        self.spec_count = float(mask.sum())     # host number: no device sync
        self.mix_0 = ResnetBlock(3 * input_dim, hidden_dim)
        self.mix_1 = ResnetBlock(hidden_dim, hidden_dim)
        self.mix_2 = _conv1x1(hidden_dim, input_dim)

    def forward(self, xas, xps, phas):
        h, w = self.input_shape
        amps = torch.abs(torch.fft.rfft2(xas))
        alpha = irfft2(amps * self.spec_mask * torch.exp(1j * phas), (h, w))
        xap = torch.cat([xas, xps, alpha], dim=2)           # channel axis
        b, t = xap.shape[:2]
        flat = xap.reshape((b * t,) + tuple(xap.shape[2:]))
        flat = self.mix_2(self.mix_1(self.mix_0(flat)))
        return flat.reshape(b, t, self.input_dim, h, w)


# ----------------------------------------------------------------- full model
class AlphaPre(nn.Module):
    def __init__(self, pre_seq_length: int, aft_seq_length: int,
                 input_shape: Tuple[int, int], input_dim: int,
                 hidden_dim: int, n_layers: int = 3, spec_num: int = 20,
                 pha_weight: float = 0.01, anet_weight: float = 0.1,
                 amp_weight: float = 0.01, aweight_stop_steps: int = 10000, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.aft, self.input_dim = aft_seq_length, input_dim
        self.input_shape = tuple(input_shape)
        self.pha_weight, self.anet_weight = pha_weight, anet_weight
        self.amp_weight = amp_weight
        self.aweight_stop_steps = aweight_stop_steps
        self.amplinet = AmpliNet(pre_seq_length, aft_seq_length, input_dim,
                                 hidden_dim, n_layers)
        self.phasenet = PhaseNet(self.input_shape, pre_seq_length,
                                 aft_seq_length, input_dim, hidden_dim)
        self.alphamixer = AlphaMixer(self.input_shape, spec_num, input_dim,
                                     hidden_dim, aft_seq_length)
        rng = np.random.default_rng(seed)
        init_flax_defaults(self, rng)
        for m in self.modules():
            if isinstance(m, AmpTimeCell):
                for p in (m.w1, m.b1, m.w2, m.b2):
                    normal_(p, rng, 0.02)
        self.to(device)

    def forward(self, x: torch.Tensor):
        xas = torch.sigmoid(self.amplinet(x))
        xps, x_phas_t, x_amps = self.phasenet(x)
        xt = self.alphamixer(xas, xps, x_phas_t)
        return xt, xps, xas, x_phas_t, x_amps

    def amp_weight_at(self, step: Union[int, torch.Tensor]) -> torch.Tensor:
        """The amplitude-loss weight at ``step``: amp_weight decaying
        linearly to 0 over aweight_stop_steps, in fp32 as in JAX."""
        frac = torch.as_tensor(step, dtype=torch.float32) / \
            self.aweight_stop_steps
        return torch.clamp(self.amp_weight * (1.0 - frac), min=0.0)

    def predict(self, frames_in: torch.Tensor,
                frames_gt: Optional[torch.Tensor] = None,
                compute_loss: bool = False,
                step: Union[int, torch.Tensor, None] = None):
        """(pred, loss dict | None)."""
        xt, xps, xas, x_phas_t, x_amps = self(frames_in)
        if not compute_loss:
            return xt, None
        b = frames_in.shape[0]
        mask = self.alphamixer.spec_mask
        amp_w = self.amp_weight_at(0 if step is None else step)
        mse = torch.mean((xt - frames_gt) ** 2)
        frames_fft = torch.fft.rfft2(frames_gt)
        frames_pha = torch.angle(frames_fft)
        pha_loss = torch.sum(1.0 - torch.cos(frames_pha * mask - x_phas_t * mask)
                             ) / (self.alphamixer.spec_count * b * self.aft
                                  * self.input_dim)
        xas_abs = torch.abs(torch.fft.rfft2(xas))
        amp_loss = torch.mean((xas_abs - torch.abs(frames_fft)) ** 2)
        anet_loss = torch.mean((xas - frames_gt) ** 2)
        total = (mse + self.pha_weight * pha_loss + amp_w * amp_loss
                 + self.anet_weight * anet_loss)
        return xt, {"total_loss": total,
                    "phase_loss": self.pha_weight * pha_loss,
                    "ampli_loss": amp_w * amp_loss,
                    "anet_loss": self.anet_weight * anet_loss}


def get_model(cfg, *, device: DeviceLike = None, seed: int = 0) -> AlphaPre:
    """Config factory (the JAX ``get_model``)."""
    return AlphaPre(
        pre_seq_length=cfg.T_in, aft_seq_length=cfg.T_out,
        input_shape=tuple(cfg.input_shape), input_dim=cfg.img_channels,
        hidden_dim=cfg.dim, n_layers=cfg.n_layers,
        spec_num=cfg.get("spec_num", 20),
        pha_weight=cfg.get("pha_weight", 0.01),
        anet_weight=cfg.get("anet_weight", 0.1),
        amp_weight=cfg.get("amp_weight", 0.01),
        aweight_stop_steps=cfg.get("aweight_stop_steps", 10000),
        device=device, seed=seed)


def alphapre_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``AlphaPre`` variables ``{'params': ...}`` (numpy arrays) -> this
    module's state dict, for ``load_state_dict(strict=True)``. The port's
    modules carry the flax names (``convin_0``, ``amp_1.amptime``,
    ``phase_2_0.block1.proj``); the complex-mixing weights keep their
    shapes."""
    return transformer_state_dict_from_flax(params)
