"""Plain float32 reference of the Path-B rollout, written from the
architecture: the diffusers-style AutoencoderKL (encode to the posterior
mean, decode), the residual anchor on the last input latent, DLinear over
the latent window, and both geometries (plain 128x128 input, and the
``pixel_unshuffle`` stem that packs f x f pixels into channels).

It imports torch alone: nothing of the program under test and nothing of
JAX. Parameters are a flat dict of float32 tensors named as the program's
``state_dict`` names them (``param_spec`` lists them), so the benchmark can
draw one set of weights and hand it to both sides. Every conv weight is
(out, in, kh, kw), every linear weight (out, in), activations NCHW.

Layer equations:
  resnet(x)    = shortcut(x) + conv2(gn_silu(conv1(gn_silu(x))))
  attention(x) = x + proj(softmax(q k^T / sqrt(C)) v), q, k, v linear maps
                 of gn(x) over the h*w positions (one head, eps 1e-5)
  encoder      = conv_in, per block: resnets then a stride-2 3x3 conv on
                 the input padded by one row and column at the far edges
                 (not after the last block), mid (resnet, attention,
                 resnet), gn_silu, conv_out to 2L channels, 1x1 quant_conv;
                 the posterior mean is the first L channels
  decoder      = 1x1 post_quant_conv, conv_in, mid, per block (channels
                 reversed): layers_per_block + 1 resnets then a 2x nearest
                 upsample and a 3x3 conv (not after the last block),
                 gn_silu, conv_out
  GroupNorm    = min(groups, C) groups, eps 1e-6 (1e-5 in attention)
  DLinear      = seasonal / trend split by a replicate-padded moving
                 average of ``kernel_size`` along time, a linear map of
                 each over time, summed
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Spec = List[Tuple[str, Tuple[int, ...], str]]


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------
def _conv_spec(name: str, cout: int, cin: int, k: int) -> Spec:
    return [(f"{name}.weight", (cout, cin, k, k), "conv"),
            (f"{name}.bias", (cout,), "bias")]


def _norm_spec(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "norm_weight"),
            (f"{name}.bias", (c,), "norm_bias")]


def _resnet_spec(pre: str, cin: int, cout: int) -> Spec:
    spec = (_norm_spec(f"{pre}.norm1", cin) + _conv_spec(f"{pre}.conv1", cout, cin, 3)
            + _norm_spec(f"{pre}.norm2", cout) + _conv_spec(f"{pre}.conv2", cout, cout, 3))
    if cin != cout:
        spec += _conv_spec(f"{pre}.conv_shortcut", cout, cin, 1)
    return spec


def _mid_spec(pre: str, c: int) -> Spec:
    spec = _resnet_spec(f"{pre}.resnets.0", c, c) + _resnet_spec(f"{pre}.resnets.1", c, c)
    spec += _norm_spec(f"{pre}.attentions.0.group_norm", c)
    for lin in ("query", "key", "value", "proj_attn"):
        spec += [(f"{pre}.attentions.0.{lin}.weight", (c, c), "linear"),
                 (f"{pre}.attentions.0.{lin}.bias", (c,), "bias")]
    return spec


def param_spec(vae: dict) -> Spec:
    """(name, shape, kind) of every VAE parameter; kind is conv, linear,
    bias, norm_weight or norm_bias."""
    boc = list(vae["block_out_channels"])
    n, lpb, lat = len(boc), vae["layers_per_block"], vae["latent_channels"]
    f = vae.get("pixel_unshuffle", 1)
    spec = _conv_spec("encoder.conv_in", boc[0], vae["in_channels"] * f * f, 3)
    for i, ch in enumerate(boc):
        cin = boc[max(i - 1, 0)]
        for j in range(lpb):
            spec += _resnet_spec(f"encoder.down_blocks.{i}.resnets.{j}",
                                 cin if j == 0 else ch, ch)
        if i != n - 1:
            spec += _conv_spec(f"encoder.down_blocks.{i}.downsamplers.0.conv", ch, ch, 3)
    spec += _mid_spec("encoder.mid_block", boc[-1])
    spec += _norm_spec("encoder.conv_norm_out", boc[-1])
    spec += _conv_spec("encoder.conv_out", 2 * lat, boc[-1], 3)
    rev = boc[::-1]
    spec += _conv_spec("decoder.conv_in", rev[0], lat, 3)
    spec += _mid_spec("decoder.mid_block", rev[0])
    for i, ch in enumerate(rev):
        cin = rev[max(i - 1, 0)]
        for j in range(lpb + 1):
            spec += _resnet_spec(f"decoder.up_blocks.{i}.resnets.{j}",
                                 cin if j == 0 else ch, ch)
        if i != n - 1:
            spec += _conv_spec(f"decoder.up_blocks.{i}.upsamplers.0.conv", ch, ch, 3)
    spec += _norm_spec("decoder.conv_norm_out", rev[-1])
    spec += _conv_spec("decoder.conv_out", vae["out_channels"] * f * f, rev[-1], 3)
    spec += _conv_spec("quant_conv", 2 * lat, 2 * lat, 1)
    spec += _conv_spec("post_quant_conv", lat, lat, 1)
    return spec


def dlinear_spec(fc: dict) -> Spec:
    """(name, shape, kind) of DLinear's parameters (shared across channels)."""
    t_in, t_out = fc["seq_len"], fc["pred_len"]
    return [(f"{part}.{leaf}", shape, kind)
            for part in ("seasonal", "trend")
            for leaf, shape, kind in (("weight", (t_out, t_in), "time_weight"),
                                      ("bias", (t_out,), "time_bias"))]


def latent_hw(cfg: dict) -> int:
    vae = cfg["vae"]
    return cfg["frame_hw"] // (vae.get("pixel_unshuffle", 1)
                               * 2 ** (len(vae["block_out_channels"]) - 1))


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------
def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm with a per-channel affine, then SiLU when asked."""
    y = F.group_norm(x, groups, weight, bias, eps)
    return F.silu(y) if silu else y


class _VAE:
    def __init__(self, p: Dict[str, torch.Tensor], vae: dict):
        self.p = p
        self.groups = vae["norm_num_groups"]
        self.f = vae.get("pixel_unshuffle", 1)
        self.lat = vae["latent_channels"]
        self.n = len(vae["block_out_channels"])
        self.lpb = vae["layers_per_block"]

    def conv(self, name: str, x: torch.Tensor, stride: int = 1,
             pad: int = 1) -> torch.Tensor:
        return F.conv2d(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                        stride, pad)

    def gn(self, name: str, x: torch.Tensor, eps: float = 1e-6,
           silu: bool = True) -> torch.Tensor:
        return group_norm(x, self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                          min(self.groups, x.shape[1]), eps, silu)

    def resnet(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{pre}.conv1", self.gn(f"{pre}.norm1", x))
        h = self.conv(f"{pre}.conv2", self.gn(f"{pre}.norm2", h))
        if f"{pre}.conv_shortcut.weight" in self.p:
            x = self.conv(f"{pre}.conv_shortcut", x, pad=0)
        return x + h

    def attention(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        t = self.gn(f"{pre}.group_norm", x, eps=1e-5, silu=False)
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = (F.linear(t, self.p[f"{pre}.{n}.weight"], self.p[f"{pre}.{n}.bias"])
                   for n in ("query", "key", "value"))
        probs = torch.softmax(torch.matmul(q, k.transpose(1, 2)) / math.sqrt(c), dim=-1)
        out = F.linear(torch.matmul(probs, v), self.p[f"{pre}.proj_attn.weight"],
                       self.p[f"{pre}.proj_attn.bias"])
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def mid(self, pre: str, x: torch.Tensor) -> torch.Tensor:
        x = self.resnet(f"{pre}.resnets.0", x)
        x = self.attention(f"{pre}.attentions.0", x)
        return self.resnet(f"{pre}.resnets.1", x)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, H, W) -> posterior mean (N, L, h, w)."""
        if self.f > 1:
            x = space_to_depth(x, self.f)
        h = self.conv("encoder.conv_in", x)
        for i in range(self.n):
            for j in range(self.lpb):
                h = self.resnet(f"encoder.down_blocks.{i}.resnets.{j}", h)
            if i != self.n - 1:
                h = self.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                              F.pad(h, (0, 1, 0, 1)), stride=2, pad=0)
        h = self.mid("encoder.mid_block", h)
        h = self.conv("encoder.conv_out", self.gn("encoder.conv_norm_out", h))
        return self.conv("quant_conv", h, pad=0)[:, :self.lat]

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(N, L, h, w) -> frames (N, C, H, W)."""
        h = self.conv("decoder.conv_in", self.conv("post_quant_conv", z, pad=0))
        h = self.mid("decoder.mid_block", h)
        for i in range(self.n):
            for j in range(self.lpb + 1):
                h = self.resnet(f"decoder.up_blocks.{i}.resnets.{j}", h)
            if i != self.n - 1:
                h = self.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                              F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.conv("decoder.conv_out", self.gn("decoder.conv_norm_out", h))
        return depth_to_space(h, self.f) if self.f > 1 else h


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, f*f*C, H/f, W/f); channel (u*f + v)*C + c holds
    pixel (u, v) of each f x f cell."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // f, f, w // f, f)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, f * f * c, h // f, w // f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    """The inverse of ``space_to_depth``."""
    n, cff, h, w = x.shape
    c = cff // (f * f)
    x = x.reshape(n, f, f, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * f, w * f)


def dlinear(p: Dict[str, torch.Tensor], x: torch.Tensor,
            kernel_size: int) -> torch.Tensor:
    """(B, T_in, D) -> (B, T_out, D)."""
    pad = (kernel_size - 1) // 2
    xp = torch.cat([x[:, :1].expand(-1, pad, -1), x,
                    x[:, -1:].expand(-1, pad, -1)], dim=1)
    trend = xp.unfold(1, kernel_size, 1).mean(dim=-1)
    seasonal = x - trend
    s = torch.einsum("btd,ot->bod", seasonal, p["seasonal.weight"]) + p["seasonal.bias"][:, None]
    t = torch.einsum("btd,ot->bod", trend, p["trend.weight"]) + p["trend.bias"][:, None]
    return s + t


# --------------------------------------------------------------------------
# the rollout
# --------------------------------------------------------------------------
def frames_to_float(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 in [0, 1]."""
    return frames.to(torch.float32) / 255.0


@torch.no_grad()
def encode_window(vae_p: Dict[str, torch.Tensor], cfg: dict,
                  frames: torch.Tensor, block: int = 256) -> torch.Tensor:
    """uint8 frames (B, T, C, H, W) -> latent window (B, T, L*h*w), encoded
    ``block`` frames at a time."""
    vae = _VAE(vae_p, cfg["vae"])
    b, t = frames.shape[:2]
    flat = frames.reshape((b * t,) + tuple(frames.shape[2:]))
    z = torch.cat([vae.encode(frames_to_float(flat[i:i + block]))
                   for i in range(0, flat.shape[0], block)])
    return z.reshape(b, t, -1)


@torch.no_grad()
def forecast(vae_p: Dict[str, torch.Tensor], fc_p: Dict[str, torch.Tensor],
             cfg: dict, z: torch.Tensor, block: int = 256) -> torch.Tensor:
    """Latent window (B, T_in, D) -> forecast frames (B, T_out, C, H, W):
    the anchor subtracted, DLinear, the anchor added back, decoded ``block``
    frames at a time."""
    vae = _VAE(vae_p, cfg["vae"])
    b = z.shape[0]
    anchor = z[:, -1:] if cfg["residual_anchor"] else torch.zeros_like(z[:, -1:])
    zp = dlinear(fc_p, z - anchor, cfg["forecaster"]["kernel_size"]) + anchor
    t_out, lat, lhw = zp.shape[1], cfg["vae"]["latent_channels"], latent_hw(cfg)
    flat = zp.reshape(b * t_out, lat, lhw, lhw)
    out = torch.cat([vae.decode(flat[i:i + block])
                     for i in range(0, flat.shape[0], block)])
    return out.reshape((b, t_out) + tuple(out.shape[1:]))


def rollout(vae_p, fc_p, cfg: dict, frames: torch.Tensor,
            block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 frames (B, T_in, C, H, W) -> (forecast (B, T_out, C, H, W),
    latent window (B, T_in, D))."""
    z = encode_window(vae_p, cfg, frames, block)
    return forecast(vae_p, fc_p, cfg, z, block), z
