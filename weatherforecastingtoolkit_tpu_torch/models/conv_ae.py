"""Position-aware convolutional autoencoders with a flat bottleneck latent
(counterpart of weatherforecastingtoolkit_tpu/models/conv_ae.py).

  * ``PosAwareAE``: 4 stride-2 ``EncBlock``s (1 -> 256 -> 512 -> 1024 -> 1024
    channels) to an 8x8 map, a 1x1 conv to ``latent_channels``, a learned
    8x8 positional embedding, a Linear to a flat ``latent_dim`` vector; the
    mirrored transposed-conv decoder with a sigmoid head.
  * ``PosAwareAETF``: the same with an 8-layer transformer over the 64
    latent tokens in the decoder (``TransformerEncoder``, dropout 0.1 when
    ``deterministic=False``; it draws from torch's global generator, not
    from JAX's, so only deterministic calls compare across the packages).

Contract, NCHW as in JAX: ``encode(x) -> (B, latent_dim)``, ``decode(z) ->
(B, C, H, W)``, ``forward(x) -> (recon, z)``. The flat latent keeps the
NCHW ``flatten(1)`` order of the reference, and ``pos_emb`` keeps flax's
(1, hw, hw, C) shape. ``remat=True`` recomputes each Enc/DecBlock in the
backward (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
activations, as ``nn.remat`` does in JAX. Weights are made from ``seed``
with flax's initializers; ``pos_aware_ae_state_dict_from_flax`` carries the
JAX package's params across.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .common import (DecBlock, EncBlock, init_flax_defaults, lecun_normal_,
                     run_blocks)
from .transformer import TransformerEncoder, transformer_state_dict_from_flax


class PosAwareAE(nn.Module):
    def __init__(self, in_channels: int = 1, latent_channels: int = 64,
                 groups: int = 8, latent_dim: int = 2048,
                 enc_channels: Sequence[int] = (256, 512, 1024, 1024),
                 dec_channels: Sequence[int] = (1024, 1024, 512, 256, 128),
                 num_blocks: int = 4, latent_hw: int = 8,
                 decoder_tf_depth: int = 0, tf_heads: int = 8,
                 tf_ffn: int = 2048, remat: bool = False, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        hw, lc = latent_hw, latent_channels
        self.in_channels, self.latent_hw = in_channels, latent_hw
        self.latent_channels, self.latent_dim = latent_channels, latent_dim
        self.enc_channels = tuple(enc_channels)
        self.decoder_tf_depth, self.remat = decoder_tf_depth, remat
        enc_in = (in_channels,) + self.enc_channels[:-1]
        self.enc_blocks = nn.ModuleList(
            EncBlock(i, c, num_blocks, groups)
            for i, c in zip(enc_in, self.enc_channels))
        self.enc_out = nn.Conv2d(self.enc_channels[-1], lc, 1)
        self.pos_emb = nn.Parameter(torch.empty(1, hw, hw, lc))
        self.to_latent = nn.Linear(hw * hw * lc, latent_dim)
        self.from_latent = nn.Linear(latent_dim, hw * hw * lc)
        if decoder_tf_depth > 0:
            self.latent_tf = TransformerEncoder(depth=decoder_tf_depth,
                                                dim=lc, num_heads=tf_heads,
                                                ffn_dim=tf_ffn, dropout=0.1)
        dec = tuple(dec_channels)
        self.dec_in = nn.Conv2d(lc, dec[0], 1)
        self.dec_blocks = nn.ModuleList(
            DecBlock(i, c, num_blocks, groups) for i, c in zip(dec, dec[1:]))
        self.dec_out = nn.Conv2d(dec[-1], in_channels, 3, padding=1)
        self._init_weights(np.random.default_rng(seed))
        self.to(device)

    @torch.no_grad()
    def _init_weights(self, rng: np.random.Generator) -> None:
        init_flax_defaults(self, rng)
        for m in self.modules():
            if isinstance(m, nn.ConvTranspose2d):  # flax (kh, kw, in, out)
                w = m.weight
                lecun_normal_(w, rng, fan_in=w[:, 0].numel())
        self.pos_emb.copy_(torch.from_numpy(
            rng.standard_normal(self.pos_emb.shape)))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, latent_dim)."""
        h = self.enc_out(run_blocks(self.enc_blocks, x, self.remat))
        h = h + self.pos_emb.permute(0, 3, 1, 2)
        return self.to_latent(h.reshape(h.shape[0], -1))

    def decode(self, z: torch.Tensor, deterministic: bool = True
               ) -> torch.Tensor:
        """(B, latent_dim) -> (B, C, H, W), sigmoid-bounded."""
        b, hw, lc = z.shape[0], self.latent_hw, self.latent_channels
        h = self.from_latent(z).reshape(b, lc, hw, hw)
        if self.decoder_tf_depth > 0:
            tokens = h.permute(0, 2, 3, 1).reshape(b, hw * hw, lc)
            tokens = self.latent_tf(tokens, deterministic=deterministic)
            h = tokens.reshape(b, hw, hw, lc).permute(0, 3, 1, 2)
        h = run_blocks(self.dec_blocks, self.dec_in(h), self.remat)
        return torch.sigmoid(self.dec_out(h))

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return self.decode(z, deterministic=deterministic), z


def PosAwareAETF(**kwargs) -> PosAwareAE:
    """The ``_tf`` variant: an 8-layer transformer over the 64 latent tokens
    in the decoder."""
    kwargs.setdefault("decoder_tf_depth", 8)
    return PosAwareAE(**kwargs)


# --------------------------------------------------------------------------
# JAX-package params -> port state dict
# --------------------------------------------------------------------------
def _block_segment(name: str, in_bottleneck: bool) -> str:
    """flax auto-names inside an Enc/DecBlock -> the port's names."""
    m = re.fullmatch(r"(Conv|ConvTranspose|GroupNorm|Bottleneck)_(\d+)", name)
    if m is None:
        raise KeyError(name)
    kind, i = m.groups()
    if kind == "Bottleneck":
        return f"blocks.{i}"
    if in_bottleneck:
        return ("conv" if kind == "Conv" else "norm") + i
    return "conv" if kind.startswith("Conv") else "norm"


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def pos_aware_ae_state_dict_from_flax(params: dict) -> Dict[str, torch.Tensor]:
    """JAX ``PosAwareAE`` variables ``{'params': ...}`` (numpy arrays) ->
    this module's state dict, for ``load_state_dict(strict=True)``. Conv
    kernels HWIO -> OIHW (grouped ones too: (3, 3, in/g, out)); the
    transposed convs' (kh, kw, in, out) -> (in, out, kh, kw) flipped in both
    spatial axes; Dense kernels transposed; GroupNorm scale -> weight."""
    tree = params["params"] if "params" in params else params
    out, tf = {}, {}
    for path, v in _flatten(tree).items():
        if path[0] == "latent_tf":
            tf[path[1:]] = v
            continue
        *mods, leaf = path
        v = np.asarray(v, dtype=np.float32)
        if not mods:                      # pos_emb, kept in flax's shape
            out[leaf] = torch.from_numpy(np.array(v, np.float32, order="C"))
            continue
        top = re.sub(r"_(\d+)$", r".\1", mods[0])
        segs = [top]
        for j, m in enumerate(mods[1:]):
            segs.append(_block_segment(m, in_bottleneck=j > 0))
        if leaf == "kernel" and mods[-1].startswith("ConvTranspose"):
            v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
        elif leaf == "kernel" and v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif leaf == "kernel":
            v = v.T
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        out[".".join(segs + [name])] = torch.from_numpy(
            np.array(v, np.float32, order="C"))
    if tf:
        nested: dict = {}
        for path, v in tf.items():
            node = nested
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        out.update({f"latent_tf.{k}": v for k, v in
                    transformer_state_dict_from_flax(nested).items()})
    return out
