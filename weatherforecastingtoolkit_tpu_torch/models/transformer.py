"""Transformer blocks in PyTorch (counterpart of
weatherforecastingtoolkit_tpu/models/transformer.py).

Attention is written out with ``torch.matmul`` and a softmax at scale
1/sqrt(head_dim), as ``jax.nn.dot_product_attention`` computes it (softmax in
fp32); attention is a library op in the JAX package, not a Pallas kernel, so
no hand kernel is owed for it. LayerNorm has flax's eps of 1e-6 and GELU is
the tanh approximation (flax ``nn.gelu``). Dropout is active only when a
caller passes ``deterministic=False``, as in flax.

These are building blocks: the model that holds them draws their weights
with ``init_flax_defaults`` and places them on its device.
``transformer_state_dict_from_flax`` carries JAX-package params across.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import gelu, init_flax_defaults  # noqa: F401 (re-exported)


def layer_norm(dim: int) -> nn.LayerNorm:
    """flax ``nn.LayerNorm()``: eps 1e-6, learned scale and bias."""
    return nn.LayerNorm(dim, eps=1e-6)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """(B, Lq, H, hd), (B, Lk, H, hd), (B, Lk, H, hd) -> (B, Lq, H, hd), as
    ``jax.nn.dot_product_attention``: logits scaled after the product,
    softmax in fp32."""
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(weights, v).transpose(1, 2)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        hd = self.dim // self.num_heads
        q, k, v = (t.reshape(b, l, self.num_heads, hd)
                   for t in self.qkv(x).split(self.dim, dim=-1))
        out = dot_product_attention(q, k, v).reshape(b, l, self.dim)
        return self.proj(out)


class CrossAttention(nn.Module):
    """Queries attend to kv tokens: project kv into the query width, attend,
    output-project."""

    def __init__(self, q_dim: int, kv_dim: int, num_heads: int = 8):
        super().__init__()
        self.q_dim, self.num_heads = q_dim, num_heads
        self.q_proj = nn.Linear(q_dim, q_dim)
        self.kv_proj = nn.Linear(kv_dim, 2 * q_dim)
        self.out = nn.Linear(q_dim, q_dim)

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        b, lq, _ = q.shape
        hd = self.q_dim // self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], self.num_heads, hd)

        k, v = self.kv_proj(kv).split(self.q_dim, dim=-1)
        out = dot_product_attention(heads(self.q_proj(q)), heads(k), heads(v))
        return self.out(out.reshape(b, lq, self.q_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer: x = LN(x + MHA(x)); x = LN(x + FFN(x))."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, activation: Callable = gelu):
        super().__init__()
        self.dropout, self.activation = dropout, activation
        self.attn = SelfAttention(dim, num_heads)
        self.norm1 = layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)
        self.norm2 = layer_norm(dim)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        def drop(t):
            return F.dropout(t, self.dropout, training=not deterministic)

        x = self.norm1(x + drop(self.attn(x)))
        h = drop(self.activation(self.ffn1(x)))
        return self.norm2(x + drop(self.ffn2(h)))


class TransformerEncoder(nn.Module):
    def __init__(self, depth: int, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, activation: Callable = gelu):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(dim, num_heads, ffn_dim, dropout,
                                    activation) for _ in range(depth))

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, deterministic=deterministic)
        return x


class TransformerDecoderLayer(nn.Module):
    """Pre-LN decoder layer: self-attention over the queries, cross-attention
    to memory, FFN."""

    def __init__(self, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, activation: Callable = gelu,
                 memory_dim: Optional[int] = None):
        super().__init__()
        self.dropout, self.activation = dropout, activation
        self.norm1 = layer_norm(dim)
        self.self_attn = SelfAttention(dim, num_heads)
        self.norm2 = layer_norm(dim)
        self.cross_attn = CrossAttention(dim, memory_dim or dim, num_heads)
        self.norm3 = layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn_dim)
        self.ffn2 = nn.Linear(ffn_dim, dim)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        def drop(t):
            return F.dropout(t, self.dropout, training=not deterministic)

        tgt = tgt + drop(self.self_attn(self.norm1(tgt)))
        tgt = tgt + drop(self.cross_attn(self.norm2(tgt), memory))
        h = self.ffn2(self.activation(self.ffn1(self.norm3(tgt))))
        return tgt + drop(h)


class TransformerDecoder(nn.Module):
    """``memory_dim`` is the width of the memory tokens (flax reads it off
    the input; a torch layer needs it up front). Defaults to ``dim``."""

    def __init__(self, depth: int, dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, memory_dim: Optional[int] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(dim, num_heads, ffn_dim, dropout,
                                    memory_dim=memory_dim)
            for _ in range(depth))

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        for layer in self.layers:
            tgt = layer(tgt, memory, deterministic=deterministic)
        return tgt


# --------------------------------------------------------------------------
# flax-default init, and JAX-package params -> port state dict
# --------------------------------------------------------------------------
# flax auto-names (``LayerNorm_0``, ``Dense_1``, ...) -> the port's names.
_SEGMENTS = {"SelfAttention_0": "attn", "LayerNorm_0": "norm1",
             "LayerNorm_1": "norm2", "LayerNorm_2": "norm3",
             "Dense_0": "ffn1", "Dense_1": "ffn2"}
# flax list members ``<prefix>_<i>`` -> ``<list>.<i>``.
_LISTS = {"TransformerEncoderLayer": "layers",
          "TransformerDecoderLayer": "layers", "cuboid": "cuboid",
          "coarse": "coarse", "dec_cuboid": "dec_cuboid"}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _segment(name: str) -> str:
    if name in _SEGMENTS:
        return _SEGMENTS[name]
    m = re.fullmatch(r"(.+)_(\d+)", name)
    if m and m.group(1) in _LISTS:
        return f"{_LISTS[m.group(1)]}.{m.group(2)}"
    return name


def transformer_state_dict_from_flax(params: dict, conv_transpose: tuple = ()
                                     ) -> Dict[str, torch.Tensor]:
    """JAX-package variables ``{'params': ...}`` (numpy arrays) of a
    transformer model (``TransformerEncoder``/``Decoder``, ``Earthformer``)
    -> the port module's state dict, for ``load_state_dict(strict=True)``.

    Dense kernels (in, out) -> (out, in); Conv kernels HWIO -> OIHW; the
    flax ``ConvTranspose`` modules named in ``conv_transpose`` (kh, kw, in,
    out) -> torch's (in, out, kh, kw), flipped in both spatial axes
    (flax's ``transpose_kernel=False`` convention). Other leaves (position
    embeddings, queries) carry over as they are."""
    tree = params["params"] if "params" in params else params
    out = {}
    for path, v in _flatten(tree).items():
        *mods, leaf = path.split(".")
        v = np.asarray(v, dtype=np.float32)
        if leaf == "kernel" and mods[-1] in conv_transpose:
            v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
        elif leaf == "kernel" and v.ndim == 4:
            v = np.transpose(v, (3, 2, 0, 1))
        elif leaf == "kernel":
            v = v.T
        name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        key = ".".join([_segment(m) for m in mods] + [name])
        out[key] = torch.from_numpy(np.array(v, np.float32, order="C"))
    return out
