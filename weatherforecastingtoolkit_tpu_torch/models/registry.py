"""Model registry: name -> constructor (counterpart of
weatherforecastingtoolkit_tpu/models/registry.py), with the same 17 names.

``build_model(name, **kwargs)`` turns list arguments (YAML lists) into
tuples, as JAX does, and calls the port's constructor; pass ``device`` and
``seed`` as for any port model.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def build_model(name: str, **kwargs):
    if name not in _REGISTRY:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(_REGISTRY)}")
    kwargs = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kwargs.items()}
    return _REGISTRY[name](**kwargs)


def available_models():
    return sorted(_REGISTRY)


def _populate():
    from .alphapre import AlphaPre
    from .conv_ae import PosAwareAE, PosAwareAETF
    from .earthformer import Earthformer
    from .forecasters import DLinear, LinearForecaster, PerPixelLinear, TimeMLP
    from .latent_ae import ConvAttnModel, ConvModel
    from .legacy import StructuredConvAE
    from .path_a import AttentionChargedAutoencoder, ConvAutoencoder
    from .token_forecaster import TokenSequenceForecaster
    from .vae.autoencoder_kl import AutoencoderKL
    from .vae.custom_akl import CustomAutoencoderKL
    from .vit_ae import ViTAE

    entries = {
        # frame autoencoders
        "pos_aware_ae": PosAwareAE,
        "pos_aware_ae_tf": PosAwareAETF,
        "vit_ae": ViTAE,
        "autoencoder_kl": AutoencoderKL,
        "custom_autoencoder_kl": CustomAutoencoderKL,
        "structured_conv_ae": StructuredConvAE,
        "conv_autoencoder": ConvAutoencoder,
        "attention_charged_ae": AttentionChargedAutoencoder,
        # latent-space second-stage AEs
        "latent_conv_model": ConvModel,
        "latent_conv_attn": ConvAttnModel,
        # latent forecasters
        "dlinear": DLinear,
        "linear_forecaster": LinearForecaster,
        "per_pixel_linear": PerPixelLinear,
        "time_mlp": TimeMLP,
        # spatio-temporal backbones
        "earthformer": Earthformer,
        "token_sequence_forecaster": TokenSequenceForecaster,
        # physics/spectral
        "alphapre": AlphaPre,
    }
    for k, v in entries.items():
        _REGISTRY.setdefault(k, v)


_populate()
