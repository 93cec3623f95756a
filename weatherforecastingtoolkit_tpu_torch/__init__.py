"""weatherforecastingtoolkit_tpu_torch — the PyTorch/CUDA port of
weatherforecastingtoolkit_tpu for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths and
names so each module's counterpart is easy to find. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, and raise when no GPU is
present and the CPU was not asked for.

This slice ports the Path-B serving rollout: the frozen ``AutoencoderKL``
(its GroupNorm+SiLU a hand-written Hopper kernel, ``ops/cuda/groupnorm.py``),
``DLinear``, and the one-shot, autoregressive and streaming pipelines.
"""

__version__ = "0.1.0"

# Lazy top-level aliases (PEP 562), the counterpart of
# weatherforecastingtoolkit_tpu/__init__.py, listing what the port has.
_LAZY = {
    "AutoencoderKL": ".models.vae.autoencoder_kl",
    "DLinear": ".models.forecasters",
    "make_forecast_pipeline": ".models.rollout",
    "make_streaming_forecaster": ".models.rollout",
    "persistence_baseline": ".models.rollout",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name], __name__)
        value = getattr(module, name)
        globals()[name] = value  # cache: next access skips __getattr__
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
