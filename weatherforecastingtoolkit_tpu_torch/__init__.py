"""weatherforecastingtoolkit_tpu_torch — the PyTorch/CUDA port of
weatherforecastingtoolkit_tpu for one NVIDIA H100.

The JAX package stays the reference; this package keeps its module paths and
names so each module's counterpart is easy to find. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``, and raise when no GPU is
present and the CPU was not asked for.

Ported so far:
  * the Path-B serving rollout: the frozen ``AutoencoderKL`` (its
    GroupNorm+SiLU a hand-written Hopper kernel, ``ops/cuda/groupnorm.py``),
    the forecasters (``DLinear``, ``LinearForecaster``, ``PerPixelLinear``,
    ``TimeMLP``), and the one-shot, autoregressive, streaming and ensemble
    pipelines;
  * quantized serving (``ops/quant.py``: ``QConv`` in all five conv modes
    and mixed per-layer specs, calibration), its int8 convs a hand-written
    Hopper int8 tensor-core kernel (``ops/cuda/int8_conv.py``);
  * verification: ``metrics.calc_metrics`` (CSI/HSS/CRPS/SSIM/PSNR and the
    ``paper_*`` aggregates) and the evaluation protocol (``evaluation.py``);
  * the training harness (``training/``: ``Trainer`` with metric
    validation, optimizer and schedules, checkpoints, logging,
    ``reconstruction_task``, ``latent_forecast_task``), ``Config``, the
    transformer blocks and ``Earthformer``, and the advection-diffusion
    prior (``ops/stencil.py``, its forward a hand-written Hopper kernel,
    ``ops/cuda/stencil.py``);
  * GAN training: ``PosAwareAE``/``PosAwareAETF``, the PatchGAN
    discriminator and its losses, LPIPS (``models/losses/``), bf16 mixed
    precision (``ops/amp.py``) and the two-optimizer VAE-GAN task
    (``training/gan.py::make_vae_gan_task``), which trains the
    ``AutoencoderKL`` with its GroupNorm kernel forward and backward;
  * the rest of the model zoo and its registry (``models/registry.py``,
    the JAX package's 17 names): ``CustomAutoencoderKL`` (its GroupNorms
    the Hopper kernel), ``ViTAE`` and the token forecasters, the latent,
    Path-A and legacy autoencoders, and ``AlphaPre`` (``torch.fft``),
    trained with the stencil kernel's prior
    (``experiments_gpu/alphapre/train.py``);
  * the SEVIR data layer (``data/``: catalog, windows, HDF5 and packed-cache
    datasets, ``SEVIRDataModule``, preflight, download; numpy on the host,
    no pandas, h5py only where HDF5 is read or written), profiling hooks,
    and the training command line (``experiments_gpu/common.py``);
  * the distributed layer (``parallel/``: the process group and mesh, data
    parallelism, FSDP, tensor-parallel dense layers, dp-sharded and
    member-parallel serving, ``torch.export`` of the pipeline) and
    ``Trainer(mesh=...)`` with ``trainer.fsdp``.
"""

__version__ = "0.1.0"

# Lazy top-level aliases (PEP 562), the counterpart of
# weatherforecastingtoolkit_tpu/__init__.py, listing what the port has.
_LAZY = {
    "calc_metrics": ".metrics",
    "Config": ".utils.config",
    "PosAwareAE": ".models.conv_ae",
    "AutoencoderKL": ".models.vae.autoencoder_kl",
    "CustomAutoencoderKL": ".models.vae.custom_akl",
    "ViTAE": ".models.vit_ae",
    "DLinear": ".models.forecasters",
    "Earthformer": ".models.earthformer",
    "AlphaPre": ".models.alphapre",
    "make_forecast_pipeline": ".models.rollout",
    "make_ensemble_pipeline": ".models.rollout",
    "make_streaming_forecaster": ".models.rollout",
    "persistence_baseline": ".models.rollout",
    "Trainer": ".training.trainer",
    "reconstruction_task": ".training.tasks",
    "latent_forecast_task": ".training.tasks",
    "make_vae_gan_task": ".training.gan",
    "CheckpointManager": ".training.checkpoint",
    "build_optimizer": ".training.trainer",
    "evaluate_protocol": ".evaluation",
    "EvalReport": ".evaluation",
    "SEVIRDataModule": ".data.datamodule",
    "SEVIRDataset": ".data.dataset",
    "make_mesh": ".parallel.mesh",
    "make_dp_serving_fn": ".parallel.serving",
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
