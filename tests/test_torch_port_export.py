"""The port's int8 serving pipelines through ``torch.export``
(parallel/serving.py::export_pipeline -> load_pipeline), on the CPU, held
to the JAX package's.

The int8 conv, its quantize pass and the GroupNorm are custom ops
(``wftk::int8_conv2d``, ``wftk::int8_quantize``, ``wftk::group_norm_silu``),
whose CPU implementations are the plain versions, so the programs trace
here as on the card. Each pipeline is ``experiments_gpu/perf/
bench_helpers.py::build_pipeline`` at 32x32 with a two-level VAE, exported
before its first eager call (tests/torch_port_export.py), in int8_static
and under INT8_MIXED_SPEC:

  * the eager call after the export gives the bits of a pipeline that was
    never exported (``QConv``'s weight cache held the trace's fake tensors
    before: every later eager call returned a tensor that could not be
    read);
  * the loaded program gives the eager bits at the export batch and at
    another batch, with the weight codes as constants (no weight
    quantization in the program), the weight side an eager pipeline
    caches;
  * the slice against the JAX package: the loaded programs against the JAX
    ``export_pipeline`` -> ``load_pipeline`` of ``bench.build_jax_pipeline``
    on the same weights and scales.

The weights are tests/test_torch_port_quant.py's numpy-drawn flax
variables and the scales the JAX calibration's (``bench.calibrate_qscales``),
so every test here needs JAX: it is imported inside the fixtures and tests.
tests/test_torch_port_export_int8.py exports the dynamic int8 mode without
JAX. On the card ``chip_smoke.py --dist`` (phase 28b) exports the int8
pipelines at full width.
"""

import contextlib

import numpy as np
import pytest
import torch

from torch_port_export import (HW, INT8_CONVS, KW, MODES, ExportedPipeline,
                               bh, frames as _frames, pipeline)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _flax_init(trees):
    """flax's ``Module.init`` returns trees[class name]: bench.py's JAX
    builders then run on the given variables."""
    import flax.linen as fnn

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Module, "init",
                   lambda self, *a, **k: trees[type(self).__name__])
        yield


@pytest.fixture(scope="module")
def weights():
    """The VAE's weights and scales as tests/test_torch_port_quant.py makes
    them (``_jax_vae_params``: numpy-drawn flax variables), calibrated by
    bench.calibrate_qscales (jitted) on the serving frames. Returns (flax
    params, the port's state dict, the port's scales, the JAX 'qscales'
    collection)."""
    import jax
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        state_dict_from_flax)
    from weatherforecastingtoolkit_tpu_torch.ops.quant import qscales_from_flax

    import bench
    from test_torch_port_quant import _jax_vae_params

    params = _jax_vae_params(JAKL(**bh.vae_config(KW)),
                             np.random.default_rng(1), hw=HW)
    with _flax_init({"AutoencoderKL": params}):
        jq = jax.device_get(bench.calibrate_qscales(_frames(2).numpy(),
                                                    vae_kwargs=KW))
    return (params, state_dict_from_flax(params), qscales_from_flax(jq), jq)


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """mode -> its ``ExportedPipeline`` on the JAX-made weights and scales,
    built once per mode."""
    _, state, qscales, _ = weights
    made = {}

    def get(mode):
        if mode not in made:
            made[mode] = ExportedPipeline(mode, tmp_path_factory.mktemp(mode),
                                          state, qscales)
        return made[mode]

    return get


@pytest.mark.parametrize("mode", ["int8_static", "mixed"])
def test_eager_call_after_export_keeps_its_bits(mode, exported):
    """Exported before its first eager call, the pipeline's eager call gives
    a never-exported pipeline's bits."""
    ex = exported(mode)
    assert torch.equal(ex.output("pipe", 2), ex.output("fresh", 2))


@pytest.mark.parametrize("mode", ["int8_static", "mixed"])
def test_exported_program_gives_eager_bits(mode, exported):
    """The loaded program gives the eager bits at the export batch (2) and
    at another (3). It calls the int8 ops once per int8 conv, and holds the
    weight codes as constants: no round of the weights in the graph."""
    exported(mode).check_program(mode)


def test_program_holds_the_eager_weight_side(exported):
    """int8_static: the program's constants hold the weight side each conv
    of an eager pipeline caches (the padded codes, the folded scale, the
    bias, the activation scales), bit for bit: an export after an eager
    call puts those same tensors in the program."""
    from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv

    ex = exported("int8_static")
    ex.output("fresh", 2)
    constants = list(ex.program.constants.values())
    cached = [t for m in ex.fresh.vae.modules() if isinstance(m, QConv)
              and m._int8_cache is not None for t in m._int8_cache[1]]
    assert len(cached) == 4 * INT8_CONVS["int8_static"]
    for t in cached:
        assert any(c.shape == t.shape and c.dtype == t.dtype
                   and torch.equal(c, t) for c in constants)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_exported_programs_match_jax_exports(exported, weights, tmp_path):
    """The slice against the JAX package, on the same weights and scales
    (the JAX calibration carried across):
    the port's loaded int8_static and INT8_MIXED_SPEC programs against the
    JAX export_pipeline -> load_pipeline of bench.build_jax_pipeline (run
    jitted, as XLA compiles it), with the rules of
    tests/test_torch_port_quant.py::test_vae_quantized_modes_match_jax:
    the mixed spec within rel-L2 1e-3 of JAX's; in full int8_static the
    port's quantized-vs-native rel-L2 within 10% of JAX's (a fully int8 VAE
    amplifies last-bit changes past 1e-3)."""
    import jax.numpy as jnp

    import bench
    from weatherforecastingtoolkit_tpu.parallel import serving as jserving

    params, _, _, jq = weights
    fc = exported("mixed").fc
    trees = {
        "AutoencoderKL": params,
        "DLinear": {"params": {
            "seasonal_w": fc.seasonal.weight.detach().numpy().T,
            "seasonal_b": fc.seasonal.bias.detach().numpy(),
            "trend_w": fc.trend.weight.detach().numpy().T,
            "trend_b": fc.trend.bias.detach().numpy()}},
    }
    frames = _frames(2)
    jframes = jnp.asarray(frames.numpy())
    native, _ = pipeline("native", weights[1])
    port_native = native(fc, frames).numpy()
    with _flax_init(trees):
        jnative, jfc = bench.build_jax_pipeline("float32", "native",
                                                vae_kwargs=KW)
    j_native = np.asarray(jnative(jfc, jframes))
    np.testing.assert_allclose(port_native, j_native, atol=5e-4)
    for mode in ("int8_static", "mixed"):
        with _flax_init(trees):
            jpipe, jfc = bench.build_jax_pipeline(
                "float32", MODES[mode], vae_kwargs=KW, qscales=jq)
        path = str(tmp_path / f"{mode}.jax")
        jserving.export_pipeline(jpipe, jfc, jframes, path)
        want = np.asarray(jserving.load_pipeline(path)(jfc, jframes))
        got = exported(mode).output("call", 2).numpy()
        assert got.shape == want.shape == (2, bh.T_OUT, 1, HW, HW)
        if mode == "mixed":
            assert _rel(got, want) <= 1e-3, mode
        else:
            j_err, p_err = _rel(want, j_native), _rel(got, port_native)
            assert j_err > 1e-4, "the quantized pipeline must differ"
            assert abs(p_err - j_err) <= 0.1 * j_err, (p_err, j_err)
