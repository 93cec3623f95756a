"""The PyTorch port's serving slice against the JAX package (CPU, fp32):
DLinear, the one-shot and autoregressive pipelines and the streaming tick
on shared weights, plus the pieces the serving check uses (SSIM/PSNR, the
synthetic VIL source, the persistence baseline)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.data.synthetic import (
    synthetic_vil_events as j_events)
from weatherforecastingtoolkit_tpu.models import forecasters as jfc
from weatherforecastingtoolkit_tpu.models import rollout as jro
from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL, from_torch_state_dict)
from weatherforecastingtoolkit_tpu.ops import ssim as jssim
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    synthetic_vil_events as p_events)
from weatherforecastingtoolkit_tpu_torch.models import forecasters as pfc
from weatherforecastingtoolkit_tpu_torch.models import rollout as pro
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.ops import ssim as pssim

T_IN, T_OUT, HW = 4, 3, 16
VAE = dict(in_channels=1, out_channels=1, block_out_channels=(16, 32),
           layers_per_block=1, latent_channels=4, norm_num_groups=8)


def _dlinear_pair(rng, seq_len, pred_len, d, individual=False, kernel=3):
    """A JAX DLinear with random params and the port's copy of it."""
    jm = jfc.DLinear(seq_len=seq_len, pred_len=pred_len, kernel_size=kernel,
                     individual=individual, channels=d)
    shapes = jax.eval_shape(jm.init, jax.random.key(0),
                            jnp.zeros((1, seq_len, d), jnp.float32))
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) / seq_len).astype(np.float32),
        shapes)
    pm = pfc.DLinear(seq_len, pred_len, kernel, individual, d, device="cpu")
    pm.load_state_dict(pfc.dlinear_state_dict_from_flax(params), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("individual", [False, True])
def test_dlinear_matches_jax(individual, rng):
    d = 6
    jm, params, pm = _dlinear_pair(rng, 13, 12, d, individual, kernel=25)
    x = rng.standard_normal((3, 13, d)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        pfc.moving_avg(torch.from_numpy(x), 25).numpy(),
        np.asarray(jfc.moving_avg(jnp.asarray(x), 25)), atol=1e-6)


def test_dlinear_init_is_one_over_seq_len(rng):
    jm = jfc.DLinear(seq_len=13, pred_len=12)
    jparams = jm.init(jax.random.key(0), jnp.zeros((1, 13, 5)))
    pm = pfc.DLinear(13, 12, device="cpu")
    for k, v in pfc.dlinear_state_dict_from_flax(jparams).items():
        torch.testing.assert_close(pm.state_dict()[k], v, rtol=0, atol=0)


def _shared_codec(rng):
    """The port's VAE, the JAX VAE on the same weights, and each package's
    encode/decode callables (posterior mode, fp32)."""
    model = AutoencoderKL(**VAE, device="cpu", seed=3)
    jmodel = JAKL(**VAE)
    jvars = from_torch_state_dict(
        jmodel, {k: v.numpy() for k, v in model.state_dict().items()},
        example_shape=(1, 1, HW, HW))

    def j_enc(f):
        return jmodel.apply(jvars, f, method=jmodel.encode).mode()

    def j_dec(z):
        return jmodel.apply(jvars, z, method=jmodel.decode)

    def p_enc(f):
        return model.encode(f).mode()

    return (j_enc, j_dec), (p_enc, model.decode)


@pytest.mark.parametrize("autoregressive", [False, True])
def test_pipeline_matches_jax(autoregressive, rng):
    (j_enc, j_dec), (p_enc, p_dec) = _shared_codec(rng)
    d = 4 * (HW // 2) ** 2
    jm, params, pm = _dlinear_pair(rng, T_IN, T_OUT, d)
    kw = dict(input_frames=T_IN, pred_frames=T_OUT,
              autoregressive=autoregressive)
    jpipe = jax.jit(jro.make_forecast_pipeline(
        encode_apply=j_enc, decode_apply=j_dec,
        forecaster_apply=lambda p, z: jm.apply(p, z), **kw))
    ppipe = pro.make_forecast_pipeline(
        encode_apply=p_enc, decode_apply=p_dec,
        forecaster_apply=lambda m, z: m(z), device="cpu", **kw)
    frames = (rng.random((2, T_IN, 1, HW, HW)) * 255).astype(np.uint8)
    want = np.asarray(jpipe(params, jnp.asarray(frames)))
    got = ppipe(pm, frames)
    assert got.shape == (2, T_OUT, 1, HW, HW) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_streaming_tick_equals_batch_pipeline(rng):
    """Each streaming step reproduces the batch pipeline on the window
    ending at the new frame, in the port and against the JAX pipeline."""
    (j_enc, j_dec), (p_enc, p_dec) = _shared_codec(rng)
    d = 4 * (HW // 2) ** 2
    jm, params, pm = _dlinear_pair(rng, T_IN, T_OUT, d)
    kw = dict(input_frames=T_IN, pred_frames=T_OUT)
    jpipe = jax.jit(jro.make_forecast_pipeline(
        encode_apply=j_enc, decode_apply=j_dec,
        forecaster_apply=lambda p, z: jm.apply(p, z), **kw))
    pkw = dict(encode_apply=p_enc, decode_apply=p_dec,
               forecaster_apply=lambda m, z: m(z), device="cpu", **kw)
    ppipe = pro.make_forecast_pipeline(**pkw)
    init, step = pro.make_streaming_forecaster(
        latent_shape=(4, HW // 2, HW // 2), **pkw)
    n_ticks = 3
    seq = rng.random((2, T_IN + n_ticks, 1, HW, HW)).astype(np.float32)
    state = init(seq[:, :T_IN])
    for i in range(n_ticks):
        state, fcast = step(pm, state, seq[:, T_IN + i])
        window = seq[:, i + 1:T_IN + i + 1]
        np.testing.assert_allclose(fcast.numpy(), ppipe(pm, window).numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(
            fcast.numpy(), np.asarray(jpipe(params, jnp.asarray(window))),
            atol=5e-4)


def test_factories_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(encode_apply=None, decode_apply=None, forecaster_apply=None,
              input_frames=T_IN, pred_frames=T_OUT)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pro.make_forecast_pipeline(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pro.make_streaming_forecaster(latent_shape=(1,), **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pfc.DLinear(T_IN, T_OUT)
    pro.make_forecast_pipeline(device="cpu", **kw)


def test_persistence_baseline_matches_jax(rng):
    x = rng.random((2, 5, 1, 8, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        pro.persistence_baseline(torch.from_numpy(x), 3).numpy(),
        np.asarray(jro.persistence_baseline(jnp.asarray(x), 3)))


def test_ssim_psnr_match_jax(rng):
    a = rng.random((3, 1, 32, 32)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), \
        jnp.asarray(a), jnp.asarray(b)
    assert float(pssim.ssim(ta, tb)) == pytest.approx(
        float(jssim.ssim(ja, jb)), abs=1e-5)
    assert float(pssim.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    for data_range in (1.0, None):
        assert float(pssim.psnr(ta, tb, data_range)) == pytest.approx(
            float(jssim.psnr(ja, jb, data_range)), abs=1e-4)


def test_synthetic_events_are_a_copy():
    np.testing.assert_array_equal(p_events(2, 32, 24, 5, seed=7),
                                  j_events(2, 32, 24, 5, seed=7))
