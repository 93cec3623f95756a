"""The port's evaluation protocol (evaluation.py), evaluation and ensemble
rollouts (models/rollout.py), forecasters (models/forecasters.py) and
Trainer.validate against the JAX package, on the CPU: the same weights and
numpy batches through both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu import evaluation as jev
from weatherforecastingtoolkit_tpu.models import forecasters as jfc
from weatherforecastingtoolkit_tpu.models import rollout as jro
from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL, from_torch_state_dict)
from weatherforecastingtoolkit_tpu.training import tasks as jtasks
from weatherforecastingtoolkit_tpu.training import trainer as jtrainer
from weatherforecastingtoolkit_tpu.utils import config as jconfig
from weatherforecastingtoolkit_tpu_torch import evaluation as pev
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.models import forecasters as pfc
from weatherforecastingtoolkit_tpu_torch.models import rollout as pro
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.training import tasks as ptasks
from weatherforecastingtoolkit_tpu_torch.training import trainer as ptrainer
from weatherforecastingtoolkit_tpu_torch.utils import config as pconfig

VAE_KW = dict(in_channels=1, out_channels=1, block_out_channels=(32, 64),
              layers_per_block=1, latent_channels=4, norm_num_groups=8)
T_IN, T_OUT = 5, 4
LATENT = (4, 16, 16)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair():
    """A frozen VAE and a DLinear with the same weights in both packages,
    and two uint8 VIL batches (2, 9, 1, 32, 32)."""
    vae = AutoencoderKL(**VAE_KW, device="cpu", seed=1)
    jvae = JAKL(**VAE_KW)
    jvars = from_torch_state_dict(
        jvae, {k: v.numpy() for k, v in vae.state_dict().items()},
        example_shape=(1, 1, 32, 32))
    d = int(np.prod(LATENT))
    jfore = jfc.DLinear(seq_len=T_IN, pred_len=T_OUT, kernel_size=3)
    rng = np.random.default_rng(2)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.02 * rng.standard_normal(a.shape)
        .astype(np.float32),
        jax.device_get(jfore.init(jax.random.key(0), jnp.zeros((1, T_IN, d)))))
    pfore = pfc.DLinear(T_IN, T_OUT, kernel_size=3, device="cpu")
    pfore.load_state_dict(pfc.dlinear_state_dict_from_flax(jparams))
    ev = synthetic_vil_events(4, 32, 32, T_IN + T_OUT, seed=3)
    vil = np.ascontiguousarray(np.transpose(ev, (0, 3, 1, 2))[:, :, None])
    return dict(vae=vae, jvae=jvae, jvars=jvars, jfore=jfore, jparams=jparams,
                pfore=pfore, batches=[vil[:2], vil[2:]])


def _jax_fns(p):
    jvae, jvars, jfore = p["jvae"], p["jvars"], p["jfore"]

    def enc(f):
        return jvae.apply(jvars, f, method=jvae.encode).mode()

    def dec(z):
        return jvae.apply(jvars, z, method=jvae.decode)

    pipe = jro.make_forecast_pipeline(
        encode_apply=enc, decode_apply=dec,
        forecaster_apply=lambda prm, z: jfore.apply(prm, z),
        input_frames=T_IN, pred_frames=T_OUT)

    def roundtrip(prm, target):
        b, t = target.shape[:2]
        flat = target.reshape((b * t,) + target.shape[2:])
        return dec(enc(flat)).reshape(target.shape)

    return jro.make_eval_fn(pipe, T_IN, T_OUT), roundtrip


def _port_fns(p):
    vae = p["vae"]

    def enc(f):
        return vae.encode(f).mode()

    pipe = pro.make_forecast_pipeline(
        encode_apply=enc, decode_apply=vae.decode,
        forecaster_apply=lambda m, z: m(z), input_frames=T_IN,
        pred_frames=T_OUT, device="cpu")

    def roundtrip(m, target):
        b, t = target.shape[:2]
        flat = target.reshape((b * t,) + tuple(target.shape[2:]))
        return vae.decode(enc(flat)).reshape(target.shape)

    return pipe, pro.make_eval_fn(pipe, T_IN, T_OUT, device="cpu"), roundtrip


def _assert_metrics_close(got, want, rel=1e-4):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=rel, abs=1e-7), k


def test_evaluate_protocol_and_vs_persistence_match_jax(pair):
    """Every model / persistence / ceiling key within rel 1e-4 of JAX's,
    the same wins and the same table layout."""
    j_eval, j_rt = _jax_fns(pair)
    _, p_eval, p_rt = _port_fns(pair)
    jb = [jnp.asarray(b) for b in pair["batches"]]
    want = jev.evaluate_protocol(j_eval, pair["jparams"], jb, roundtrip_fn=j_rt)
    got = pev.evaluate_protocol(p_eval, pair["pfore"], pair["batches"],
                                roundtrip_fn=p_rt)
    for a, b in ((got.model, want.model), (got.persistence, want.persistence),
                 (got.ceiling, want.ceiling)):
        _assert_metrics_close(a, b)
    assert (got.wins, got.score) == (want.wins, pytest.approx(want.score,
                                                              rel=1e-3))
    assert got.format_table("x").splitlines()[0] == want.format_table(
        "x").splitlines()[0]
    jm, jp = jro.evaluate_vs_persistence(j_eval, pair["jparams"], jb)
    pm, pp = pro.evaluate_vs_persistence(p_eval, pair["pfore"],
                                         pair["batches"])
    _assert_metrics_close(pm, jm)
    _assert_metrics_close(pp, jp)


def test_wins_score_ceiling_and_table_equal_jax():
    rng = np.random.default_rng(4)
    keys = jev.HEADLINE + ("CSI_0",)
    dicts = [{k: float(v) for k, v in zip(keys, rng.random(len(keys)) + 0.1)}
             for _ in range(3)]
    model, persist, ceil = dicts
    assert pev.wins_and_score(model, persist) == jev.wins_and_score(model,
                                                                   persist)
    for key in ("SSIM", "paper_CSI_M_POOL1"):
        assert pev.ceiling_fraction(model, ceil, key) == jev.ceiling_fraction(
            model, ceil, key)
    with pytest.raises(ValueError, match="higher-is-better"):
        pev.ceiling_fraction(model, ceil, "CRPS")
    wins, score = jev.wins_and_score(model, persist)
    for c in (ceil, None):
        args = dict(model=model, persistence=persist, ceiling=c, wins=wins,
                    score=score)
        p, j = pev.EvalReport(**args), jev.EvalReport(**args)
        assert p.format_table("t") == j.format_table("t")
        assert p.ceiling_fractions() == j.ceiling_fractions()


def test_ensemble_members(pair):
    """sigma = 0: every member equals the deterministic pipeline (atol
    1e-6); sigma > 0: the same seed gives the same members, with spread;
    member m is the deterministic path on z + sigma * eps_m, eps drawn
    (N, B, T_in, D) from the same seed; the posterior-sampling variant's
    shape; calibrate_noise_std returns its table's minimum."""
    vae, fore = pair["vae"], pair["pfore"]
    pipe, _, _ = _port_fns(pair)
    n = 3
    common = dict(decode_apply=vae.decode, forecaster_apply=lambda m, z: m(z),
                  input_frames=T_IN, pred_frames=T_OUT, device="cpu")

    def enc(f):
        return vae.encode(f).mode()

    ens = pro.make_ensemble_pipeline(encode_apply=enc, n_members=n, **common)
    frames = pair["batches"][0][:, :T_IN]
    det = pipe(fore, frames)
    out0 = ens(fore, frames, torch.Generator().manual_seed(0), 0.0)
    assert out0.shape == (2, n, T_OUT, 1, 32, 32)
    for m in range(n):
        torch.testing.assert_close(out0[:, m], det, rtol=0, atol=1e-6)
    sigma = 0.2
    out1 = ens(fore, frames, torch.Generator().manual_seed(5), sigma)
    assert torch.equal(out1, ens(fore, frames, torch.Generator().manual_seed(5),
                                 sigma))
    assert float(out1.std(dim=1).mean()) > 1e-4
    eps = torch.randn((n, 2, T_IN, int(np.prod(LATENT))),
                      generator=torch.Generator().manual_seed(5))
    for m in range(n):
        member = pro.make_forecast_pipeline(
            encode_apply=lambda f, m=m: enc(f) + sigma * eps[m].reshape(
                (-1,) + LATENT), **common)
        torch.testing.assert_close(out1[:, m], member(fore, frames), rtol=0,
                                   atol=1e-5)
    post = pro.make_ensemble_pipeline(
        encode_apply=enc, n_members=n,
        encode_sample_apply=lambda g, f: vae.encode(f).sample(g), **common)
    out2 = post(fore, frames, torch.Generator().manual_seed(1), 0.0)
    assert out2.shape == (2, n, T_OUT, 1, 32, 32)
    assert float(out2.std(dim=1).mean()) > 0
    eval_fn = pro.make_ensemble_eval_fn(ens, T_IN, T_OUT, device="cpu")
    best, table = pro.calibrate_noise_std(eval_fn, fore, pair["batches"],
                                          [0.0, 0.05, 0.2], seed=0,
                                          device="cpu")
    assert set(table) == {0.0, 0.05, 0.2} and best == min(table, key=table.get)
    assert pro.calibrate_noise_std(eval_fn, fore, pair["batches"],
                                   [0.0, 0.05, 0.2], seed=0,
                                   device="cpu")[1] == table


@pytest.mark.parametrize("kind", ["linear", "per_pixel", "time_mlp"])
def test_forecasters_match_jax(kind):
    """rel 1e-5 against the JAX module on the same (carried) weights."""
    rng = np.random.default_rng(6)
    if kind == "linear":
        jmod, x = jfc.LinearForecaster(t_in=5, t_out=3), rng.random((2, 5, 8))
        pmod = pfc.LinearForecaster(5, 3, 8, device="cpu")
        convert = pfc.linear_forecaster_state_dict_from_flax
    elif kind == "per_pixel":
        jmod, x = jfc.PerPixelLinear(t_in=5, t_out=3), rng.random((2, 5, 4, 3, 6))
        pmod = pfc.PerPixelLinear(5, 3, 4, device="cpu")
        convert = pfc.per_pixel_linear_state_dict_from_flax
    else:
        jmod, x = jfc.TimeMLP(t_in=5, t_out=3, hidden_dim=16), rng.random((2, 7, 5))
        pmod = pfc.TimeMLP(5, 3, 16, device="cpu")
        convert = pfc.time_mlp_state_dict_from_flax
    x = x.astype(np.float32)
    params = jax.device_get(jmod.init(jax.random.key(1), jnp.asarray(x)))
    pmod.load_state_dict(convert(params), strict=True)
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    if kind != "time_mlp":  # TimeMLP maps any leading shape
        with pytest.raises(ValueError, match="T_in"):
            pmod(torch.zeros((2, 4) + tuple(x.shape[2:])))


def _validate_config(cls, tmp):
    return cls({"experiment_name": "val", "experiment_path": str(tmp),
                "seed": 0, "optim": {"schedule": "constant", "lr": 1e-3},
                "trainer": {"total_train_steps": 1, "max_epochs": 1,
                            "async_checkpoint": False},
                "logging": {"log_every_n_steps": 1}})


def test_trainer_validate_matches_jax(pair, tmp_path):
    """latent_forecast_task with decode_apply: the JAX Trainer's key set,
    and loss and metrics within rel 1e-4 of it, on the same weights and
    batch."""
    jvae, jvars, vae = pair["jvae"], pair["jvars"], pair["vae"]
    jtask = jtasks.latent_forecast_task(
        lambda f, r: jvae.apply(jvars, f, method=jvae.encode).mode(),
        pair["jfore"], T_IN, T_OUT, LATENT,
        decode_apply=lambda z: jvae.apply(jvars, z, method=jvae.decode))
    ptask = ptasks.latent_forecast_task(
        lambda f, r: vae.encode(f).mode(), pair["pfore"], T_IN, T_OUT, LATENT,
        decode_apply=vae.decode)
    jt = jtrainer.Trainer(_validate_config(jconfig.Config, tmp_path / "j"), jtask)
    pt = ptrainer.Trainer(_validate_config(pconfig.Config, tmp_path / "p"),
                          ptask, device="cpu")
    jstate = jt.init_state().replace(params=pair["jparams"])
    pstate = pt.init_state()
    batch = [{"vil": pair["batches"][0]}]
    want = jt.validate(jstate, batch, step=0)
    got = pt.validate(pstate, batch, step=0)
    jt.close()
    pt.close()
    assert "paper_CSI_M_POOL1" in got
    _assert_metrics_close(got, want)
