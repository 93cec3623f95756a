"""The port's metric suite (metrics.py), pooling (ops/pooling.py) and
layout engine (ops/layout.py) against the JAX package's, on the CPU: the
same numpy inputs through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu import metrics as jm
from weatherforecastingtoolkit_tpu.ops import layout as jlayout
from weatherforecastingtoolkit_tpu.ops import pooling as jpool
from weatherforecastingtoolkit_tpu_torch import metrics as pm
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.ops import layout as playout
from weatherforecastingtoolkit_tpu_torch.ops import pooling as ppool

THRESHOLD_CODES = (16, 74, 133, 160, 181, 219)


def _is_count_key(k):
    return k.startswith(("CSI", "HSS", "paper_CSI", "paper_HSS"))


def _fields(seed, members=None):
    """Target: uint8 VIL / 255 (multiplied by 1/255, as the pipelines
    dequantize), (B, T, 1, 64, 64); pred: the target advanced a frame plus
    noise, with an ensemble axis when `members` is given."""
    ev = synthetic_vil_events(2, 64, 64, 5, seed=seed)
    vil = np.ascontiguousarray(np.transpose(ev, (0, 3, 1, 2))[:, :, None])
    target = vil[:, 1:].astype(np.float32) * np.float32(1.0 / 255.0)
    base = vil[:, :-1].astype(np.float32) * np.float32(1.0 / 255.0)
    rng = np.random.default_rng(seed)
    shape = base.shape if members is None else (
        base.shape[:1] + (members,) + base.shape[1:])
    base = base if members is None else base[:, None]
    pred = (base + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    return pred, target


@pytest.mark.parametrize("members", [None, 4])
def test_calc_metrics_matches_jax(members):
    """The JAX key set; continuous keys rel 1e-5; CSI/HSS keys abs 1e-6."""
    pred, target = _fields(3, members)
    want = jm.calc_metrics(jnp.asarray(pred), jnp.asarray(target))
    got = pm.calc_metrics(torch.from_numpy(pred), torch.from_numpy(target))
    assert set(got) == set(want)
    assert all(isinstance(v, float) for v in got.values())
    for k, v in want.items():
        if _is_count_key(k):
            assert got[k] == pytest.approx(v, abs=1e-6), k
        else:
            assert got[k] == pytest.approx(v, rel=1e-5), k
    # numpy arrays go in as they are, and PSNR with an estimated range
    again = pm.calc_metrics(pred, target, psnr_data_range=None)
    assert again["PSNR"] == again["PSNR_ref"] == pytest.approx(
        want["PSNR_ref"], rel=1e-5)


@pytest.mark.parametrize("scale", [1, 4, 16])
def test_constant_fields_at_every_code_threshold_as_jax(scale):
    """All 256 constant fields u/255 (u * f32(1/255), as dequantized), at
    pool 1, 4 and 16: each field's thresholded pooled pixels, and so every
    contingency count, equal JAX's; at pool 1 the fields u = 16, 74, ...
    219 sit on a threshold."""
    u = np.arange(256, dtype=np.uint8)
    frames = (np.broadcast_to(u[:, None, None], (256, 16, 16))
              .astype(np.float32) * np.float32(1.0 / 255.0))
    jt = jnp.asarray(pm.VIL_THRESHOLDS, dtype=jnp.float32)
    pt = torch.tensor(pm.VIL_THRESHOLDS, dtype=torch.float32)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    jf, pf = jnp.asarray(frames), torch.from_numpy(frames)
    if scale > 1:
        jf, pf = jpool.avg_pool2d(jf, scale), ppool.avg_pool2d(pf, scale)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    want = np.asarray(jf[None] >= jt.reshape(-1, 1, 1, 1))
    got = (pf[None] >= pt.reshape(-1, 1, 1, 1)).numpy()
    np.testing.assert_array_equal(got, want)
    # the contingency against a one-code-lower target, both packages
    lower = np.maximum(u.astype(np.int32) - 1, 0)[:, None, None]
    tgt = np.broadcast_to(lower, (256, 16, 16)).astype(np.float32) * np.float32(
        1.0 / 255.0)
    jg, pg = jnp.asarray(tgt), torch.from_numpy(tgt)
    if scale > 1:
        jg, pg = jpool.avg_pool2d(jg, scale), ppool.avg_pool2d(pg, scale)
    for a, b in zip(pm._contingency(pf, pg, pt), jm._contingency(jf, jg, jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if scale == 1:  # a pooled constant field need not keep its value
        codes = np.asarray(THRESHOLD_CODES)
        assert got[np.arange(6), codes].all()
        assert not got[np.arange(6), codes - 1].any()


@pytest.mark.parametrize("pool_type,scale", [("none", 1), ("avg", 4),
                                             ("max", 4), ("max", 16)])
def test_crps_csi_hss_match_jax(pool_type, scale):
    pred, target = _fields(5, members=3)
    want = jm.crps(jnp.asarray(pred), jnp.asarray(target), pool_type, scale)
    got = pm.crps(torch.from_numpy(pred), torch.from_numpy(target), pool_type,
                  scale)
    assert got == pytest.approx(want, rel=1e-5)
    single = pred[:, 0]
    assert pm.crps(single, target, pool_type, scale) == pytest.approx(
        jm.crps(jnp.asarray(single), jnp.asarray(target), pool_type, scale),
        rel=1e-5)
    for th in (16 / 255, 133 / 255):
        for fn_p, fn_j in ((pm.csi, jm.csi), (pm.hss, jm.hss)):
            assert fn_p(single, target, th, pool_type, scale) == pytest.approx(
                fn_j(jnp.asarray(single), jnp.asarray(target), th, pool_type,
                     scale), abs=1e-6)


def test_perfect_forecast_and_out_of_range_inputs():
    """pred == target: SSIM 1, CSI 1 where events exist, CRPS ~0; values
    outside [0, 1] are clamped, not NaN."""
    _, target = _fields(7)
    m = pm.calc_metrics(target, target)
    assert m["SSIM"] == pytest.approx(1.0, abs=1e-6)
    assert m["CSI_0"] == pytest.approx(1.0) and m["CRPS"] < 1e-8
    wild = target * 3.0 - 1.0
    assert all(np.isfinite(v) for v in pm.calc_metrics(wild, target).values())


@pytest.mark.parametrize("window,stride", [(2, None), (4, None), (3, 2),
                                           (16, None)])
def test_pooling_matches_jax(window, stride):
    x = np.random.default_rng(window).random((2, 3, 33, 34)).astype(np.float32)
    for pf, jf in ((ppool.avg_pool2d, jpool.avg_pool2d),
                   (ppool.max_pool2d, jpool.max_pool2d)):
        got = pf(torch.from_numpy(x), window, stride).numpy()
        want = np.asarray(jf(jnp.asarray(x), window, stride))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("src,dst", [("NTCHW", "NTHW"), ("NHWT", "NTCHW"),
                                     ("NTHWC", "TNCHW"), ("NTCHW", "NTCHW")])
def test_layout_matches_jax(src, dst):
    shape = tuple({"N": 2, "T": 3, "C": 1, "H": 4, "W": 5}[a] for a in src)
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    want = jlayout.change_layout(x, src, dst)
    np.testing.assert_array_equal(
        playout.change_layout(torch.from_numpy(x), src, dst).numpy(), want)
    np.testing.assert_array_equal(playout.change_layout(x, src, dst), want)
    assert (playout.layout_to_in_out_slice(dst, 2, 1)
            == jlayout.layout_to_in_out_slice(dst, 2, 1))
    with pytest.raises(ValueError, match="Cannot drop"):
        playout.change_layout(x, src, src.replace("T", ""))
