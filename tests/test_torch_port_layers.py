"""The PyTorch port's layout helpers, posterior, GroupNorm+SiLU and conv,
held against the JAX package on the same numpy inputs (CPU).

On the CPU the port's GroupNorm wrapper runs its plain version; the kernel
itself is held against that plain version on the card
(tests/test_torch_port_kernel.py and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from weatherforecastingtoolkit_tpu.models import common as jcommon
from weatherforecastingtoolkit_tpu.models.vae.distributions import (
    DiagonalGaussianDistribution as JDist)
from weatherforecastingtoolkit_tpu.ops.pallas.groupnorm import (
    _gn_silu_reference, fused_group_norm_silu)
from weatherforecastingtoolkit_tpu.ops.quant import QConv as JQConv
from weatherforecastingtoolkit_tpu_torch.models import common as pcommon
from weatherforecastingtoolkit_tpu_torch.models.vae.distributions import (
    DiagonalGaussianDistribution as PDist)
from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm as pgn
from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv as PQConv


# ------------------------------------------------------------------ layouts
@pytest.mark.parametrize("factor", [2, 4])
def test_space_to_depth_matches_jax_exactly(factor, rng):
    x = rng.standard_normal((2, 8, 16, 3)).astype(np.float32)
    want = np.asarray(jcommon.space_to_depth(jnp.asarray(x), factor))
    got = pcommon.space_to_depth(torch.from_numpy(x), factor)
    np.testing.assert_array_equal(got.numpy(), want)
    back = pcommon.depth_to_space(got, factor)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jcommon.depth_to_space(jnp.asarray(want),
                                                        factor)))
    np.testing.assert_array_equal(back.numpy(), x)
    # pixel_unshuffle orders channels c*f*f + u*f + v: not the JAX order
    unshuffled = F.pixel_unshuffle(torch.from_numpy(x).permute(0, 3, 1, 2),
                                   factor).permute(0, 2, 3, 1)
    assert not np.array_equal(unshuffled.numpy(), want)


def test_layout_permutes_match_jax(rng):
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        pcommon.nchw_to_nhwc(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.nchw_to_nhwc(jnp.asarray(x))))
    np.testing.assert_array_equal(
        pcommon.nhwc_to_nchw(torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.nhwc_to_nchw(jnp.asarray(x))))


# ------------------------------------------------------------ distributions
def test_distribution_matches_jax(rng):
    params = (rng.standard_normal((2, 8, 4, 4)) * 3).astype(np.float32)
    params[0, 4:, 0, 0] = [-40.0, 25.0, 0.0, 1.0]   # outside the clamp
    other = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    sample = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    j, jo = JDist(jnp.asarray(params)), JDist(jnp.asarray(other))
    p, po = PDist(torch.from_numpy(params)), PDist(torch.from_numpy(other))
    pairs = [(j.mode(), p.mode()), (j.logvar, p.logvar), (j.std, p.std),
             (j.kl(), p.kl()), (j.kl(jo), p.kl(po)),
             (j.nll(jnp.asarray(sample)), p.nll(torch.from_numpy(sample)))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


def test_distribution_sample_uses_generator(rng):
    params = rng.standard_normal((2, 8, 4, 4)).astype(np.float32)
    dist = PDist(torch.from_numpy(params))
    a = dist.sample(torch.Generator().manual_seed(3))
    b = dist.sample(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.shape == (2, 4, 4, 4) and not torch.equal(a, dist.mode())
    det = PDist(torch.from_numpy(params), deterministic=True)
    assert torch.equal(det.sample(), det.mode())
    assert torch.equal(det.kl(), torch.zeros(2))


# ------------------------------------------------------- GroupNorm + SiLU
def _gn_inputs(rng, n=2, c=16, h=8, w=8):
    x = (rng.standard_normal((n, c, h, w)) * 3.0 + 1.0).astype(np.float32)
    s = (rng.random(c) + 0.5).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    return x, s, b


@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("silu,eps", [(True, 1e-6), (False, 1e-5)])
def test_plain_group_norm_matches_jax(channels_last, silu, eps, rng):
    """The port's plain version against the Pallas kernel (interpret mode)
    and the XLA reference it copies, in both torch layouts."""
    x, s, b = _gn_inputs(rng)
    xj = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))
    args = (jnp.asarray(s), jnp.asarray(b), 4, eps, silu)
    want_kernel = np.asarray(fused_group_norm_silu(xj, *args, True))
    want_ref = np.asarray(_gn_silu_reference(xj, *args))
    xt = torch.from_numpy(x)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last)
    got = pgn.group_norm_silu(xt, torch.from_numpy(s), torch.from_numpy(b),
                              4, eps, silu)
    got = np.transpose(got.numpy(), (0, 2, 3, 1))
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


def test_plain_group_norm_bf16_casts_once(rng):
    """bf16 in -> fp32 chain -> one cast: equals the fp32 result rounded."""
    x, s, b = _gn_inputs(rng)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = pgn.group_norm_silu_reference(xb, torch.from_numpy(s),
                                        torch.from_numpy(b), 4, 1e-6, True)
    want = pgn.group_norm_silu_reference(xb.float(), torch.from_numpy(s),
                                         torch.from_numpy(b), 4, 1e-6, True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_group_norm_gradients_match_jax(rng):
    x, s, b = _gn_inputs(rng, n=1, c=8, h=4, w=4)
    g = rng.standard_normal(x.shape).astype(np.float32)

    def jf(x_, s_, b_):
        y = fused_group_norm_silu(x_, s_, b_, 2, 1e-6, True, True)
        return jnp.sum(y * jnp.asarray(np.transpose(g, (0, 2, 3, 1))))

    jx, js, jb = jax.grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(s),
        jnp.asarray(b))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    (pgn.group_norm_silu(xt, st, bt, 2, 1e-6, True) * torch.from_numpy(g)
     ).sum().backward()
    np.testing.assert_allclose(np.transpose(xt.grad.numpy(), (0, 2, 3, 1)),
                               np.asarray(jx), atol=1e-5)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(js), atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(jb), atol=1e-5)

    # finite difference on scale[0], as tests/test_stencil.py does
    def f(scale):
        return float((pgn.group_norm_silu(torch.from_numpy(x), scale,
                                          torch.from_numpy(b), 2, 1e-6, True)
                      ** 2).sum())

    st2 = torch.from_numpy(s).clone().requires_grad_()
    (pgn.group_norm_silu(torch.from_numpy(x), st2, torch.from_numpy(b), 2,
                         1e-6, True) ** 2).sum().backward()
    e = torch.zeros(8)
    e[0] = 1e-3
    fd = (f(torch.from_numpy(s) + e) - f(torch.from_numpy(s) - e)) / 2e-3
    assert float(st2.grad[0]) == pytest.approx(fd, rel=2e-2)


def test_group_norm_cuda_wrapper_refuses_cpu_tensor(rng):
    x, s, b = _gn_inputs(rng)
    before = pgn.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        pgn.group_norm_silu_cuda(torch.from_numpy(x), torch.from_numpy(s),
                                 torch.from_numpy(b), 4, 1e-6, True)
    assert pgn.launches == before


# ------------------------------------------------------------------- QConv
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_qconv_native_matches_jax(stride, padding, rng):
    x = rng.standard_normal((2, 6, 9, 9)).astype(np.float32)
    conv = PQConv(6, 5, 3, stride=stride, padding=padding)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.standard_normal((5, 6, 3, 3)).astype(np.float32)))
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(5)
                                         .astype(np.float32)))
        got = conv(torch.from_numpy(x)).numpy()
    jconv = JQConv(5, (3, 3), strides=stride, padding=padding)
    params = {"params": {
        "kernel": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
        "bias": jnp.asarray(conv.bias.detach().numpy())}}
    want = jconv.apply(params, jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got, np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5)


def test_qconv_promotes_and_rejects_unported_modes():
    conv = PQConv(2, 3, 1)
    torch.nn.init.ones_(conv.weight)
    y = conv(torch.ones(1, 2, 2, 2, dtype=torch.bfloat16))
    assert y.dtype == torch.float32          # bf16 x fp32 kernel -> fp32
    # every mode of the JAX package is ported (ops/quant.py); an unknown
    # one is still rejected with the JAX message
    x = torch.ones(1, 2, 2, 2)
    for mode in ("int8", "int8_static", "calibrate", "fake_quant"):
        out = PQConv(2, 3, 1, mode=mode)
        torch.nn.init.ones_(out.weight)
        assert torch.equal(out(x), conv(x.to(torch.bfloat16))), mode
    with pytest.raises(ValueError, match="not in"):
        PQConv(2, 3, 1, mode="int4")


# ----------------------------------------------------------------- init
@pytest.mark.parametrize("shape,fan_in,scale", [
    ((64, 32, 3, 3), None, 1.0), ((40, 7), 7, 2.0), ((3,), None, 1.0),
    ((256, 128, 4, 4), 512, 1.0)])
def test_lecun_normal_draws_the_redraw_loops_values(shape, fan_in, scale):
    """lecun_normal_ redraws only the values still out of range, in index
    order: the bits of the whole-array redraw loop it replaced, which is
    the reference here (every port model's numpy-drawn weights)."""
    rng = np.random.default_rng(11)
    v = rng.standard_normal(shape)
    out = np.abs(v) > 2.0
    while out.any():
        v[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(v) > 2.0
    std = (scale / (fan_in or int(np.prod(shape[1:])))) ** 0.5 \
        / pcommon._TRUNC_STD
    want = torch.from_numpy(v * std).float()
    got = pcommon.lecun_normal_(torch.empty(shape), np.random.default_rng(11),
                                fan_in=fan_in, scale=scale)
    assert torch.equal(got, want)
