"""The port's quantized convs (ops/quant.py, ops/cuda/int8_conv.py) against
the JAX package's ops/quant.py, on the CPU: the same numpy inputs through
both. The port's int8 convs take their kernels' plain versions here (a
float64 conv of the int8 codes, then JAX's fp32 epilogue), which give the
JAX functions' bits. The JAX functions run eagerly, as the JAX package's
own tests run them: under ``jax.jit`` XLA turns a division by the constant
127 into a product with its reciprocal, which the port does not copy.

The ``cuda``-marked tests hold the kernels to their plain versions on the
card and skip without a GPU:
    python -m pytest --noconftest -m cuda tests/test_torch_port_quant.py
"""

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops import quant as tq
from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

from torch_port_card import KERNEL_NODE, graph_node_types

# (N, H, W, Cin, Cout, k, stride, padding): 3x3 s1 p1, 3x3 s2 with the VAE's
# (0, 1) padding, 1x1, Cin 1, 16 and 64, Cout 1 and 16
CONV_CASES = [(2, 17, 13, 1, 24, 3, 1, 1),
              (2, 17, 13, 16, 24, 3, 2, ((0, 1), (0, 1))),
              (2, 9, 11, 64, 24, 3, 1, 1),
              (1, 8, 8, 64, 16, 1, 1, 0),
              (2, 12, 10, 16, 1, 3, 1, "SAME")]
SMALL = dict(in_channels=1, out_channels=1, block_out_channels=(32, 64),
             layers_per_block=1, latent_channels=4, norm_num_groups=8)
INT8_MIXED_SPEC = (("encoder/mid_block*", "int8_static"), ("*", "native"))


def _conv_inputs(case, seed):
    n, h, w, cin, cout, k = case[:6]
    rng = np.random.default_rng(seed)
    # channels of very different magnitudes, as after a GroupNorm+SiLU
    x = (rng.standard_normal((n, h, w, cin))
         * np.logspace(-1, 1, cin)).astype(np.float32)
    kernel = (rng.standard_normal((k, k, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    absmax = (np.abs(x).max(axis=(0, 1, 2)) * 0.8).astype(np.float32)
    return x, kernel, bias, absmax


def _both(x, dtype):
    import jax.numpy as jnp

    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    return jx, tx


def _f32(a):
    import jax.numpy as jnp

    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: f"{c[3]}->{c[4]}k{c[5]}s{c[6]}")
def test_int8_convs_give_jax_bits(case, dtype):
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops import quant as jq

    x, kernel, bias, absmax = _conv_inputs(case, seed=case[3])
    stride, padding = (case[6],) * 2, case[7]
    jx, tx = _both(x, dtype)
    jk, tk = jnp.asarray(kernel), torch.from_numpy(kernel)
    jb, tb = jnp.asarray(bias), torch.from_numpy(bias)
    dyn = tq.int8_conv(tx, tk, tb, stride, padding)
    assert dyn.dtype == tx.dtype
    np.testing.assert_array_equal(
        _f32(dyn), _f32(jq.int8_conv(jx, jk, jb, stride, padding)))
    static = tq.int8_conv_static(tx, tk, tb, stride, padding,
                                 torch.from_numpy(absmax))
    np.testing.assert_array_equal(
        _f32(static), _f32(jq.int8_conv_static(jx, jk, jb, stride, padding,
                                               jnp.asarray(absmax))))


def test_int8_conv_all_zero_input():
    """max|x| = 0 and max|w| = 0 map to scale 1: outputs are 0 (the bias)."""
    x = torch.zeros(1, 4, 4, 8)
    out = tq.int8_conv(x, torch.zeros(3, 3, 8, 8), None, (1, 1), "SAME")
    assert torch.equal(out, torch.zeros(1, 4, 4, 8))
    out = tq.int8_conv(x, torch.ones(3, 3, 8, 8), torch.full((8,), 0.5),
                       (1, 1), "SAME")
    assert torch.equal(out, torch.full((1, 4, 4, 8), 0.5))


def test_fake_quant_forward_and_ste_gradients():
    """Forward rel 1e-6; gradients for x, kernel and bias rel 1e-5 of their
    largest entry, against jax.grad of the JAX function (its clip gives half
    the gradient on a bound, as the port's does)."""
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops import quant as jq

    x, kernel, bias, absmax = _conv_inputs((2, 10, 9, 8, 6, 3), seed=5)
    absmax = absmax * np.float32(1.25)  # some codes inside, the extremes on
    absmax[:2] = np.abs(x).max(axis=(0, 1, 2))[:2] * 0.5  # ... or past 127
    g = np.random.default_rng(6).standard_normal((2, 10, 9, 6)).astype(np.float32)

    def jloss(xx, kk, bb):
        y = jq.fake_quant_conv(xx, kk, bb, (1, 1), "SAME", jnp.asarray(absmax))
        return jnp.sum(y * g), y

    (_, jy), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, kernel, bias)]
    y = tq.fake_quant_conv(*leaves, (1, 1), "SAME", torch.from_numpy(absmax))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6 * float(np.abs(jy).max()))
    for leaf, jg in zip(leaves, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jg).max()))


def test_resolve_conv_mode_and_mixed_mode_uses():
    """The JAX test's cases (tests/test_quant.py::test_mixed_conv_mode_spec)."""
    spec = (("decoder/conv_out", "native"), ("encoder/conv_in", "native"),
            ("*", "int8_static"))
    assert tq.resolve_conv_mode(spec, ("decoder", "conv_out")) == "native"
    assert tq.resolve_conv_mode(spec, ("decoder", "conv_in")) == "int8_static"
    assert tq.resolve_conv_mode((), ("anything",)) == "native"
    assert tq.resolve_conv_mode("int8", ("x",)) == "int8"
    assert tq.mixed_mode_uses(spec, "int8_static")
    assert not tq.mixed_mode_uses(spec, "fake_quant")
    assert tq.mixed_mode_uses("int8", "int8")


def test_qconv_unknown_mode_keeps_the_jax_message():
    with pytest.raises(ValueError, match=r"conv mode 'int4' not in \("):
        tq.QConv(4, 4, 3, mode="int4")


def _jax_vae_params(jmodel, rng, hw=32):
    """numpy params of ``jmodel``'s tree: scaled normal kernels, non-trivial
    norms and biases."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 1, hw, hw), jnp.float32))

    def make(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            v = rng.standard_normal(leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif "scale" in name:
            v = 1.0 + 0.2 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return {"params": jax.tree_util.tree_map_with_path(make, shapes["params"])}


def _jax_calibrate(kw, params, frames):
    """bench.py's recipe: encode with 'qstats' mutable, then decode the mode;
    returns the 'qstats' collection."""
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL)
    from weatherforecastingtoolkit_tpu.ops.quant import calibrate

    cvae = JAKL(**kw, conv_mode="calibrate")

    def step(v, f):
        post, mut = cvae.apply(v, f, method=cvae.encode, mutable=["qstats"])
        return cvae.apply({"params": v["params"], "qstats": mut["qstats"]},
                          post.mode(), method=cvae.decode, mutable=["qstats"])

    return calibrate(step, params, [frames])


def _port_vae(kw, params, conv_mode):
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL, state_dict_from_flax)

    model = AutoencoderKL(**kw, conv_mode=conv_mode, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model


def test_calibrate_matches_jax():
    """The same set of paths as JAX's; the encoder's conv_in (whose input is
    the frames) has JAX's bits; every other act_absmax within 2e-6 of its
    largest entry: fp32 op-order differences of the convs and GroupNorms
    upstream (native port vs JAX, tests/test_torch_port_vae.py) exceed
    1e-6 by the decoder at this size."""
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL)

    kw = dict(SMALL, block_out_channels=(8, 16), norm_num_groups=4)
    rng = np.random.default_rng(0)
    params = _jax_vae_params(JAKL(**kw), rng)
    frames = rng.random((3, 1, 32, 32)).astype(np.float32)
    qstats = _jax_calibrate(kw, params, jnp.asarray(frames))
    want = tq.qscales_from_flax(jax.device_get(qstats))
    model = _port_vae(kw, params, "calibrate")
    got = tq.calibrate(lambda m, f: m.decode(m.encode(f).mode()), model,
                       [torch.from_numpy(frames)])
    assert set(got) == set(want) and len(got) == 28
    assert torch.equal(got["encoder/conv_in"], want["encoder/conv_in"])
    for path, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[path].numpy(), rtol=0,
                                   atol=2e-6 * float(want[path].max()),
                                   err_msg=path)
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate(lambda m, f: None, model, [])


def _vae_pair(conv_mode, seed=1):
    """(JAX model, its variables, port model, frames) at SMALL in fp32, JAX's
    calibration carried across for the modes that read scales."""
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL)

    rng = np.random.default_rng(seed)
    params = _jax_vae_params(JAKL(**SMALL), rng)
    x = rng.random((2, 1, 32, 32)).astype(np.float32)
    variables = dict(params)
    model = _port_vae(SMALL, params, conv_mode)
    if conv_mode not in ("int8", "native"):
        qstats = _jax_calibrate(SMALL, params, jnp.asarray(x))
        variables["qscales"] = qstats
        model.load_qscales(tq.qscales_from_flax(jax.device_get(qstats)))
    return JAKL(**SMALL, conv_mode=conv_mode), variables, model, x


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode", ["int8", "int8_static", "mixed"])
def test_vae_quantized_modes_match_jax(mode):
    """AutoencoderKL (32, 64) in fp32, JAX's calibration carried across:
    every quantized conv of the forward gives the JAX function's bits on its
    own input; the port's quantized-vs-native rel-L2 is within 10% of JAX's;
    under INT8_MIXED_SPEC the output is within rel-L2 1e-3 of JAX's. (With
    every conv quantized, a last-bit difference upstream flips codes whose
    effect grows layer by layer: see the next test.)"""
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL)
    from weatherforecastingtoolkit_tpu.ops import quant as jq

    conv_mode = INT8_MIXED_SPEC if mode == "mixed" else mode
    jmodel, variables, model, x = _vae_pair(conv_mode)
    calls = []
    hooks = [m.register_forward_hook(lambda m, a, y: calls.append((m, a[0], y)))
             for m in model.modules()
             if isinstance(m, tq.QConv) and m.resolved != "native"]
    with torch.no_grad():
        out = model(torch.from_numpy(x)).numpy()
        native = _port_vae(SMALL, {"params": variables["params"]},
                           "native")(torch.from_numpy(x)).numpy()
    for h in hooks:
        h.remove()
    assert len(calls) == {"int8": 28, "int8_static": 28, "mixed": 4}[mode]
    for m, xin, y in calls:
        t, b, l, r = m.pad
        args = (jnp.asarray(xin.permute(0, 2, 3, 1).numpy()),
                jnp.asarray(m.weight.detach().permute(2, 3, 1, 0).numpy()),
                jnp.asarray(m.bias.detach().numpy()), m.stride,
                ((t, b), (l, r)))
        want = (jq.int8_conv(*args) if m.resolved == "int8" else
                jq.int8_conv_static(*args, jnp.asarray(m.act_absmax.numpy())))
        np.testing.assert_array_equal(y.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want), err_msg=m.path)
    jq_out = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    jn_out = np.asarray(JAKL(**SMALL).apply({"params": variables["params"]},
                                            jnp.asarray(x)))
    j_err, p_err = _rel(jq_out, jn_out), _rel(out, native)
    assert j_err > 1e-4, "the quantized model must differ from native"
    assert abs(p_err - j_err) <= 0.1 * j_err, (p_err, j_err)
    if mode == "mixed":
        assert _rel(out, jq_out) <= 1e-3


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_full_int8_vae_amplifies_last_bit_changes(mode):
    """With every conv quantized, changing the GroupNorm scales by 1e-7
    (relative) moves the port's own output by more than 1e-3 rel-L2, while
    the native model moves by about 1e-6: the reason the output is not held
    to JAX's within 1e-3 in these modes."""
    _, _, model, x = _vae_pair(mode)
    native = _vae_pair("native")[2]
    g = torch.Generator().manual_seed(0)
    moved = []
    for m in (model, native):
        with torch.no_grad():
            before = m(torch.from_numpy(x)).numpy()
            for name, p in m.named_parameters():
                if "norm" in name and name.endswith("weight"):
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=g))
            moved.append(_rel(m(torch.from_numpy(x)).numpy(), before))
    assert moved[0] > 1e-3 and moved[1] < 1e-5, moved


def test_mixed_spec_quantizes_exactly_the_encoder_mid_block():
    """INT8_MIXED_SPEC selects the four encoder mid-block convs (512 -> 512
    at the reference width); quant_conv and post_quant_conv stay plain
    convs in every mode; scales exist only where the mode reads them; a
    missing scale loads as ones."""
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    model = AutoencoderKL(**dict(SMALL, block_out_channels=(8, 16, 16),
                                 norm_num_groups=4), conv_mode=INT8_MIXED_SPEC,
                          device="cpu")
    convs = {m.path: m for m in model.modules() if isinstance(m, tq.QConv)}
    quantized = sorted(p for p, m in convs.items() if m.resolved != "native")
    assert quantized == ["encoder/mid_block/resnets_0/conv1",
                         "encoder/mid_block/resnets_0/conv2",
                         "encoder/mid_block/resnets_1/conv1",
                         "encoder/mid_block/resnets_1/conv2"]
    assert "encoder/down_blocks_0/downsamplers_0/conv" in convs
    assert all((m.act_absmax is None) == (m.resolved == "native")
               for m in convs.values())
    for name in ("quant_conv", "post_quant_conv"):
        assert type(getattr(model, name)) is torch.nn.Conv2d
    assert not any("act_absmax" in k for k in model.state_dict())
    model.load_qscales({"encoder/mid_block/resnets_0/conv1": torch.full((16,), 3.0)})
    assert torch.equal(convs["encoder/mid_block/resnets_0/conv1"].act_absmax,
                       torch.full((16,), 3.0))
    assert torch.equal(convs["encoder/mid_block/resnets_1/conv2"].act_absmax,
                       torch.ones(16))
    # a bf16 cast keeps the scales fp32
    model.to(torch.bfloat16)
    assert convs["encoder/mid_block/resnets_0/conv1"].act_absmax.dtype == torch.float32


@pytest.mark.parametrize("mode", ["int8", "int8_static", "calibrate",
                                  "fake_quant", "mixed"])
def test_state_dict_loads_strictly_into_jax(mode):
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
        AutoencoderKL as JAKL, from_torch_state_dict)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    conv_mode = INT8_MIXED_SPEC if mode == "mixed" else mode
    model = AutoencoderKL(**SMALL, conv_mode=conv_mode, device="cpu")
    jmodel = JAKL(**SMALL, conv_mode=conv_mode)
    back = from_torch_state_dict(
        jmodel, {k: v.numpy() for k, v in model.state_dict().items()},
        example_shape=(1, 1, 32, 32))
    want = jax.eval_shape(jmodel.init, jax.random.key(0),
                          jnp.zeros((1, 1, 32, 32), jnp.float32))["params"]
    assert (jax.tree_util.tree_structure(back["params"])
            == jax.tree_util.tree_structure(want))


def test_tile_choice():
    """The conv kernel's plan (pure): the widest tile Cout fills (128 at
    most in the gather), im2col where TMA takes the geometry and Cp is a
    multiple of 64, the weights resident under one tile of at most 64."""
    assert [ic.plan(c, 3, 3, 64, 2).bn for c in (1, 16, 17, 64, 127, 128,
                                                 512)] == [
        8, 16, 16, 64, 64, 128, 256]
    assert ic.plan(512, 3, 3, 512, 2) == ic.Plan(ic.IM2COL, 256, 3, 0)
    assert ic.plan(128, 3, 3, 128, 2) == ic.Plan(ic.IM2COL, 128, 4, 0)
    assert ic.plan(128, 1, 1, 256, 2) == ic.Plan(ic.IM2COL, 128, 3, 0)
    assert ic.plan(512, 3, 3, 512, 2, im2col=False) == ic.Plan(
        ic.GATHER, 128, 4, 0)
    assert ic.plan(64, 3, 3, 16, 2) == ic.Plan(ic.GATHER, 64, 8, 1)
    assert ic.plan(64, 3, 3, 64, 2) == ic.Plan(ic.IM2COL, 64, 16, 1)
    assert ic.padded_channels(1) == 16 and ic.padded_channels(64) == 64


def test_wrappers_refuse_cpu_tensors():
    before = (ic.conv_launches, ic.quantize_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ic.quantize_nhwc_cuda(torch.zeros(1, 2, 2, 16), torch.ones(()))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ic.int8_conv2d_nhwc_cuda(torch.zeros(1, 2, 2, 16, dtype=torch.int8),
                                 torch.zeros(4, 1, 1, 16, dtype=torch.int8),
                                 torch.ones(4), None, (1, 1), (0, 0, 0, 0),
                                 torch.float32)
    assert (ic.conv_launches, ic.quantize_launches) == before


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# (N, H, W, Cin, Cout, k, stride, (top, bottom, left, right)): the edges
CARD_CASES = [(1, 13, 17, 1, 64, 3, 1, (1, 1, 1, 1)),
              (2, 16, 16, 64, 1, 3, 1, (1, 1, 1, 1)),
              (3, 13, 17, 64, 128, 3, 2, (0, 1, 0, 1)),
              (2, 8, 8, 512, 512, 3, 1, (1, 1, 1, 1)),
              (2, 16, 16, 256, 128, 1, 1, (0, 0, 0, 0)),
              (4, 32, 32, 128, 16, 3, 1, (1, 1, 1, 1)),
              (1, 9, 7, 48, 24, 3, 2, (1, 1, 1, 1)),
              # the im2col design: 64-byte stages (Cp 192) with a ragged
              # Cout tile, stride 2 with the VAE's (0, 1) padding, a
              # 256-wide tile (K >= 2048), four 128-wide tiles (K < 2048)
              (2, 9, 11, 192, 200, 3, 1, (1, 1, 1, 1)),
              (3, 16, 16, 64, 128, 3, 2, (0, 1, 0, 1)),
              (2, 8, 8, 256, 512, 3, 1, (1, 1, 1, 1)),
              (5, 8, 8, 64, 512, 3, 1, (1, 1, 1, 1)),
              # the gather: K = 432 (not a multiple of 128), M = 129 (a tail
              # of one row), Cout 24 over two 16-wide tiles
              (1, 3, 43, 48, 24, 3, 1, (1, 1, 1, 1))]


def _codes(case, device, seed):
    n, h, w, cin, cout, k = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    cp = ic.padded_channels(cin)
    xq = torch.randint(-127, 128, (n, h, w, cp), generator=g, device=device,
                       dtype=torch.int8)
    xq[..., cin:] = 0
    wq = torch.randint(-127, 128, (cout, k, k, cp), generator=g, device=device,
                       dtype=torch.int8)
    wq[..., cin:] = 0
    scale = torch.rand(cout, generator=g, device=device) * 1e-4
    bias = torch.randn(cout, generator=g, device=device)
    return xq, wq, scale, bias


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_card_conv_kernel_equals_plain(cuda_device, case):
    """The same bits as the plain version (float64 conv on the card), fp32
    and bf16 out, with and without bias; one launch a call."""
    xq, wq, scale, bias = _codes(case, cuda_device, seed=case[3])
    strides, pad = (case[6],) * 2, case[7]
    for out in (torch.float32, torch.bfloat16):
        for b in (bias, None):
            before = ic.conv_launches
            got = ic.int8_conv2d_nhwc(xq, wq, scale, b, strides, pad, out)
            again = ic.int8_conv2d_nhwc(xq, wq, scale, b, strides, pad, out)
            assert ic.conv_launches == before + 2
            want = ic.int8_conv2d_nhwc_plain(xq, wq, scale, b, strides, pad,
                                             out)
            assert torch.equal(got, want) and torch.equal(got, again), case


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CARD_CASES[i] for i in (0, 1, 7, 8, 9, 11)])
def test_card_conv_every_plan_equals_plain(cuda_device, case):
    """Every plan kernel_timing.py sweeps (both designs, tile widths, ring
    depths, resident or streamed weights) gives the plain version's bits."""
    import kernel_timing

    n, h, w, cin, cout, k, s, pad = case
    xq, wq, scale, bias = _codes(case, cuda_device, seed=cout)
    fits = ic.im2col_fits(h, w, k, k, (s, s), pad)
    plan = ic.plan
    for out in (torch.float32, torch.bfloat16):
        want = ic.int8_conv2d_nhwc_plain(xq, wq, scale, bias, (s, s), pad, out)
        for cand in kernel_timing.int8_plans(cout, k, k, xq.shape[-1],
                                             out.itemsize, fits):
            ic.plan = lambda *a, c=cand: c
            try:
                got = ic.int8_conv2d_nhwc(xq, wq, scale, bias, (s, s), pad,
                                          out)
            finally:
                ic.plan = plan
            assert torch.equal(got, want), (case, cand, out)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 13, 17, 1), (2, 8, 8, 512),
                                   (1, 5, 7, 40), (3, 16, 16, 64)])
def test_card_quantize_kernel_equals_plain(cuda_device, shape):
    g = torch.Generator(device=cuda_device).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=cuda_device) * 4.0
    per_channel = torch.rand(shape[-1], generator=g, device=cuda_device) / 50 + 1e-3
    for dtype in (torch.float32, torch.bfloat16):
        for s in (per_channel, per_channel[0].clone()):
            got = ic.quantize_nhwc(x.to(dtype), s)
            assert torch.equal(got, ic.quantize_nhwc_plain(x.to(dtype), s))
            assert bool((got[..., shape[-1]:] == 0).all())


@pytest.mark.cuda
def test_card_one_kernel_a_call(cuda_device):
    """One kernel node each in a CUDA graph of one conv and one quantize."""
    xq, wq, scale, bias = _codes(CARD_CASES[2], cuda_device, seed=1)
    assert graph_node_types(lambda: ic.int8_conv2d_nhwc_cuda(
        xq, wq, scale, bias, (2, 2), (0, 1, 0, 1), torch.bfloat16)) == [KERNEL_NODE]
    x = torch.randn(2, 8, 8, 64, device=cuda_device)
    s = torch.full((64,), 0.05, device=cuda_device)
    assert graph_node_types(lambda: ic.quantize_nhwc_cuda(x, s)) == [KERNEL_NODE]


@pytest.mark.cuda
def test_card_qconv_matches_cpu(cuda_device):
    """A QConv in int8_static on the card equals the same conv on the CPU
    (the same codes from IEEE scales; the kernel has the plain bits)."""
    conv = tq.QConv(64, 32, 3, padding=1, mode="int8_static")
    torch.nn.init.normal_(conv.weight, std=0.05)
    conv.act_absmax.fill_(2.0)
    x = torch.randn(2, 64, 12, 12).contiguous(memory_format=torch.channels_last)
    want = conv(x)
    conv.to(cuda_device)
    assert torch.equal(conv(x.to(cuda_device)).cpu(), want)
