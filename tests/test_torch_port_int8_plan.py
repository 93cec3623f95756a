"""The int8 conv kernel's plan (``ops/cuda/int8_conv.py::plan``) at every int8
conv call shape of the two quantized serving calls, the packed weight
operand, and the weight side that ``QConv`` keeps between calls, on the CPU.

The call shapes come from the port's own VAEs, run on the ``meta`` device
with each int8 conv recorded instead of computed: the reference-shape VAE in
``int8_static`` at the batch call (B=64: 832 frames encoded, 768 latents
decoded) and the fast VAE under ``INT8_MIXED_SPEC`` at B=256 (3328 frames
encoded). Each plan is checked against an H100's limits: 232,448 bytes of
shared memory a block, the wgmma widths of s8, and tiles that cover the
ragged ends of K and Cout.
"""

import collections

import pytest
import torch

from chip_smoke import (FAST_VAE, INT8_EDGE_CASES, INT8_MIXED_SPEC,
                        LATENT_SHAPE, REFERENCE_VAE)
from weatherforecastingtoolkit_tpu_torch.models.vae import blocks
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.ops import quant as tq
from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic

H100_SMEM_PER_BLOCK = 232448
# s8 wgmma's N: 8, 16, 24, 32, then multiples of 16 up to 256
WGMMA_S8_WIDTHS = {8, 16, 24, 32} | set(range(48, 257, 16))
# path -> (VAE, conv mode, frames encoded, latents decoded, int8 convs a call)
PATHS = {"int8_static reference B=64": (REFERENCE_VAE, "int8_static", 832,
                                        768, 56),
         "int8-mixed fast VAE B=256": (FAST_VAE, INT8_MIXED_SPEC, 3328, 0, 4)}


def _call_shapes(path):
    """Counter of (N, H, W, Cin, Cout, k, stride, padding) over the int8
    convs of one call of `path`."""
    cfg, mode, n_enc, n_dec, _ = PATHS[path]
    calls = collections.Counter()
    forward = tq.QConv.forward

    def record(mod, x):
        if mod.resolved not in ("int8", "int8_static"):
            return forward(mod, x)
        n, c, h, w = x.shape
        kh, kw = mod.weight.shape[2:]
        calls[(n, h, w, c, mod.weight.shape[0], kh, mod.stride[0],
               mod.pad)] += 1
        ho, wo = ic.out_size(h, w, kh, kw, mod.stride, mod.pad)
        return torch.empty((n, mod.weight.shape[0], ho, wo), device="meta")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tq.QConv, "forward", record)
        mp.setattr(blocks, "group_norm_silu", lambda x, *a, **k: x)
        mp.setattr(AutoencoderKL, "_init_weights", lambda self, rng: None)
        vae = AutoencoderKL(**cfg, conv_mode=mode, device="meta")
        with torch.no_grad():
            if n_enc:
                vae.encode(torch.zeros(n_enc, 1, 128, 128, device="meta"))
            if n_dec:
                vae.decode(torch.zeros((n_dec,) + LATENT_SHAPE,
                                       device="meta"))
    return calls


@pytest.fixture(scope="module")
def call_shapes():
    return {path: _call_shapes(path) for path in PATHS}


def _all_shapes(call_shapes):
    shapes = {key for calls in call_shapes.values() for key in calls}
    return sorted(shapes) + [c[:7] + (c[7],) for c in INT8_EDGE_CASES]


@pytest.mark.parametrize("path", list(PATHS))
def test_call_shapes_are_the_serving_paths(call_shapes, path):
    """56 int8 convs a reference-shape int8_static call, 4 (the encoder's
    mid-block) a fast-VAE int8-mixed call, as chip_smoke.py counts on the
    card."""
    assert sum(call_shapes[path].values()) == PATHS[path][4]


@pytest.mark.parametrize("out_bytes", [4, 2])
def test_every_call_shape_has_a_legal_plan(call_shapes, out_bytes):
    """Each serving shape and edge case: a wgmma design at a legal s8 width,
    the widest tile Cout fills, a ring that fits the shared memory, tiles
    that cover K and Cout, and the im2col design wherever TMA's im2col mode
    takes the geometry and Cp is a multiple of 64."""
    for n, h, w, cin, cout, k, s, pad in _all_shapes(call_shapes):
        cp = ic.padded_channels(cin)
        kk = k * k * cp
        fits = ic.im2col_fits(h, w, k, k, (s, s), pad)
        design, bn, stages, resident = ic.plan(cout, k, k, cp, out_bytes,
                                               fits)
        where = (f"N={n} {h}x{w} {cin}->{cout} k{k} s{s} {pad}: plan "
                 f"{(design, bn, stages, resident)}")
        assert design == (ic.IM2COL if fits and cp % 64 == 0 else
                          ic.GATHER), where
        assert bn in WGMMA_S8_WIDTHS and bn in ic.WS_WIDTHS, where
        assert bn == (ic.ws_width(cout) if design == ic.IM2COL else
                      min(ic.ws_width(cout), ic.GATHER_MAX_BN)), where
        assert bn <= 128 or design == ic.IM2COL, where  # the gather's sums
        bk = ic.stage_k(design, cp)
        assert bk in (64, 128) and (design == ic.GATHER or cp % bk == 0), \
            where
        smem = ic.ws_smem_bytes(bn, out_bytes, stages, kk, resident, bk)
        assert ic.MIN_STAGES <= stages and smem <= H100_SMEM_PER_BLOCK, where
        assert not resident or cout <= bn, where       # one Cout tile
        k_tiles = -(-kk // bk)
        assert k_tiles * bk >= kk and (k_tiles - 1) * bk < kk, where
        n_tiles = -(-cout // bn)
        assert n_tiles * bn >= cout and (n_tiles - 1) * bn < cout, where


def test_serving_shapes_take_the_im2col_design(call_shapes):
    """Every serving shape but conv_in (Cin = 1, padded to 16) reads its
    input rows by TMA in im2col mode; the 3x3 convs whose one tile of at
    most 64 spans Cout hold all of their weights in shared memory, with the
    deepest ring (8 stages of 128 bytes of K, 16 of 64); the others stream
    them through 3 stages (256-wide tiles, 1x1 kernels) or 4."""
    for path, calls in call_shapes.items():
        for n, h, w, cin, cout, k, s, pad in calls:
            cp = ic.padded_channels(cin)
            plan = ic.plan(cout, k, k, cp, 2,
                           ic.im2col_fits(h, w, k, k, (s, s), pad))
            assert plan.design == (ic.GATHER if cin == 1 else ic.IM2COL), (
                path, cin, plan)
            assert plan.resident == int(cout <= plan.bn <= 64 and k > 1), (
                path, cin, cout, plan)
            ring = 3 if plan.bn == 256 or k == 1 else 4
            assert plan.stages == (ring if not plan.resident else
                                   8 * 128 // ic.stage_k(plan.design, cp)), (
                path, cin, cout, plan)


@pytest.mark.parametrize("h,w,k,s,pad,fits", [
    (128, 128, 3, 1, (1, 1, 1, 1), True),
    (128, 128, 3, 2, (0, 1, 0, 1), True),
    (13, 17, 3, 2, (0, 1, 0, 1), True),
    (8, 8, 1, 1, (0, 0, 0, 0), True),
    (64, 64, 3, 9, (0, 0, 0, 0), False),         # stride above 8
    (300, 300, 3, 1, (200, 200, 0, 0), False),   # a corner past -128
])
def test_im2col_fits(h, w, k, s, pad, fits):
    assert ic.im2col_fits(h, w, k, k, (s, s), pad) is fits


def test_plan_past_64_taps():
    """im2col takes any kernel size; the gather's tap masks hold 64 taps,
    so a 9x9 kernel outside im2col has no kernel and the plan says so."""
    assert ic.plan(64, 9, 9, 64, 2).design == ic.IM2COL
    assert ic.plan(64, 8, 8, 16, 2).design == ic.GATHER
    with pytest.raises(ValueError, match="at most 64 taps"):
        ic.plan(64, 9, 9, 16, 2)
    with pytest.raises(ValueError, match="at most 64 taps"):
        ic.plan(64, 9, 9, 64, 2, im2col=False)


@pytest.mark.parametrize("cin,cout,k", [(1, 64, 3), (48, 24, 1), (64, 1, 3),
                                        (512, 512, 3)])
def test_packed_weights_round_trip_to_the_codes(cin, cout, k):
    """The packed operand is the (Cout, K) matrix, K = k * k * Cp, whose rows
    hold each output channel's codes tap by tap with Cin padded by zero
    codes: cutting the padding off gives ``_weight_codes``' codes back."""
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(cout, k, k, cin, generator=g) * 0.1
    s_a = torch.rand(cin, generator=g) + 0.5
    wq, scale, _, _ = tq._int8_operands(w, None, s_a * 127, torch.device("cpu"))
    codes, s_w = tq._weight_codes(w, tq._act_scale(s_a * 127))
    cp = ic.padded_channels(cin)
    assert wq.is_contiguous() and wq.shape == (cout, k, k, cp)
    matrix = wq.reshape(cout, k * k * cp)
    assert torch.equal(matrix.reshape(cout, k, k, cp)[..., :cin], codes)
    assert not matrix.reshape(cout, k, k, cp)[..., cin:].any()
    assert torch.equal(scale, s_w)


# ------------------------------------------------------ the QConv's cache
def _qconv(mode, cin=24, cout=16, seed=0):
    conv = tq.QConv(cin, cout, 3, padding=1, mode=mode)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.1)
        conv.bias.copy_(torch.randn(cout, generator=g) * 0.1)
        if conv.act_absmax is not None:
            conv.act_absmax.copy_(torch.rand(cin, generator=g) * 3 + 0.5)
    x = torch.randn(2, cin, 9, 7, generator=g).contiguous(
        memory_format=torch.channels_last)
    return conv, x


def _functional(conv, x):
    """The uncached functional conv on the module's parameters, NCHW."""
    xn = x.permute(0, 2, 3, 1)
    kernel = conv.weight.permute(2, 3, 1, 0)
    pad = ((1, 1), (1, 1))
    if conv.resolved == "int8":
        y = tq.int8_conv(xn, kernel, conv.bias, 1, pad)
    else:
        y = tq.int8_conv_static(xn, kernel, conv.bias, 1, pad,
                                conv.act_absmax)
    return y.permute(0, 3, 1, 2)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_cached_qconv_equals_the_functional_conv(mode):
    conv, x = _qconv(mode)
    first = conv(x)
    cached = conv._int8_cache
    assert cached is not None
    again = conv(x)
    assert conv._int8_cache is cached       # the weight side was reused
    want = _functional(conv, x)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert set(conv.state_dict()) == {"weight", "bias"}


@pytest.mark.parametrize("mode,change", [
    (mode, change) for mode in ("int8", "int8_static")
    for change in ("in_place", "load_state_dict", "bf16")] + [
    ("int8_static", "load_qscales")])
def test_cache_is_rebuilt_when_the_weights_change(mode, change):
    """After each change the conv serves the functional conv's bits on the
    new weights, never the old codes."""
    conv, x = _qconv(mode)
    stale = conv(x)
    other, _ = _qconv(mode, seed=1)
    if change == "in_place":
        with torch.no_grad():
            conv.weight.mul_(-2.0)
    elif change == "load_state_dict":
        conv.load_state_dict(other.state_dict())
    elif change == "bf16":
        conv.to(torch.bfloat16)
        x = x.to(torch.bfloat16)
    else:
        with torch.no_grad():
            conv.act_absmax.copy_(other.act_absmax)
    got = conv(x)
    assert torch.equal(got, _functional(conv, x))
    assert not torch.equal(got.float(), stale.float())


def test_vae_load_qscales_rebuilds_the_cache():
    """AutoencoderKL.load_qscales copies new scales into every int8_static
    conv: the next call serves codes folded with them."""
    cfg = dict(in_channels=1, out_channels=1, block_out_channels=(8, 16),
               layers_per_block=1, latent_channels=4, norm_num_groups=4)
    vae = AutoencoderKL(**cfg, conv_mode="int8_static", seed=0, device="cpu")
    x = torch.rand(2, 1, 16, 16)
    with torch.no_grad():
        before = vae.encode(x).mode()
        convs = [m for m in vae.modules() if isinstance(m, tq.QConv)
                 and m.act_absmax is not None]
        vae.load_qscales({m.path: torch.full(m.act_absmax.shape, 2.5)
                          for m in convs})
        after = vae.encode(x).mode()
        fresh = AutoencoderKL(**cfg, conv_mode="int8_static", seed=0,
                              device="cpu")
        fresh.load_qscales({m.path: torch.full(m.act_absmax.shape, 2.5)
                            for m in convs})
        want = fresh.encode(x).mode()
    assert torch.equal(after, want) and not torch.equal(after, before)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_cache_under_inference_mode(mode):
    """A conv made outside inference mode caches inside it; one whose
    parameters are inference tensors (no version counter) builds its weight
    side on every call. Both give the functional conv's bits."""
    conv, x = _qconv(mode)
    with torch.inference_mode():
        got = conv(x)
        again = conv(x)
        assert conv._int8_cache is not None
    want = _functional(conv, x)
    assert torch.equal(got, want) and torch.equal(again, want)
    with torch.inference_mode():
        made_inside, _ = _qconv(mode)
        assert made_inside.weight.is_inference()
        made_inside.load_state_dict(conv.state_dict())
        if made_inside.act_absmax is not None:
            made_inside.act_absmax.copy_(conv.act_absmax)
        first = made_inside(x)
        assert made_inside._int8_cache is None
        made_inside.weight.mul_(0.5)
        second = made_inside(x)
        want_second = _functional(made_inside, x)
    assert torch.equal(first, want)
    assert torch.equal(second, want_second)
    assert not torch.equal(second, first)
