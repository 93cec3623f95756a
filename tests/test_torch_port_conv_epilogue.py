"""The conv bias epilogue ``wftk::conv_epilogue`` (ops/cuda/conv_epilogue.py):
y = ((h + b_h) + (r + b_r)) / f in fp32, one rounding to h's dtype.

On the CPU the op's implementation is the plain version: opcheck (schema,
fake implementation, registered autograd), its bits against ATen's ``h + b``
and its gradients against the plain version's autograd, and the launch plan
(``_plan``) at every conv output of the two serving VAEs. The ``cuda``-marked
tests hold the kernel to the plain version on the card at those shapes, and
profile a reference-shape serving call. The file imports no JAX, so the card
tests run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_port_conv_epilogue.py
"""

import math

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops.cuda import conv_epilogue as ce

# (dtype, channels_last, residual, f)
OP_CASES = [(torch.float32, True, True, 0.5), (torch.bfloat16, True, False, 1.0),
            (torch.bfloat16, False, True, 1.0), (torch.float16, False, False, 2.0)]
# the two serving VAEs (nowcast_bench/configs/akl_ref.json, akl_fast.json)
VAES = {"akl_ref": dict(in_channels=1, out_channels=1,
                        block_out_channels=(64, 128, 256, 512, 512),
                        layers_per_block=1, latent_channels=64,
                        norm_num_groups=32),
        "akl_fast": dict(in_channels=1, out_channels=1,
                         block_out_channels=(128, 256, 512),
                         layers_per_block=1, latent_channels=64,
                         norm_num_groups=32, pixel_unshuffle=4)}
H100_SMS = 132


def _args(dtype, channels_last, residual, f, device="cpu", shape=(2, 12, 5, 7),
          grad=True, seed=0):
    g = np.random.default_rng(seed)
    c = shape[1]

    def t(s):
        return torch.tensor(g.standard_normal(s), dtype=dtype, device=device)

    h, r = t(shape), t(shape)
    if channels_last:
        h = h.contiguous(memory_format=torch.channels_last)
        r = r.contiguous(memory_format=torch.channels_last)
    args = [h, t((c,)), r if residual else None, t((c,)) if residual else None]
    if grad:
        args = [a if a is None else a.requires_grad_() for a in args]
    return tuple(args) + (f,)


def _serving_outputs(name):
    """(C, H, W) of every ``wftk::conv_epilogue`` call of one frame's encode
    and decode through the VAE, from fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    shapes = set()

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.wftk.conv_epilogue.default:
                shapes.add(tuple(args[0].shape[1:]))
            return func(*args, **(kwargs or {}))

    vae = AutoencoderKL(**VAES[name], device="cpu")
    with FakeTensorMode(allow_non_fake_inputs=True), Record():
        vae.decode(vae.encode(torch.zeros(1, 1, 128, 128)).mode())
    return sorted(shapes)


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("case", OP_CASES)
def test_op_on_cpu(case):
    """opcheck; the op is the plain version's bits, in h's dtype and layout;
    its gradients are the plain version's autograd's (the bias sums in
    another order: rel 1e-6); no kernel launch."""
    args = _args(*case)
    torch.library.opcheck(torch.ops.wftk.conv_epilogue.default, args)
    before = ce.launches
    got = ce.conv_epilogue(*args)
    want = ce.conv_epilogue_reference(*args)
    assert got.dtype == args[0].dtype and torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last) == case[1]
    leaves = [a for a in args[:4] if a is not None]
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0)
                    ).to(got.dtype)
    for a, b in zip(torch.autograd.grad(got, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)
    assert ce.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_bias_alone_is_atens_add(dtype):
    """The bias alone, in fp32 and rounded once, is ATen's ``h + b`` bit for
    bit; with nothing to add ``conv_epilogue`` hands h back; a residual of
    a wider dtype promotes as ``h + r`` does."""
    h, b, r, _, _ = _args(dtype, True, True, 1.0, grad=False)
    assert torch.equal(ce.conv_epilogue(h, b), h + b[:, None, None])
    assert ce.conv_epilogue(h) is h
    y = ce.conv_epilogue(h, b, r.double())
    assert y.dtype == torch.float64
    torch.testing.assert_close(y, h.double() + b.double()[:, None, None]
                               + r.double(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", sorted(VAES))
def test_plan_at_every_serving_conv(name):
    """At every conv output of the VAE, at N = 1 and at the cell's batch of
    frames (832 or 3328 encoded, 768 or 3072 decoded; both taken for each
    shape), in both layouts and both load widths: the channels_last grid
    holds a period of channel vectors and at most what the SMs hold at once
    unless a period needs more; an NCHW block is 32 to 256 threads, a power
    of two, and no more blocks than planes."""
    shapes = _serving_outputs(name)
    assert len(shapes) >= 6
    frames = 832 if name == "akl_ref" else 3328
    for c, hh, ww in shapes:
        for n in (1, frames):
            numel = n * c * hh * ww
            for vec in (1, 8):
                grid, threads = ce._plan(numel, c, hh * ww, True, vec,
                                         H100_SMS)
                period = c // math.gcd(c, vec)
                assert threads == ce.THREADS
                assert grid * threads >= period
                assert grid <= max(H100_SMS * 8, -(-period // threads))
                assert grid * threads * 2 * vec >= min(
                    numel, H100_SMS * ce.RESIDENT_THREADS * 2 * vec)
                if (hh * ww) % vec:
                    continue
                grid, threads = ce._plan(numel, c, hh * ww, False, vec,
                                         H100_SMS)
                assert threads in (32, 64, 128, 256) and grid <= n * c


# ----------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _ulp(t, dtype):
    """One unit in the last place of |t| in dtype, elementwise (fp32)."""
    bits = {torch.bfloat16: 8, torch.float16: 11, torch.float32: 24}[dtype]
    mag = t.float().abs().clamp_min(1e-30)
    return torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - bits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VAES))
def test_card_kernel_at_every_serving_conv(name, cuda_device):
    """At every conv output of the VAE (N = 2), bf16 and fp32, channels_last
    and NCHW, with and without the residual, the second bias and f != 1: the
    kernel gives the plain version's bits (the same fp32 operations in the
    same order); the bias alone is ATen's ``h + b`` bit for bit; the folded
    residual lies within two ulps of its largest term from the unfolded
    arithmetic (rounded after each add, as the block did before the fold:
    three roundings of half an ulp against one)."""
    for c, hh, ww in _serving_outputs(name):
        for dtype in (torch.bfloat16, torch.float32):
            for cl in (True, False):
                for residual in (False, True):
                    for f in (1.0, 0.5):
                        h, b, r, br, _ = _args(dtype, cl, residual, f,
                                               cuda_device, (2, c, hh, ww),
                                               grad=False, seed=c + hh)
                        for b_r in ((br, None) if residual else (None,)):
                            got = ce.conv_epilogue_cuda(h, b, r, b_r, f)
                            want = ce.conv_epilogue_reference(h, b, r, b_r, f)
                            assert torch.equal(got, want), (c, hh, ww, dtype,
                                                            cl, residual, f)
                            assert c == 1 or got.is_contiguous(
                                memory_format=torch.channels_last) == cl
                        if not residual and f == 1.0:
                            assert torch.equal(got, h + b[:, None, None])
                        if residual and f == 1.0:
                            hb, rb = h + b[:, None, None], r + br[:, None, None]
                            two = hb + rb
                            got = ce.conv_epilogue_cuda(h, b, r, br, f)
                            most = torch.maximum(torch.maximum(
                                hb.float().abs(), rb.float().abs()),
                                two.float().abs())
                            assert bool(((got.float() - two.float()).abs()
                                         <= 2 * _ulp(most, dtype)).all())


@pytest.mark.cuda
def test_card_serving_call_has_no_bias_add(cuda_device):
    """A profiled reference-shape bf16 serving call (B = 64) runs no ATen
    unvectorised add (``elementwise_kernel<128, 4, ...CUDAFunctor_add``) in
    the VAE, and its epilogue launches: one a native conv that is no
    resnet's conv2 or shortcut, one a resnet block's fold."""
    from torch.profiler import ProfilerActivity, profile

    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        ResnetBlock2D)
    from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv

    vae = AutoencoderKL(**VAES["akl_ref"], seed=0).to(torch.bfloat16)
    frames = torch.rand((64 * 13, 1, 128, 128), device=cuda_device,
                        dtype=torch.bfloat16)

    @torch.inference_mode()
    def call():
        return vae.decode(vae.encode(frames).mode()[:64 * 12])

    call()
    torch.cuda.synchronize()
    ce.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    convs = sum(isinstance(m, QConv) for m in vae.modules())
    resnets = [m for m in vae.modules() if isinstance(m, ResnetBlock2D)]
    folded = sum(1 + (m.conv_shortcut is not None) for m in resnets)
    assert ce.launches == convs - folded + len(resnets)
    names = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert not [k for k in names if "elementwise_kernel<128, 4" in k
                and "CUDAFunctor_add" in k], names
    assert any("epi_channels_last" in k for k in names)
