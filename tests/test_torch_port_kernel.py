"""The GroupNorm+SiLU CUDA kernel against its plain version, on the card.

Needs an NVIDIA GPU and nvcc; skipped without a GPU. It imports no JAX, so
it runs where JAX is absent (``--noconftest`` skips tests/conftest.py):
    python -m pytest --noconftest -m cuda tests/test_torch_port_kernel.py
"""

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm as pgn

from torch_port_card import KERNEL_NODE, graph_node_types


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(shape, dtype, channels_last, device, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[1]
    x = torch.from_numpy((rng.standard_normal(shape) * 3.0 + 1.0)
                         .astype(np.float32)).to(device, dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    s = torch.from_numpy((rng.random(c) + 0.5).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(device)
    return x, s, b


def _within_tolerance(got, want):
    """fp32: 1e-4 (another reduction order); bf16: one bf16 ulp of the
    larger of the two results on top of that 1e-4 (two fp32 results 1e-4
    apart may round one ulp further apart)."""
    err = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        return bool((err <= 1e-4).all())
    mag = torch.maximum(got.float().abs(), want.float().abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return bool((err <= ulp + 1e-4).all())


SHAPES = [((3, 64, 32, 32), 32),   # vectorised NCHW and channels_last
          ((1, 128, 64, 64), 32),  # N=1: split statistics across blocks
          ((2, 512, 8, 8), 32),
          ((2, 24, 5, 7), 8)]      # odd sizes: the scalar path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels_last", [False, True])
def test_kernel_matches_plain(dtype, channels_last, cuda_device):
    for shape, groups in SHAPES:
        for silu, eps in ((True, 1e-6), (False, 1e-5)):
            x, s, b = _inputs(shape, getattr(torch, dtype), channels_last,
                              cuda_device)
            before = pgn.launches
            got = pgn.group_norm_silu(x, s, b, groups, eps, silu)
            torch.cuda.synchronize()
            assert pgn.launches == before + 1
            assert got.is_contiguous(memory_format=torch.channels_last
                                     if channels_last else
                                     torch.contiguous_format)
            want = pgn.group_norm_silu_reference(x, s, b, groups, eps, silu)
            assert _within_tolerance(got, want), (shape, silu)


@pytest.mark.cuda
def test_kernel_is_deterministic_and_takes_unaligned_views(cuda_device):
    x, s, b = _inputs((3, 64, 16, 16), torch.float32, False, cuda_device)
    a = pgn.group_norm_silu(x, s, b, 32)
    assert torch.equal(a, pgn.group_norm_silu(x, s, b, 32))
    flat = torch.cat([torch.zeros(1, device=cuda_device), x.flatten()])
    view = flat[1:].view_as(x)              # 4 bytes past an aligned address
    assert view.data_ptr() % 16
    torch.testing.assert_close(pgn.group_norm_silu(view, s, b, 32), a,
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        pgn.group_norm_silu(x.transpose(2, 3), s, b, 32)


@pytest.mark.cuda
def test_kernel_gradients_match_plain(cuda_device):
    x, s, b = _inputs((2, 32, 8, 8), torch.float32, True, cuda_device)
    g = torch.randn(x.shape, device=cuda_device)
    leaves = [t.clone().requires_grad_() for t in (x, s, b)]
    (pgn.group_norm_silu(*leaves, 8) * g).sum().backward()
    ref = [t.clone().requires_grad_() for t in (x, s, b)]
    (pgn.group_norm_silu_reference(*ref, 8, 1e-6, True) * g).sum().backward()
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_kernel_bits_bf16_params_ragged_one_kernel(dtype, cuda_device):
    """channels_last on the cluster kernel (a 128x128 frame whose slab spans
    a cluster, a ragged 130x97, N=1 and 3) with fp32 and bf16 scale/bias:
    within tolerance of the plain version, the same bits on two runs, and
    one operation on the card a call (no casts, no scratch fills: one
    kernel node in a CUDA graph of the call)."""
    dt = getattr(torch, dtype)
    for shape in ((1, 128, 128, 128), (3, 64, 130, 97), (2, 512, 8, 8)):
        for param_dtype in (torch.float32, torch.bfloat16):
            x, s, b = _inputs(shape, dt, True, cuda_device, seed=shape[1])
            s, b = s.to(param_dtype), b.to(param_dtype)
            got = pgn.group_norm_silu(x, s, b, 32)
            assert torch.equal(got, pgn.group_norm_silu(x, s, b, 32))
            want = pgn.group_norm_silu_reference(x, s, b, 32, 1e-6, True)
            assert _within_tolerance(got, want), (shape, param_dtype)
            assert graph_node_types(lambda: pgn.group_norm_silu_cuda(
                x, s, b, 32, 1e-6, True)) == [KERNEL_NODE], (shape,
                                                            param_dtype)


# (C, H, W) of CustomAutoencoderKL's GroupNorms at its default widths on
# 128x128 frames (models/vae/custom_akl.py)
CAKL_SHAPES = [(128, 128, 128), (256, 64, 64), (512, 32, 32), (512, 16, 16),
               (512, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_at_custom_akl_shapes(dtype, cuda_device):
    """The kernel against its plain version at every GroupNorm call shape
    of CustomAutoencoderKL (N=2, channels_last, SiLU on and off, its eps
    1e-6; the attention norm's 1e-5 without SiLU at 8x8), one kernel a
    call; fp32 1e-4, bf16 one ulp + 1e-4."""
    for c, h, w in CAKL_SHAPES:
        x, s, b = _inputs((2, c, h, w), getattr(torch, dtype), True,
                          cuda_device, seed=c + h)
        for silu, eps in ((True, 1e-6), (False, 1e-5)):
            got = pgn.group_norm_silu_cuda(x, s, b, 32, eps, silu)
            want = pgn.group_norm_silu_reference(x, s, b, 32, eps, silu)
            assert _within_tolerance(got, want), (c, h, w, silu)
        assert graph_node_types(lambda: pgn.group_norm_silu_cuda(
            x, s, b, 32, 1e-6, True)) == [KERNEL_NODE]


def _op_args(shape, groups, channels_last, device, requires_grad=True):
    x, s, b = _inputs(shape, torch.float32, channels_last, device)
    return (x.requires_grad_(requires_grad), s.requires_grad_(requires_grad),
            b.requires_grad_(requires_grad), groups, 1e-6, True)


@pytest.mark.parametrize("channels_last", [False, True])
def test_custom_op_registration_on_cpu(channels_last):
    """torch.ops.wftk.group_norm_silu: its fake implementation (shape,
    strides, dtype), its registered autograd and its schema pass
    torch.library.opcheck on CPU tensors (the op's CPU implementation is
    the plain version); the op's output and gradients are the plain
    version's."""
    args = _op_args((2, 16, 5, 7), 4, channels_last, torch.device("cpu"))
    torch.library.opcheck(torch.ops.wftk.group_norm_silu.default, args)
    y = torch.ops.wftk.group_norm_silu(*args)
    want = pgn.group_norm_silu_reference(*args)
    assert torch.equal(y, want)
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, args[:3], g)
    ref = torch.autograd.grad(want, args[:3], g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
def test_custom_op_on_the_card(channels_last, cuda_device):
    """On the card the op launches the kernel once a call (the launch
    count; in a CUDA graph one kernel node, three on NCHW's two-pass path),
    passes opcheck, gives the kernel's bits, and traces under torch.export
    (the fake implementation) to a graph that calls it."""
    args = _op_args((2, 64, 16, 16), 32, channels_last, cuda_device)
    torch.library.opcheck(torch.ops.wftk.group_norm_silu.default, args)
    before = pgn.launches
    y = pgn.group_norm_silu(*args)
    assert pgn.launches == before + 1
    assert torch.equal(y, pgn.group_norm_silu_cuda(*[
        a.detach() if isinstance(a, torch.Tensor) else a for a in args]))
    assert _within_tolerance(y, pgn.group_norm_silu_reference(*args))
    plain = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
    assert graph_node_types(lambda: pgn.group_norm_silu(*plain)) == [
        KERNEL_NODE] * (1 if channels_last else 3)

    class Norm(torch.nn.Module):
        def forward(self, x):
            return pgn.group_norm_silu(x, plain[1], plain[2], 32)

    program = torch.export.export(Norm(), (plain[0],))
    assert "wftk.group_norm_silu" in str(program.graph)
    assert torch.equal(program.module()(plain[0]), y.detach())
