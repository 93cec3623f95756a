"""The port's hand-written kernels as custom ops: ``wftk::int8_quantize``,
``wftk::int8_conv2d`` (ops/cuda/int8_conv.py), ``wftk::advection_stencil``
(ops/stencil.py) and ``wftk::conv_epilogue`` (ops/cuda/conv_epilogue.py,
whose own tests are in test_torch_port_conv_epilogue.py), and ``normal_kl``
against the JAX function.

On the CPU each op's implementation is its kernel's plain version:
``torch.library.opcheck`` (schema, fake implementation with a symbolic
batch, registered autograd), the plain version's bits and its autograd's
gradients, and ``torch.export`` of the Earthformer prior's forward. The
``cuda``-marked tests hold each op to its kernel on the card (opcheck on
CUDA tensors, the kernel's bits, one kernel node a call in a CUDA graph,
``torch.export``) and skip without a GPU. The file imports no JAX at module
level, so the card tests run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_port_ops.py
"""

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
from weatherforecastingtoolkit_tpu_torch.ops.cuda import conv_epilogue  # noqa: F401 (the op)
from weatherforecastingtoolkit_tpu_torch.ops.cuda import int8_conv as ic
from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

from torch_port_card import KERNEL_NODE, graph_node_types

# (C, per-channel scales, x dtype): C not a multiple of 16
QUANTIZE_CASES = [(20, True, torch.float32), (20, False, torch.bfloat16)]
# (bias, out dtype, strides, pad (top, bottom, left, right))
CONV_CASES = [(True, torch.float32, (2, 2), (0, 1, 0, 1)),
              (False, torch.bfloat16, (1, 1), (1, 1, 1, 1))]
STENCIL_DTYPES = [torch.float32, torch.bfloat16]
# the Earthformer prior's coefficients (experiments/earthformer/config.yaml
# has u = v = 0, kappa 0.05; nonzero u and v exercise every term)
COEFFS = (0.3, -0.2, 0.05)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _quantize_args(c, per_channel, dtype, device, seed=0):
    g = np.random.default_rng(seed)
    # channels of very different magnitudes, as after a GroupNorm+SiLU
    x = g.standard_normal((2, 5, 7, c)) * np.logspace(-1, 1, c)
    s = (np.abs(x).max(axis=(0, 1, 2)) * 0.8 / 127 if per_channel
         else np.array(np.abs(x).max() / 127))
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(s, dtype=torch.float32, device=device))


def _conv_args(bias, out_dtype, strides, pad, device, seed=0):
    g = np.random.default_rng(seed)
    cp, cout = 32, 24
    xq = torch.tensor(g.integers(-127, 128, (2, 9, 7, cp)), dtype=torch.int8,
                      device=device)
    wq = torch.tensor(g.integers(-127, 128, (cout, 3, 3, cp)),
                      dtype=torch.int8, device=device)
    scale = torch.tensor(g.random(cout) * 1e-3, dtype=torch.float32,
                         device=device, requires_grad=True)
    b = (torch.tensor(g.standard_normal(cout), dtype=torch.float32,
                      device=device, requires_grad=True) if bias else None)
    return xq, wq, scale, b, list(strides), list(pad), out_dtype


def _stencil_args(dtype, device, shape=(2, 4, 3, 9, 8), seed=0):
    g = np.random.default_rng(seed)
    x = torch.tensor(g.random(shape), dtype=dtype, device=device)
    return (x.requires_grad_(),) + tuple(
        torch.tensor(c, device=device, requires_grad=True) for c in COEFFS)


def _epilogue_args(device, seed=0):
    """bf16 channels_last h and residual, both biases, f = 0.5."""
    g = np.random.default_rng(seed)

    def t(shape):
        return torch.tensor(g.standard_normal(shape), dtype=torch.bfloat16,
                            device=device).requires_grad_()

    h, r = (t((2, 16, 5, 3)).detach().contiguous(
        memory_format=torch.channels_last).requires_grad_() for _ in "hr")
    return h, t((16,)), r, t((16,)), 0.5


def _leaves(args):
    return [a for a in args if isinstance(a, torch.Tensor) and a.requires_grad]


def _detached(args):
    return tuple(a.detach() if isinstance(a, torch.Tensor) else a
                 for a in args)


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("case", QUANTIZE_CASES)
def test_quantize_op_on_cpu(case):
    """opcheck; the op and ``quantize_nhwc`` give the plain version's
    codes (Cp = 32 channels, 20..31 zero); no kernel launch."""
    x, s = _quantize_args(*case, torch.device("cpu"))
    torch.library.opcheck(torch.ops.wftk.int8_quantize.default, (x, s))
    before = ic.quantize_launches
    want = ic.quantize_nhwc_plain(x, s)
    assert want.shape == (2, 5, 7, 32) and not want[..., 20:].any()
    assert torch.equal(torch.ops.wftk.int8_quantize(x, s), want)
    assert torch.equal(ic.quantize_nhwc(x.requires_grad_(), s), want)
    assert ic.quantize_launches == before


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_op_on_cpu(case):
    """opcheck (with scale and bias requiring grad); the op's output is the
    plain version's bits and its gradients in scale and bias the plain
    version's autograd's, bit for bit; no kernel launch."""
    args = _conv_args(*case, torch.device("cpu"))
    torch.library.opcheck(torch.ops.wftk.int8_conv2d.default, args)
    before = ic.conv_launches
    got = ic.int8_conv2d_nhwc(*args)
    want = ic.int8_conv2d_nhwc_plain(*args[:4], tuple(args[4]),
                                     tuple(args[5]), args[6])
    assert got.dtype == case[1] and torch.equal(got, want)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0)
                    ).to(got.dtype)
    leaves = _leaves(args)
    for a, b in zip(torch.autograd.grad(got, leaves, g),
                    torch.autograd.grad(want, leaves, g)):
        assert torch.equal(a, b)
    assert ic.conv_launches == before


@pytest.mark.parametrize("dtype", STENCIL_DTYPES)
def test_stencil_op_on_cpu(dtype):
    """opcheck; the op's loss is the plain version's bits and its gradients
    in x, u, v and kappa the plain version's autograd's, bit for bit;
    ``advection_diffusion_prior`` goes through the op; no kernel launch."""
    args = _stencil_args(dtype, torch.device("cpu"))
    torch.library.opcheck(torch.ops.wftk.advection_stencil.default, args)
    before = cs.launches
    got = ps.advection_diffusion_prior(*args)
    want = ps._frames_reference(*args)
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, want)
    assert torch.equal(ps.advection_diffusion_loss(*_detached(args)), want)
    for a, b in zip(torch.autograd.grad(got, args),
                    torch.autograd.grad(want, args)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cs.launches == before


@pytest.mark.parametrize("op", ["int8_quantize", "int8_conv2d",
                                "advection_stencil", "conv_epilogue"])
def test_cuda_tensors_reach_the_kernel_wrapper(op):
    """Each op has a kernel at the dispatcher's CUDA key (the kernel's
    wrapper, which launches or raises), its plain version at the CPU key,
    and nothing that would take a CUDA tensor to the plain version."""
    name = f"wftk::{op}"
    for key in ("CUDA", "CPU"):
        assert torch._C._dispatch_has_kernel_for_dispatch_key(name, key)
    for key in ("CompositeExplicitAutograd", "CompositeImplicitAutograd"):
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(name, key)


def test_launch_geometry_is_the_plan():
    """The conv wrapper's per-shape cache gives ``out_size`` and ``plan``
    as they are computed afresh, and refuses a conv with no output."""
    for h, w, cp, cout, k, strides, pad, nbytes in (
            (8, 8, 512, 512, 3, (1, 1), (1, 1, 1, 1), 2),
            (128, 128, 16, 64, 3, (1, 1), (1, 1, 1, 1), 2),
            (32, 32, 128, 128, 3, (2, 2), (0, 1, 0, 1), 4),
            (16, 16, 256, 64, 1, (1, 1), (0, 0, 0, 0), 4)):
        want = ic.out_size(h, w, k, k, strides, pad) + (ic.plan(
            cout, k, k, cp, nbytes,
            ic.im2col_fits(h, w, k, k, strides, pad)),)
        assert ic._geometry(h, w, cp, cout, k, k, strides, pad,
                            nbytes) == want
    with pytest.raises(ValueError, match="no output"):
        ic._geometry(2, 2, 16, 16, 3, 3, (1, 1), (0, 0, 0, 0), 4)


def test_b1_tick_script_on_cpu(capsys):
    """experiments_gpu/perf/int8_b1_tick.py at its narrow geometry on the
    CPU: a line a pipeline and round, then the JSON summary (no kernel
    launched on the CPU)."""
    import json
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from experiments_gpu.perf import int8_b1_tick

    int8_b1_tick.main(["--device", "cpu", "--narrow", "--reps", "1",
                       "--rounds", "1"])
    out = capsys.readouterr().out.strip().splitlines()
    result = json.loads(out[-1])["b1_tick"]
    assert sorted(result) == ["fast bf16", "fast int8_static",
                              "reference int8_static"]
    assert sum(line.startswith("round 0: ") for line in out) == 3
    for v in result.values():
        assert len(v["ms"]) == 1 and v["median_ms"] == v["ms"][0] > 0
        assert v["launches"] == [0, 0, 0]


class _Prior(torch.nn.Module):
    """The Earthformer task's prior term (experiments_gpu/earthformer/
    train.py: u, v and kappa one device tensor, read as three views)."""

    def __init__(self, device):
        super().__init__()
        self.register_buffer("coeffs", torch.tensor(COEFFS, device=device))

    def forward(self, pred):
        u, v, kappa = self.coeffs
        return ps.advection_diffusion_prior(pred, u, v, kappa)


def test_prior_exports_on_cpu():
    """torch.export of the prior's forward (symbolic batch) calls the op
    and gives the eager bits at the export batch and another."""
    prior = _Prior("cpu")
    x = _stencil_args(torch.float32, "cpu", (2, 5, 1, 16, 16))[0].detach()
    program = torch.export.export(prior, (x,), dynamic_shapes={
        "pred": {0: torch.export.Dim("b")}})
    assert str(program.graph).count("wftk.advection_stencil") == 1
    for b in (2, 3):
        xb = _stencil_args(torch.float32, "cpu", (b, 5, 1, 16, 16),
                           seed=b)[0].detach()
        assert torch.equal(program.module()(xb), prior(xb))


def test_normal_kl_matches_jax():
    """normal_kl against the JAX function at broadcast shapes (tensors and
    a Python number), rel 1e-6."""
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.models.vae.distributions import (
        normal_kl as jax_normal_kl)
    from weatherforecastingtoolkit_tpu_torch.models.vae.distributions import (
        normal_kl)

    g = np.random.default_rng(0)
    args = [g.standard_normal(s).astype(np.float32)
            for s in ((2, 3, 4), (3, 1), (1, 4), ())]
    for mixed in (args, args[:3] + [0.5]):
        got = normal_kl(*[torch.from_numpy(np.asarray(a))
                          if isinstance(a, np.ndarray) else a for a in mixed])
        want = np.asarray(jax_normal_kl(*[
            jnp.asarray(a) if isinstance(a, np.ndarray) else a
            for a in mixed]))
        assert got.shape == want.shape == (2, 3, 4)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    with pytest.raises(TypeError, match="tensor"):
        normal_kl(0.0, 0.0, 1.0, 1.0)


# ----------------------------------------------------------------- the card
def _one_kernel_and_export(fn, args, op_name):
    """One kernel node for a call (CUDA graph), and torch.export of a
    module calling fn traces the op and gives the eager result's bits."""
    assert graph_node_types(lambda: fn(*args)) == [KERNEL_NODE]

    class Call(torch.nn.Module):
        def forward(self, x):
            return fn(x, *args[1:])

    program = torch.export.export(Call(), (args[0],))
    assert f"wftk.{op_name}" in str(program.graph)
    assert torch.equal(program.module()(args[0]), fn(*args))


# opcheck's parts that run the CUDA implementations; its AOT-dispatch part
# traces the registrations the CPU tests already trace, at 20 s of the card
# run's time
CARD_OPCHECK = ("test_schema", "test_autograd_registration", "test_faketensor")


@pytest.mark.cuda
def test_ops_pass_opcheck_on_the_card(cuda_device):
    """torch.library.opcheck of the three ops on CUDA tensors (the CUDA
    implementations launch the kernels): per-channel fp32 quantize, the
    stride-2 conv with bias, the fp32 stencil."""
    for op, args in (
            (torch.ops.wftk.int8_quantize.default,
             _quantize_args(*QUANTIZE_CASES[0], cuda_device)),
            (torch.ops.wftk.int8_conv2d.default,
             _conv_args(*CONV_CASES[0], cuda_device)),
            (torch.ops.wftk.advection_stencil.default,
             _stencil_args(torch.float32, cuda_device)),
            (torch.ops.wftk.conv_epilogue.default,
             _epilogue_args(cuda_device))):
        torch.library.opcheck(op, args, test_utils=CARD_OPCHECK)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANTIZE_CASES)
def test_quantize_op_on_the_card(case, cuda_device):
    """One launch a call, the kernel's codes (the plain version's); one
    kernel node; torch.export."""
    x, s = _quantize_args(*case, cuda_device)
    before = ic.quantize_launches
    got = ic.quantize_nhwc(x, s)
    assert ic.quantize_launches == before + 1
    assert torch.equal(got, ic.quantize_nhwc_cuda(x, s))
    assert torch.equal(got.cpu(), ic.quantize_nhwc_plain(x.cpu(), s.cpu()))
    _one_kernel_and_export(ic.quantize_nhwc, (x, s), "int8_quantize")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_op_on_the_card(case, cuda_device):
    """One launch a forward, the kernel's bits (the plain version's);
    gradients in scale and bias within rel 1e-5 of the CPU op's (the
    backward recomputes the sums with the kernel: one more launch); one
    kernel node; torch.export."""
    args = _conv_args(*case, cuda_device)
    before = ic.conv_launches
    got = ic.int8_conv2d_nhwc(*args)
    assert ic.conv_launches == before + 1
    plain = _detached(args)
    assert torch.equal(got.detach(), ic.int8_conv2d_nhwc_cuda(
        *plain[:4], tuple(plain[4]), tuple(plain[5]), plain[6]))
    cpu = tuple(a.detach().cpu().requires_grad_(a.requires_grad)
                if isinstance(a, torch.Tensor) else a for a in args)
    want = ic.int8_conv2d_nhwc(*cpu)
    assert torch.equal(got.detach().cpu(), want.detach())
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0)
                    ).to(got.dtype)
    before = ic.conv_launches
    grads = torch.autograd.grad(got, _leaves(args), g.to(cuda_device))
    assert ic.conv_launches == before + 1
    for a, b in zip(grads, torch.autograd.grad(want, _leaves(cpu), g)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=0)
    _one_kernel_and_export(ic.int8_conv2d_nhwc, plain, "int8_conv2d")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", STENCIL_DTYPES)
def test_stencil_op_on_the_card(dtype, cuda_device):
    """One launch a call, the kernel's bits, within rel 1e-5 of the plain
    version; gradients the CPU op's within rel 1e-5; one kernel node;
    torch.export of the prior's forward."""
    args = _stencil_args(dtype, cuda_device)
    before = cs.launches
    got = ps.advection_diffusion_prior(*args)
    assert cs.launches == before + 1
    plain = _detached(args)
    assert torch.equal(got.detach(), cs.advection_stencil_cuda_scalars(*plain))
    cpu = tuple(a.detach().cpu().requires_grad_() for a in args)
    want = ps.advection_diffusion_prior(*cpu)
    torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-5,
                               atol=0)
    for a, b in zip(torch.autograd.grad(got, args),
                    torch.autograd.grad(want, cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)
    assert graph_node_types(lambda: ps.advection_diffusion_loss(*plain)) == [
        KERNEL_NODE]
    prior = _Prior(cuda_device)
    program = torch.export.export(prior, (plain[0],))
    assert "wftk.advection_stencil" in str(program.graph)
    before = cs.launches
    assert torch.equal(program.module()(plain[0]), prior(plain[0]))
    assert cs.launches == before + 2
