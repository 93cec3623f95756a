"""The port's advection-diffusion prior (ops/stencil.py) against the JAX
package, and its Hopper kernel (ops/cuda/stencil.py) against the plain
version on the card.

On the CPU the port's wrapper runs its plain version; the JAX side runs its
Pallas kernel in interpret mode and its XLA version, as
tests/test_stencil.py does. The ``cuda``-marked tests need an NVIDIA GPU and
nvcc and skip without a GPU. This file imports JAX only inside the tests that
compare with it, so the card's tests run where JAX is absent:
    python -m pytest --noconftest -m cuda tests/test_torch_port_stencil.py
"""

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops import stencil as ps
from weatherforecastingtoolkit_tpu_torch.ops.cuda import stencil as cs

from torch_port_card import KERNEL_NODE, graph_node_types

# (shape (B, T, C, H, W), u, v, kappa): C > 1, T = 2, H = W = 3, odd sizes
CASES = [((2, 3, 1, 16, 16), 0.5, 0.1, 0.05),
         ((1, 4, 3, 10, 12), 0.3, -0.2, 0.1),
         ((2, 2, 2, 3, 3), -1.0, 0.7, 0.2),
         ((1, 3, 1, 13, 9), 0.0, 0.0, 0.05)]


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _manual_residual(x, u, v, kappa):
    """Independent numpy version over (N, T, H, W) (tests/test_stencil.py)."""
    n, t, h, w = x.shape
    rs = []
    for i in range(n):
        for k in range(t - 1):
            x0, x1 = x[i, k], x[i, k + 1]
            dt = (x1 - x0)[1:-1, 1:-1]
            dh = (x0[2:, 1:-1] - x0[:-2, 1:-1]) / 2
            dw = (x0[1:-1, 2:] - x0[1:-1, :-2]) / 2
            lap = (x0[2:, 1:-1] + x0[:-2, 1:-1] + x0[1:-1, 2:] + x0[1:-1, :-2]
                   - 4 * x0[1:-1, 1:-1])
            rs.append(dt + u * dw + v * dh - kappa * lap)
    return float((np.stack(rs).astype(np.float64) ** 2).mean())


@pytest.mark.parametrize("shape,u,v,kappa", CASES)
def test_loss_matches_jax_pallas_and_xla(shape, u, v, kappa):
    """rel 1e-5: fp32 sums of up to a few thousand squares, in other orders."""
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops.pallas.stencil import (
        advection_diffusion_loss)

    x = _x(shape)
    got = float(ps.advection_diffusion_loss(torch.from_numpy(x), u, v, kappa))
    want_kernel = float(advection_diffusion_loss(
        jnp.asarray(x), u, v, kappa, use_pallas=True, interpret=True))
    want_xla = float(advection_diffusion_loss(jnp.asarray(x), u, v, kappa,
                                              use_pallas=False))
    assert got == pytest.approx(want_kernel, rel=1e-5)
    assert got == pytest.approx(want_xla, rel=1e-5)


@pytest.mark.parametrize("shape,u,v,kappa", CASES[:2])
def test_bf16_loss_and_gradients_match_jax(shape, u, v, kappa):
    """bf16 x, fp32 u, v, kappa: the loss within rel 1e-3 of the Pallas
    kernel (interpret mode) and the XLA version (bf16 rounding of the
    differences, which XLA may keep in more precision); gradients of the
    prior within rel 1e-2 of jax.grad of the JAX custom VJP."""
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops.pallas.stencil import (
        advection_diffusion_loss, advection_diffusion_prior)

    x = _x(shape, seed=11) * 4.0 - 2.0
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    coeffs = [jnp.asarray(c, jnp.float32) for c in (u, v, kappa)]
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = ps.advection_diffusion_loss(tx, u, v, kappa)
    assert got.dtype == torch.float32
    for use_pallas in (True, False):
        want = float(advection_diffusion_loss(jx, *coeffs, use_pallas=use_pallas,
                                              interpret=True))
        assert float(got) == pytest.approx(want, rel=1e-3)
    jgrads = jax.grad(lambda *a: advection_diffusion_prior(*a, True),
                      argnums=(0, 1, 2, 3))(jx, *coeffs)
    leaves = [tx.clone().requires_grad_()] + [
        torch.tensor(c, requires_grad=True) for c in (u, v, kappa)]
    ps.advection_diffusion_prior(*leaves).backward()
    assert leaves[0].grad.dtype == torch.bfloat16
    gx = np.asarray(jgrads[0].astype(jnp.float32))
    np.testing.assert_allclose(leaves[0].grad.float().numpy(), gx, rtol=1e-2,
                               atol=1e-2 * float(np.abs(gx).max()))
    for t, g in zip(leaves[1:], jgrads[1:]):
        assert float(t.grad) == pytest.approx(float(g), rel=1e-2, abs=1e-6)


def test_bf16_plain_version_rounds_each_difference():
    """The plain version on bf16 x equals an fp32 residual built from bf16
    differences, each operation rounded to bf16 (numpy, fp64-summed)."""
    import ml_dtypes  # noqa: F401  (numpy's bfloat16, installed with JAX)

    x = _x((1, 3, 9, 11), seed=12) * 8.0 - 4.0
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = float(ps.advection_diffusion_residual_reference(xb, 0.3, -0.2, 0.1))
    a = xb.float().numpy()
    bf = np.dtype("bfloat16")

    def r16(v):
        return np.asarray(v, np.float32).astype(bf).astype(np.float32)

    rs = []
    for k in range(a.shape[1] - 1):
        x0, x1 = a[0, k], a[0, k + 1]
        dt = r16(x1 - x0)[1:-1, 1:-1]
        dh = r16(r16(x0[2:, 1:-1] - x0[:-2, 1:-1]) * 0.5)
        dw = r16(r16(x0[1:-1, 2:] - x0[1:-1, :-2]) * 0.5)
        lap = r16(r16(r16(r16(x0[2:, 1:-1] + x0[:-2, 1:-1]) + x0[1:-1, 2:])
                      + x0[1:-1, :-2]) - r16(4.0 * x0[1:-1, 1:-1]))
        u, v, kap = (np.float32(c) for c in (0.3, -0.2, 0.1))
        rs.append(((dt + u * dw) + v * dh) - kap * lap)
    want = float((np.stack(rs).astype(np.float64) ** 2).mean())
    assert got == pytest.approx(want, rel=1e-5)


def test_plain_version_matches_numpy():
    """rel 1e-5 against an fp64-summed numpy residual over (N, T, H, W)."""
    x = _x((2, 4, 10, 12), seed=1)
    got = float(ps.advection_diffusion_residual_reference(
        torch.from_numpy(x), 0.3, -0.2, 0.1))
    assert got == pytest.approx(_manual_residual(x, 0.3, -0.2, 0.1), rel=1e-5)


def test_layout_is_b_t_c():
    """(B, T, C, H, W) pairs frames of one channel: the same as the plain
    version over (B*C, T, H, W)."""
    x = _x((2, 3, 2, 8, 8), seed=2)
    frames = np.ascontiguousarray(x.transpose(0, 2, 1, 3, 4)).reshape(4, 3, 8, 8)
    got = float(ps.advection_diffusion_loss(torch.from_numpy(x), 0.2, 0.1, 0.05))
    assert got == pytest.approx(_manual_residual(frames, 0.2, 0.1, 0.05),
                                rel=1e-5)


def test_linear_ramp_advecting_has_zero_residual():
    """A ramp moving left 1 px/frame satisfies dt + u*dw = 0 with u = -1
    (central differences are exact on a linear field)."""
    h, w, t = 16, 16, 4
    base = np.tile(np.arange(w, dtype=np.float32), (h, 1))
    x = np.stack([np.roll(base, -k, axis=1) for k in range(t)])[:, :, : w - t]
    got = float(ps.advection_diffusion_loss(
        torch.from_numpy(np.ascontiguousarray(x[None, :, None])), -1.0, 0.0, 0.0))
    assert got == pytest.approx(0.0, abs=1e-8)


def test_refusals():
    x = torch.from_numpy(_x((1, 1, 1, 8, 8)))
    with pytest.raises(ValueError, match="at least 2 frames"):
        ps.advection_diffusion_loss(x, 0.0, 0.0, 0.05)
    with pytest.raises(ValueError, match="at least 2 frames"):
        ps.advection_diffusion_prior(x, 0.0, 0.0, 0.05)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        ps.advection_diffusion_loss(torch.zeros(1, 2, 1, 8, 8,
                                                dtype=torch.float16), 0, 0, 0)
    with pytest.raises(ValueError, match=r"\(B, T, C, H, W\)"):
        ps.advection_diffusion_loss(torch.zeros(2, 8, 8), 0, 0, 0)
    before = cs.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.advection_stencil_cuda(torch.zeros(1, 2, 1, 8, 8), torch.zeros(3))
    assert cs.launches == before


def test_prior_gradients_match_jax():
    """Gradients for x, u, v and kappa against jax.grad of the JAX custom
    VJP (Pallas forward in interpret mode): rel 1e-5, atol 1e-8 on x."""
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops.pallas.stencil import (
        advection_diffusion_prior)

    x = _x((2, 3, 2, 12, 10), seed=3)
    coeffs = (0.2, 0.1, 0.05)
    jval, jgrads = jax.value_and_grad(
        lambda *a: advection_diffusion_prior(*a, True), argnums=(0, 1, 2, 3))(
        jnp.asarray(x), *(jnp.asarray(c) for c in coeffs))
    xt = torch.from_numpy(x).requires_grad_()
    ct = [torch.tensor(c, requires_grad=True) for c in coeffs]
    val = ps.advection_diffusion_prior(xt, *ct)
    val.backward()
    assert float(val.detach()) == pytest.approx(float(jval), rel=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[0]),
                               rtol=1e-5, atol=1e-8)
    for t, g in zip(ct, jgrads[1:]):
        assert t.grad.shape == ()
        assert float(t.grad) == pytest.approx(float(g), rel=1e-5)


def test_prior_kappa_gradient_matches_finite_difference():
    x = torch.from_numpy(_x((1, 3, 1, 12, 12), seed=4))
    k = torch.tensor(0.05, requires_grad=True)
    ps.advection_diffusion_prior(x, 0.2, 0.1, k).backward()
    eps = 1e-3
    f0, f1 = (float(ps.advection_diffusion_loss(x, 0.2, 0.1, 0.05 + s))
              for s in (-eps, eps))
    assert float(k.grad) == pytest.approx((f1 - f0) / (2 * eps), rel=2e-2)


def test_prior_gradient_scales_with_upstream():
    """The backward multiplies by the incoming gradient (JAX ``gr * g``)."""
    x = torch.from_numpy(_x((1, 3, 1, 8, 8), seed=5))
    a = x.clone().requires_grad_()
    ps.advection_diffusion_prior(a, 0.1, 0.2, 0.05).backward()
    b = x.clone().requires_grad_()
    (3.0 * ps.advection_diffusion_prior(b, 0.1, 0.2, 0.05)).backward()
    torch.testing.assert_close(b.grad, 3.0 * a.grad, rtol=1e-6, atol=0)


# ---------------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


CUDA_SHAPES = [(2, 12, 1, 128, 128), (3, 2, 4, 130, 97), (1, 5, 2, 3, 3),
               (2, 3, 1, 16, 16)]


@pytest.mark.cuda
def test_kernel_matches_plain(cuda_device):
    """Loss within rel 1e-5 of the plain version on the same card tensor;
    one launch per call; two runs give the same bits."""
    for i, shape in enumerate(CUDA_SHAPES):
        x = torch.from_numpy(_x(shape, seed=i)).to(cuda_device)
        params = torch.tensor([0.3, -0.2, 0.05], device=cuda_device)
        before = cs.launches
        got = ps.advection_diffusion_loss(x, *params)
        again = ps.advection_diffusion_loss(x, *params)
        torch.cuda.synchronize()
        assert cs.launches == before + 2
        assert torch.equal(got, again)
        want = ps.advection_diffusion_residual_reference(
            x.transpose(1, 2).reshape(-1, shape[1], shape[3], shape[4]),
            *params)
        assert float(got) == pytest.approx(float(want), rel=1e-5), shape


@pytest.mark.cuda
def test_kernel_matches_plain_bf16(cuda_device):
    """bf16 x: within rel 1e-5 of the plain version on the same card tensor
    (the same bf16 differences; another order of the fp32 sum), the same
    bits twice, aligned and unaligned widths."""
    for i, shape in enumerate(CUDA_SHAPES):
        x = torch.from_numpy(_x(shape, seed=20 + i) * 4.0 - 2.0).to(
            cuda_device, torch.bfloat16)
        params = torch.tensor([0.3, -0.2, 0.05], device=cuda_device)
        got = ps.advection_diffusion_loss(x, *params)
        assert torch.equal(got, ps.advection_diffusion_loss(x, *params))
        want = ps.advection_diffusion_residual_reference(
            x.transpose(1, 2).reshape(-1, shape[1], shape[3], shape[4]),
            *params)
        assert float(got) == pytest.approx(float(want), rel=1e-5), shape


@pytest.mark.cuda
def test_kernel_takes_a_non_contiguous_view(cuda_device):
    base = torch.from_numpy(_x((2, 12, 3, 64, 64), seed=7)).to(cuda_device)
    x = base[:, :, 1:2]                     # (2, 12, 1, 64, 64), offset view
    assert not x.is_contiguous()
    got = ps.advection_diffusion_loss(x, 0.3, 0.1, 0.05)
    want = ps.advection_diffusion_loss(x.contiguous(), 0.3, 0.1, 0.05)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_refusals(cuda_device):
    with pytest.raises(TypeError, match="fp32 or bf16"):
        cs.advection_stencil_cuda(
            torch.zeros(1, 2, 1, 8, 8, device=cuda_device, dtype=torch.float16),
            torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="H >= 3"):
        cs.advection_stencil_cuda(torch.zeros(1, 2, 1, 2, 8, device=cuda_device),
                                  torch.zeros(3, device=cuda_device))


@pytest.mark.cuda
def test_kernel_prior_gradients_match_plain(cuda_device):
    """Gradients of the kernel-forward prior equal the plain version's
    autograd for x, u, v and kappa (rel 1e-5)."""
    x = torch.from_numpy(_x((2, 4, 1, 32, 32), seed=8)).to(cuda_device)
    leaves = [x.clone().requires_grad_()] + [
        torch.tensor(c, device=cuda_device, requires_grad=True)
        for c in (0.2, -0.1, 0.05)]
    ps.advection_diffusion_prior(*leaves).backward()
    ref = [t.detach().clone().requires_grad_() for t in leaves]
    ps.advection_diffusion_residual_reference(
        ref[0].transpose(1, 2).reshape(-1, 4, 32, 32), *ref[1:]).backward()
    for got, want in zip(leaves, ref):
        torch.testing.assert_close(got.grad, want.grad, rtol=1e-5, atol=1e-9)


@pytest.mark.cuda
def test_kernel_same_bits_back_to_back_and_on_graph_replay(cuda_device):
    """The kernel's ticket counter returns to zero after every launch: two
    back-to-back calls, and a CUDA graph replayed twice, give the same
    bits; one operation on the card a call with device coefficients (one
    kernel node in a CUDA graph of the call)."""
    x = torch.from_numpy(_x((2, 12, 1, 128, 128), seed=9)).to(cuda_device)
    u, v, kappa = torch.tensor([0.3, -0.2, 0.05], device=cuda_device)
    first = ps.advection_diffusion_loss(x, u, v, kappa)
    assert torch.equal(first, ps.advection_diffusion_loss(x, u, v, kappa))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ps.advection_diffusion_loss(x, u, v, kappa)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ps.advection_diffusion_loss(x, u, v, kappa)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    assert torch.equal(replays[0], first) and torch.equal(replays[1], first)
    assert graph_node_types(lambda: ps.advection_diffusion_prior(
        x, u, v, kappa)) == [KERNEL_NODE]


@pytest.mark.cuda
def test_graph_replays_on_other_streams_beside_eager_calls(cuda_device):
    """Graphs of one call replayed on three streams at once (two captured on
    torch.cuda.graph's own capture stream, one on the stream that then runs
    eager calls beside the replays), each launch on another input, give the
    eager calls' bits every time and leave every ticket counter at zero: no
    two of these launches share a counter."""
    from chip_smoke import stencil_streams_check

    x = torch.from_numpy(_x((2, 12, 1, 128, 128), seed=10)).to(cuda_device)
    params = torch.tensor([0.3, -0.2, 0.05], device=cuda_device)
    assert stencil_streams_check(x, params) == 80


def test_ticket_slots(monkeypatch):
    """Ticket counters (pure bookkeeping, on the CPU): eager launches share
    one slot per stream; a captured launch takes a slot of its capture and
    stream, apart from every eager slot and every other capture's."""
    monkeypatch.setattr(cs, "_counters", {0: torch.zeros(4, dtype=torch.int32)})
    monkeypatch.setattr(cs, "_slots", {})
    monkeypatch.setattr(cs, "COUNTER_SLOTS", 4)
    base = cs._counters[0].data_ptr()

    def slot(capture, stream):
        return (cs._ticket(0, capture, stream) - base) // 4

    eager_a, eager_b = slot(0, 11), slot(0, 22)
    graph_a, graph_b = slot(7, 11), slot(8, 11)
    assert len({eager_a, eager_b, graph_a, graph_b}) == 4
    assert (slot(0, 11), slot(7, 11), slot(8, 11)) == (eager_a, graph_a,
                                                       graph_b)
    with pytest.raises(RuntimeError, match="more than 4"):
        slot(9, 11)
    with pytest.raises(RuntimeError, match="outside CUDA graph capture"):
        cs._ticket(1, 5, 11)


def test_band_plan():
    """The kernel's band and ring (pure, on the CPU): at the training batch
    of 2 the grid still has at least 64 blocks; every frame of a band fits
    on chip when it can; the ring fits its shared-memory budget."""
    for (b, t, c, h, w) in [(2, 12, 1, 128, 128), (32, 12, 1, 128, 128),
                            (3, 2, 4, 130, 97), (1, 5, 2, 3, 3)]:
        rows, ring = cs._band(b, c, t, h, w)
        bands = -(-(h - 2) // rows)
        assert 1 <= rows <= h - 2 and 2 <= ring <= cs.MAX_RING
        assert ring * (rows + 2) * w * 4 <= cs.SMEM_BUDGET
        if (b, t) == (2, 12):
            assert b * c * bands >= 64 and ring == t
    with pytest.raises(ValueError, match="too wide"):
        cs._band(1, 1, 4, 8, 100_000)


@pytest.mark.cuda
def test_kernel_in_the_alphapre_step(cuda_device, tmp_path):
    """One loss_fn + backward of experiments_gpu/alphapre's task (prior on,
    5 -> 4 frames of 16x16, dim 16) on the card: one stencil launch, its
    prior against the plain version on the step's prediction (rel 1e-5),
    finite loss."""
    import importlib.util
    from pathlib import Path

    from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
        synthetic_vil_events)
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    repo = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "_port_alphapre_train_card",
        repo / "experiments_gpu" / "alphapre" / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = Config.load(str(repo / "experiments" / "alphapre" / "config.yaml"))
    cfg = cfg.merged_dotlist(["model.T_in=5", "model.T_out=4",
                              "model.input_shape=[16,16]", "model.dim=16",
                              "model.n_layers=1", "model.spec_num=4",
                              "physics_prior.enabled=true"])
    task = mod.build_task(cfg)
    model = task.init_params(0, cuda_device)
    ev = synthetic_vil_events(2, 16, 16, 9, seed=0)
    vil = torch.from_numpy(np.ascontiguousarray(
        np.transpose(ev, (0, 3, 1, 2))[:, :, None])).to(cuda_device)
    cs.launches = 0
    loss, aux = task.loss_fn(model, {"vil": vil}, None, 0)
    loss.backward()
    torch.cuda.synchronize()
    assert cs.launches == 1
    with torch.no_grad():
        pred, _ = model.predict(vil[:, :5].float() * (1.0 / 255.0))
        want = ps._frames_reference(pred, 0.0, 0.0, 0.05)
    assert float(aux["physics_prior"]) == pytest.approx(float(want), rel=1e-5)
    assert np.isfinite(float(loss))
