"""Gradients of the port's int8 conv modes against ``jax.grad`` of the JAX
package's ``int8_conv`` and ``int8_conv_static``, on the CPU.

In both packages the int8 codes carry no gradient (they are rounded), so
the gradients flow through the scales and the bias: to x through the dynamic
activation scale s_x = max|x| / 127, to the kernel through the weight scale
s_w = max|w| / 127 (per output channel), and to the bias. The JAX functions
run eagerly, as the JAX package's own tests run them (under ``jax.jit`` XLA
divides by 127 as a product with the reciprocal, which the port does not
copy). The forward values are the same bits; the gradients are sums over
the output in another order, so they are held to rel 1e-5 of their largest
magnitude.

The ``cuda``-marked test holds the card's gradients (the kernel forward,
the plain version's autograd backward) to the CPU's and skips without a
GPU:
    python -m pytest --noconftest -m cuda tests/test_torch_port_quant_grad.py
"""

import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu_torch.ops import quant as tq

# x (N, H, W, Cin), kernel (k, k, Cin, Cout), stride, padding
CASES = [((2, 8, 8, 16), 3, 32, 1, 1),
         ((2, 9, 7, 20), 3, 24, 2, ((0, 1), (0, 1))),
         ((1, 6, 6, 64), 1, 16, 1, 0)]
GRAD_RTOL = 1e-5


def _inputs(case, seed):
    shape, k, cout = case[:3]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    kernel = (rng.standard_normal((k, k, shape[-1], cout)) * 0.1
              ).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    absmax = (np.abs(x).max(axis=(0, 1, 2)) * 0.8).astype(np.float32)
    return x, kernel, bias, absmax


def _jax_grads(mode, x, kernel, bias, absmax, stride, padding):
    import jax
    import jax.numpy as jnp
    from weatherforecastingtoolkit_tpu.ops import quant as jq

    def loss(xx, kk, bb):
        if mode == "int8":
            y = jq.int8_conv(xx, kk, bb, stride, padding)
        else:
            y = jq.int8_conv_static(xx, kk, bb, stride, padding,
                                    jnp.asarray(absmax))
        return jnp.sum(y ** 2)

    with jax.disable_jit():
        grads = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    return [np.asarray(g) for g in grads]


def _port_grads(mode, x, kernel, bias, absmax, stride, padding, device="cpu"):
    tx, tk, tb = (torch.tensor(a, device=device, requires_grad=True)
                  for a in (x, kernel, bias))
    if mode == "int8":
        y = tq.int8_conv(tx, tk, tb, stride, padding)
    else:
        y = tq.int8_conv_static(tx, tk, tb, stride, padding,
                                torch.tensor(absmax, device=device))
    torch.sum(y ** 2).backward()
    # int8_static's x reaches the output only through its int8 codes: no
    # gradient (None), where jax.grad gives zeros
    return [np.zeros(t.shape, np.float32) if t.grad is None
            else t.grad.cpu().numpy() for t in (tx, tk, tb)]


def _close(got, want, rtol=GRAD_RTOL):
    for g, w, name in zip(got, want, ("x", "kernel", "bias")):
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0][-1]}->{c[2]}k{c[1]}s{c[3]}")
def test_int8_functional_grads_match_jax(mode, case):
    x, kernel, bias, absmax = _inputs(case, seed=case[2])
    stride = (case[3],) * 2
    want = _jax_grads(mode, x, kernel, bias, absmax, stride, case[4])
    got = _port_grads(mode, x, kernel, bias, absmax, stride, case[4])
    _close(got, want)
    if mode == "int8_static":       # the calibrated scales: no x gradient
        assert not np.abs(want[0]).any() and not np.abs(got[0]).any()


def test_roadmap_fault_record_sums():
    """The sums the fault record measured with JAX (x (2,8,8,16), a
    (3,3,16,32) kernel, loss sum(y^2)): the port's QConv gives them now."""
    x, kernel, bias, _ = _inputs(CASES[0], seed=0)
    want = _jax_grads("int8", x, kernel, bias, None, (1, 1), 1)
    conv = tq.QConv(16, 32, 3, padding=1, mode="int8")
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
    tx = torch.tensor(x, requires_grad=True)
    y = conv(tx.permute(0, 3, 1, 2))
    torch.sum(y ** 2).backward()
    got = [tx.grad.numpy(), conv.weight.grad.permute(2, 3, 1, 0).numpy(),
           conv.bias.grad.numpy()]
    _close(got, want)


@pytest.mark.parametrize("mode", ["int8", "int8_static"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qconv_grads_match_functional(mode, dtype):
    """QConv in the int8 modes gives the functional conv's gradients for x,
    weight and bias, fp32 and bf16 parameters, with its weight side cached:
    a second backward after an optimizer-like in-place edit of the weight
    sees the new weight."""
    x, kernel, bias, absmax = _inputs(CASES[1], seed=3)
    conv = tq.QConv(20, 24, 3, stride=2, padding=((0, 1), (0, 1)), mode=mode)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(bias))
        if mode == "int8_static":
            conv.act_absmax.copy_(torch.from_numpy(absmax))
    conv = conv.to(dtype)
    for edit in range(2):
        conv.zero_grad()
        tx = torch.tensor(x, requires_grad=True)
        y = conv(tx.permute(0, 3, 1, 2).to(dtype))
        torch.sum(y.float() ** 2).backward()
        tk = conv.weight.detach().permute(2, 3, 1, 0).clone().requires_grad_()
        tb = conv.bias.detach().clone().requires_grad_()
        tx2 = torch.tensor(x, requires_grad=True)
        fn = tq.int8_conv if mode == "int8" else (
            lambda *a: tq.int8_conv_static(*a, conv.act_absmax))
        y2 = fn(tx2.to(dtype), tk, tb, (2, 2), ((0, 1), (0, 1)))
        torch.sum(y2.float() ** 2).backward()
        assert torch.equal(y.permute(0, 2, 3, 1), y2)
        assert torch.equal(conv.weight.grad, tk.grad.permute(3, 2, 0, 1))
        assert torch.equal(conv.bias.grad, tb.grad)
        if mode == "int8":
            assert torch.equal(tx.grad, tx2.grad)
        else:
            assert tx.grad is None and tx2.grad is None
        assert conv.weight.grad.abs().sum() > 0
        with torch.no_grad():
            conv.weight.mul_(1.5)


def test_qconv_int8_without_grad_keeps_its_cache():
    """Under no_grad (serving) the cached weight side is used as it is; a
    call that records autograd rebuilds only the scale and the bias, from
    the same code, so the outputs are the same bits."""
    conv = tq.QConv(16, 8, 3, padding=1, mode="int8")
    torch.nn.init.normal_(conv.weight, std=0.1)
    x = torch.randn(2, 16, 6, 6)
    with torch.no_grad():
        a = conv(x)
        cached = conv._int8_cache
        b = conv(x)
    assert conv._int8_cache is cached and torch.equal(a, b)
    c = conv(x)
    assert c.requires_grad and torch.equal(a, c)
    assert conv._int8_cache is cached


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "int8_static"])
def test_card_int8_grads_equal_cpu(mode):
    """On the card (the conv kernel forward, the plain version's autograd
    backward with fp32(acc) recomputed by the kernel): the CPU's gradients
    within rel 1e-5 of their largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for case in CASES:
        x, kernel, bias, absmax = _inputs(case, seed=case[2])
        stride = (case[3],) * 2
        want = _port_grads(mode, x, kernel, bias, absmax, stride, case[4])
        got = _port_grads(mode, x, kernel, bias, absmax, stride, case[4],
                          device="cuda")
        _close(got, want)
