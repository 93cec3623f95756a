"""The port's transformer blocks and Earthformer against the JAX package
on the same weights and numpy inputs (CPU).

flax params are carried across with ``earthformer_state_dict_from_flax``;
the same converter maps the flax gradients onto the port's parameter names,
so gradients compare name by name. The zero-initialised ``unpatch`` head of
``residual_out`` is replaced by random weights on both sides: with it at
zero the output is exactly persistence and a parity test would be blind past
that layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import transformer as jtf
from weatherforecastingtoolkit_tpu.models.earthformer import (
    Earthformer as JEarthformer)
from weatherforecastingtoolkit_tpu_torch.models import transformer as ptf
from weatherforecastingtoolkit_tpu_torch.models.earthformer import (
    Earthformer, earthformer_state_dict_from_flax)

SMALL = dict(t_in=5, t_out=4, in_channels=1, patch=4, dim=32, depth=2,
             num_heads=4, window=(4, 4))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _random_head(params, rng):
    p = params["params"]["unpatch"]
    p["kernel"] = (rng.standard_normal(p["kernel"].shape) * 0.05).astype(np.float32)
    p["bias"] = (rng.standard_normal(p["bias"].shape) * 0.05).astype(np.float32)
    return params


@pytest.mark.parametrize("hierarchy,global_tokens,residual_out", [
    (1, 0, True), (2, 0, False), (1, 2, False), (2, 2, True)])
def test_earthformer_forward_and_grads_match_flax(hierarchy, global_tokens,
                                                  residual_out, rng):
    """Forward atol 2e-5 (fp32, other summation orders through ~12 layers);
    parameter gradients of <out, g> rel 1e-4 of each tensor's largest
    gradient. A parameter off the output's path (the last encoder block's
    global-vector update when hierarchy=1) gets None in torch, zeros in JAX."""
    kw = dict(SMALL, hierarchy=hierarchy, global_tokens=global_tokens,
              residual_out=residual_out)
    x = rng.random((2, 5, 1, 32, 32)).astype(np.float32)
    # the clip's bounds: the gradient splits there, as in JAX
    x[:, -1, 0, :4, :4] = 0.0
    g = rng.standard_normal((2, 4, 1, 32, 32)).astype(np.float32)
    jm = JEarthformer(**kw)
    params = _random_head(_np_tree(jm.init(jax.random.key(0), jnp.asarray(x))),
                          rng)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x))
        return jnp.sum(out * jnp.asarray(g)), out

    jgrads, want = jax.jit(jax.grad(jloss, has_aux=True))(params)
    jgrads = earthformer_state_dict_from_flax(_np_tree(jgrads))

    pm = Earthformer(**kw, img_size=32, device="cpu")
    pm.load_state_dict(earthformer_state_dict_from_flax(params), strict=True)
    out = pm(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    (out * torch.from_numpy(g)).sum().backward()
    for name, p in pm.named_parameters():
        want_g = jgrads[name].numpy()
        got_g = np.zeros_like(want_g) if p.grad is None else p.grad.numpy()
        scale = max(float(np.abs(want_g).max()), 1e-6)
        np.testing.assert_allclose(got_g / scale, want_g / scale, atol=1e-4,
                                   err_msg=name)


def test_state_dict_names_cover_the_module():
    """Every flax leaf lands on a port parameter and none is left over."""
    for kw in (dict(hierarchy=2, global_tokens=2), dict()):
        m = dict(SMALL, **kw)
        shapes = jax.eval_shape(JEarthformer(**m).init, jax.random.key(1),
                                jnp.zeros((1, 5, 1, 32, 32)))
        sd = earthformer_state_dict_from_flax(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes))
        pm = Earthformer(**m, img_size=32, device="cpu")
        assert set(sd) == set(pm.state_dict())
        for k, v in pm.state_dict().items():
            assert sd[k].shape == v.shape, k


def test_residual_out_starts_at_persistence_and_init_follows_flax(rng):
    x = torch.from_numpy(rng.random((1, 5, 1, 32, 32)).astype(np.float32))
    m = Earthformer(**SMALL, residual_out=True, img_size=32, device="cpu")
    assert torch.equal(m(x), x[:, -1:].expand(-1, 4, -1, -1, -1))
    assert torch.equal(m.cuboid[0].norm1.weight, torch.ones(32))
    assert float(m.st_pos.detach().std()) == pytest.approx(0.02, rel=0.05)
    # flax's lecun-normal fan_in of the (kh, kw, in, out) head: 4*4*32
    head = Earthformer(**SMALL, img_size=32, device="cpu").unpatch.weight
    assert float(head.detach().std()) == pytest.approx((16 * 32) ** -0.5,
                                                     rel=0.15)
    same = Earthformer(**SMALL, img_size=32, device="cpu", seed=0)
    assert torch.equal(same.unpatch.weight, head)


def test_transformer_encoder_and_decoder_match_flax(rng):
    """Post-LN encoder and pre-LN decoder (cross-attention to a wider
    memory): atol 1e-5."""
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    mem = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jenc = jtf.TransformerEncoder(depth=2, dim=16, num_heads=4, ffn_dim=32)
    penc = ptf.TransformerEncoder(depth=2, dim=16, num_heads=4, ffn_dim=32)
    params = _np_tree(jenc.init(jax.random.key(0), jnp.asarray(x)))
    penc.load_state_dict(ptf.transformer_state_dict_from_flax(params))
    np.testing.assert_allclose(
        penc(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jenc.apply(params, jnp.asarray(x))), atol=1e-5)

    jdec = jtf.TransformerDecoder(depth=2, dim=16, num_heads=4, ffn_dim=32)
    pdec = ptf.TransformerDecoder(depth=2, dim=16, num_heads=4, ffn_dim=32,
                                  memory_dim=24)
    params = _np_tree(jdec.init(jax.random.key(1), jnp.asarray(x),
                                jnp.asarray(mem)))
    pdec.load_state_dict(ptf.transformer_state_dict_from_flax(params))
    np.testing.assert_allclose(
        pdec(torch.from_numpy(x), torch.from_numpy(mem)).detach().numpy(),
        np.asarray(jdec.apply(params, jnp.asarray(x), jnp.asarray(mem))),
        atol=1e-5)


def test_attention_matches_jax_dot_product_attention(rng):
    q, k, v = (rng.standard_normal((2, s, 4, 8)).astype(np.float32)
               for s in (6, 9, 9))
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v))
    got = ptf.dot_product_attention(*(torch.from_numpy(t) for t in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_earthformer_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Earthformer(**SMALL, img_size=32)
    m = Earthformer(**SMALL, img_size=32, device="cpu")
    assert m.st_pos.is_cpu
    with pytest.raises(ValueError, match="5 input frames"):
        m(torch.zeros(1, 4, 1, 32, 32))
