"""The PyTorch port's AutoencoderKL against the JAX package (CPU, fp32):
weights cross in both directions and give the same moments and
reconstruction, for the plain stem and the pixel-unshuffle stem; the
tolerances are those of tests/test_vae.py's torch-reference parity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL, from_torch_state_dict)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL, state_dict_from_flax)

SMALL = dict(in_channels=1, out_channels=1, block_out_channels=(32, 64),
             layers_per_block=1, latent_channels=4, norm_num_groups=8)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep these full-width convs from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _jax_params(jmodel, rng):
    """A JAX-layout param tree (the shapes of ``jmodel.init``) holding numpy
    values: scaled normals for kernels, and non-trivial norm scales and
    biases, so that every leaf's transfer shows in the outputs."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 1, 32, 32), jnp.float32))

    def make(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            fan_in = int(np.prod(leaf.shape[:-1]))
            v = rng.standard_normal(leaf.shape) / np.sqrt(fan_in)
        elif "scale" in name:
            v = 1.0 + 0.2 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes)


@pytest.mark.parametrize("pixel_unshuffle", [1, 4])
def test_weights_cross_both_ways(pixel_unshuffle, rng):
    kw = dict(SMALL, pixel_unshuffle=pixel_unshuffle)
    x = rng.random((2, 1, 32, 32)).astype(np.float32)
    jmodel = JAKL(**kw)
    variables = _jax_params(jmodel, rng)

    # JAX params -> port
    model = AutoencoderKL(**kw, device="cpu")
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    j_post = jmodel.apply(variables, jnp.asarray(x), method=jmodel.encode)
    j_recon = jmodel.apply(variables, j_post.mode(), method=jmodel.decode)
    with torch.no_grad():
        post = model.encode(torch.from_numpy(x))
        recon = model.decode(post.mode())
    np.testing.assert_allclose(post.parameters.numpy(),
                               np.asarray(j_post.parameters),
                               atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(recon.numpy(), np.asarray(j_recon),
                               atol=5e-4, rtol=1e-3)
    assert recon.shape == (2, 1, 32, 32)

    # port -> JAX, strictly: every key consumed, every param found
    back = from_torch_state_dict(
        jmodel, {k: v.numpy() for k, v in model.state_dict().items()},
        example_shape=(1, 1, 32, 32))
    flat_back = jax.tree_util.tree_leaves_with_path(back["params"])
    flat_orig = dict(jax.tree_util.tree_leaves_with_path(variables["params"]))
    assert len(flat_back) == len(flat_orig)
    for path, v in flat_back:
        np.testing.assert_array_equal(np.asarray(v), flat_orig[path])


def test_seeded_init_follows_flax_defaults():
    a = AutoencoderKL(**SMALL, device="cpu", seed=0)
    b = AutoencoderKL(**SMALL, device="cpu", seed=0)
    c = AutoencoderKL(**SMALL, device="cpu", seed=1)
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    w = a.decoder.up_blocks[0].resnets[0].conv1.weight      # 64 -> 64, 3x3
    assert not torch.equal(w, c.decoder.up_blocks[0].resnets[0].conv1.weight)
    # lecun normal: std 1/sqrt(fan_in), truncated at two sigma
    fan_in = w[0].numel()
    w = w.detach()
    assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05)
    assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert torch.equal(a.encoder.conv_norm_out.weight, torch.ones(64))
    assert torch.equal(a.quant_conv.bias, torch.zeros(8))


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKL(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AutoencoderKL(**SMALL, device="cuda")
    assert AutoencoderKL(**SMALL, device="cpu").quant_conv.weight.is_cpu


def test_unported_conv_modes_raise():
    """Every conv mode of the JAX package is ported now (the quantized ones
    are held to JAX in test_torch_port_quant.py); an unknown mode raises."""
    model = AutoencoderKL(**SMALL, conv_mode="int8", device="cpu")
    with torch.no_grad():
        assert torch.isfinite(model(torch.rand(1, 1, 32, 32))).all()
    with pytest.raises(ValueError, match="not in"):
        AutoencoderKL(**SMALL, conv_mode="int4", device="cpu")


def _count_epilogues(monkeypatch, module):
    """Calls of ``conv_epilogue`` made through ``module``'s name for it."""
    calls = []
    real = module.conv_epilogue

    def counted(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, "conv_epilogue", counted)
    return calls


def _random_(module, rng):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.from_numpy(0.3 * rng.standard_normal(p.shape)
                                     ).float())


@pytest.mark.parametrize("cin,cout,f", [(8, 8, 1.0), (8, 16, 1.0),
                                        (8, 16, 2.0)])
def test_resnet_block_folds_conv2_shortcut_and_residual(cin, cout, f, rng,
                                                        monkeypatch):
    """Native convs: conv1's epilogue adds its bias; conv2 and the shortcut
    run without bias and one epilogue adds both biases and the residual and
    divides by the output scale; fp32 within 1e-6 of the unfolded arithmetic
    (each conv with its bias, then (shortcut + h) / f)."""
    import torch.nn.functional as F

    from weatherforecastingtoolkit_tpu_torch.models.vae import blocks

    blk = blocks.ResnetBlock2D(cin, cout, groups=4, output_scale_factor=f)
    _random_(blk, rng)
    x = torch.from_numpy(rng.standard_normal((2, cin, 9, 7))).float()
    calls = _count_epilogues(monkeypatch, blocks)
    with torch.no_grad():
        got = blk(x)
        h = F.conv2d(blk.norm1(x), blk.conv1.weight, blk.conv1.bias, 1, 1)
        h = F.conv2d(blk.norm2(h), blk.conv2.weight, blk.conv2.bias, 1, 1)
        sc = blk.conv_shortcut
        r = x if sc is None else F.conv2d(x, sc.weight, sc.bias)
        want = (r + h) / f
    assert len(calls) == 2                   # conv1's bias, then the fold
    _, b, r, b_r, scale = calls[1]
    assert b is not None and scale == f
    assert (r is x) == (b_r is None) == (cin == cout)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("mode", ["int8", "fake_quant"])
def test_resnet_block_keeps_its_add_in_other_modes(mode, rng, monkeypatch):
    """A quantized conv2 keeps the block's own residual add: the block gives
    the bits of conv2(norm2(conv1(norm1(x)))) + shortcut(x), and makes no
    epilogue call of its own."""
    from weatherforecastingtoolkit_tpu_torch.models.vae import blocks

    blk = blocks.ResnetBlock2D(8, 16, groups=4, conv_mode=mode)
    _random_(blk, rng)
    x = torch.from_numpy(rng.standard_normal((2, 8, 9, 7))).float()
    calls = _count_epilogues(monkeypatch, blocks)
    with torch.no_grad():
        got = blk(x)
        want = (blk.conv_shortcut(x)
                + blk.conv2(blk.norm2(blk.conv1(blk.norm1(x)))))
    assert not calls and torch.equal(got, want)


def test_decode_exports_with_the_epilogue(rng):
    """torch.export of an AutoencoderKL decode (biases drawn, so each counts)
    calls ``wftk::conv_epilogue`` once for each native conv outside a resnet
    fold and once for each resnet block, and gives the eager bits."""
    from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
        ResnetBlock2D)
    from weatherforecastingtoolkit_tpu_torch.ops.quant import QConv

    model = AutoencoderKL(**SMALL, device="cpu").eval()
    _random_(model, rng)

    class Decode(torch.nn.Module):
        def forward(self, z):
            return model.decode(z)

    z = torch.from_numpy(rng.standard_normal((2, 4, 8, 8))).float()
    program = torch.export.export(Decode(), (z,))
    decode = [model.post_quant_conv, *model.decoder.modules()]
    convs = sum(isinstance(m, QConv) for m in decode)
    resnets = [m for m in decode if isinstance(m, ResnetBlock2D)]
    folded = sum(1 + (m.conv_shortcut is not None) for m in resnets)
    assert str(program.graph).count("wftk.conv_epilogue") == (
        convs - folded + len(resnets))
    with torch.no_grad():
        assert torch.equal(program.module()(z), model.decode(z))
