"""The PyTorch port's AutoencoderKL at the reference serving shape —
block_out_channels (64,128,256,512,512), a 64x8x8 latent — against the JAX
package on one 128x128 frame (CPU). The only tests that carry the key map
through the 512-channel and attention layers."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL, from_torch_state_dict)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.models.vae.blocks import (
    GroupNormSiLU)

REFERENCE = dict(in_channels=1, out_channels=1,
                 block_out_channels=(64, 128, 256, 512, 512),
                 layers_per_block=1, latent_channels=64, norm_num_groups=32)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep these full-width convs from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def shared():
    """The port's seeded VAE, the JAX VAE on its weights, and one frame."""
    model = AutoencoderKL(**REFERENCE, device="cpu")
    jmodel = JAKL(**REFERENCE)
    variables = from_torch_state_dict(
        jmodel, {k: v.numpy() for k, v in model.state_dict().items()})
    x = np.random.default_rng(0).random((1, 1, 128, 128)).astype(np.float32)
    return model, jmodel, variables, x


def _jax_codec(jmodel, variables, x, dtype):
    variables = jax.tree_util.tree_map(lambda a: a.astype(dtype), variables)
    post = jmodel.apply(variables, jnp.asarray(x, dtype), method=jmodel.encode)
    recon = jmodel.apply(variables, post.mode(), method=jmodel.decode)
    return (np.asarray(post.parameters.astype(jnp.float32)),
            np.asarray(recon.astype(jnp.float32)))


def _port_codec(model, x, dtype):
    with torch.no_grad():
        post = model.encode(torch.from_numpy(x).to(dtype))
        recon = model.decode(post.mode())
    return post.parameters.float().numpy(), recon.float().numpy()


def test_reference_shape_matches_jax(shared):
    model, jmodel, variables, x = shared
    # 40 GroupNorm+SiLU (15 encoder, 25 decoder) + 2 attention norms
    norms = [m for m in model.modules() if isinstance(m, GroupNormSiLU)]
    assert len(norms) == 42
    assert sum(not m.silu for m in norms) == 2

    j_moments, j_recon = _jax_codec(jmodel, variables, x, jnp.float32)
    moments, recon = _port_codec(model, x, torch.float32)
    assert moments.shape == (1, 128, 8, 8)
    np.testing.assert_allclose(moments, j_moments, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(recon, j_recon, atol=5e-4, rtol=1e-3)


def test_reference_shape_bf16_error_matches_jax(shared):
    """The bf16 serving recipe (bf16 params and activations) departs from
    fp32 by as much in the port as in the JAX package on the same weights,
    so a bf16-vs-fp32 SSIM measured on the card is the reference's too."""
    model, jmodel, variables, x = shared

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    j32 = _jax_codec(jmodel, variables, x, jnp.float32)
    j16 = _jax_codec(jmodel, variables, x, jnp.bfloat16)
    p32 = _port_codec(model, x, torch.float32)
    p16 = _port_codec(copy.deepcopy(model).to(torch.bfloat16), x,
                      torch.bfloat16)
    for jf, jb, pf, pb in zip(j32, j16, p32, p16):
        jax_err, port_err = rel(jb, jf), rel(pb, pf)
        assert 0.005 < jax_err < 0.05                  # bf16 noise, not a bug
        assert port_err == pytest.approx(jax_err, rel=0.2)
