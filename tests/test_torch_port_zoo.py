"""The port's model zoo against the JAX package, on the CPU: the same numpy
inputs and the same weights (carried across by each module's
``*_state_dict_from_flax``) through both, at small widths.

Covered: ``CustomAutoencoderKL`` (2x and 4x resamplers; the embedding;
remat), the FIR resamplers, ``ViTAE`` (token and flat paths), the token
forecasters, the latent AEs (``ConvModel`` at its fixed widths,
``ConvAttnModel``) and the transposed-conv geometry of ``ConvModel``'s
decoder, the Path-A AEs, ``StructuredConvAE`` (with and without its latent
transformer), the registry, and the ``ae_recon``/``token_vit`` experiment
tasks. (The GroupNorm kernel at ``CustomAutoencoderKL``'s call shapes on
the card: tests/test_torch_port_kernel.py, which imports no JAX.)

Forwards agree within 1e-5 unless a test says why not. Every comparison runs
a deterministic path (no dropout, the posterior's mode): JAX's RNG and a
``torch.Generator`` draw different numbers.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import latent_ae as jlat
from weatherforecastingtoolkit_tpu.models import legacy as jleg
from weatherforecastingtoolkit_tpu.models import path_a as jpa
from weatherforecastingtoolkit_tpu.models import registry as jreg
from weatherforecastingtoolkit_tpu.models import token_forecaster as jtok
from weatherforecastingtoolkit_tpu.models import vit_ae as jvit
from weatherforecastingtoolkit_tpu.models.vae import blocks as jblocks
from weatherforecastingtoolkit_tpu.models.vae import custom_akl as jakl
from weatherforecastingtoolkit_tpu_torch.models import latent_ae as plat
from weatherforecastingtoolkit_tpu_torch.models import legacy as pleg
from weatherforecastingtoolkit_tpu_torch.models import path_a as ppa
from weatherforecastingtoolkit_tpu_torch.models import registry as preg
from weatherforecastingtoolkit_tpu_torch.models import token_forecaster as ptok
from weatherforecastingtoolkit_tpu_torch.models import vit_ae as pvit
from weatherforecastingtoolkit_tpu_torch.models.vae import blocks as pblocks
from weatherforecastingtoolkit_tpu_torch.models.vae import custom_akl as pakl
from weatherforecastingtoolkit_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
SMALL_AKL = dict(block_out_channels=(8, 16), latent_channels=4,
                 norm_num_groups=4, latent_hw=8, timeseries_dim=32)
SMALL_VIT = dict(img_size=32, patch=8, d_token=16, d_latent=32, depth_enc=2,
                 depth_dec=2, heads=2)
# the last encoder block keeps 8 channels a GroupNorm group at 1x1, as the
# JAX defaults' 1024 channels keep 128: with one a group, (x - mean) * rstd
# is rounding noise times 1000
SMALL_PA = dict(latent_dim=8, enc_channels=(4, 8, 16, 32, 64),
                dec_channels=(8, 8, 4, 4, 4))
SMALL_AC = dict(latent_dim=8, initial_res=4, embed_dim=16, num_heads=2,
                num_layers=2, enc_channels=(4, 8, 64), enc_strides=(2, 2, 8),
                dec_channels=(8, 8, 4))
SMALL_SC = dict(latent_channels=4, latent_hw=8, enc_channels=(8, 16),
                dec_channels=(16, 8, 8), num_blocks=1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _init(module, *args, seed=0, method=None):
    """Variables with the module's flax structure (``jax.eval_shape`` of
    its init: flax's own init compiles for seconds on the CPU), drawn with
    numpy: kernels normal / sqrt(fan_in), biases 0.1 normal, norm scales
    1 + 0.1 normal (so that a misplaced bias or scale shows), every other
    leaf (embeddings, queries) 0.3 normal."""
    rng = np.random.default_rng(seed)
    kw = {} if method is None else {"method": method}
    tree = jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a, **kw),
                          *[jnp.zeros(s) for s in args])

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.3 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _apply(jmod, params, *args, method=None, out=None):
    """The JAX module's apply (``method`` by name) under jax.jit: one
    compile, where eager dispatch compiles every primitive at its shape.
    ``out`` maps the result to arrays."""
    kw = {} if method is None else {"method": method}

    def fn(p, *a):
        r = jmod.apply(p, *a, **kw)
        return r if out is None else out(r)

    return jax.jit(fn)(params, *[jnp.asarray(a) for a in args])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _pair(jmod, pmod, convert, *shapes, seed=0):
    params = _init(jmod, *shapes, seed=seed)
    pmod.load_state_dict(convert(_np(params)), strict=True)
    return params


@pytest.fixture(scope="module")
def cases():
    """kind -> (JAX module, its variables, frames (2, 1, 32, 32), the JAX
    forward's (recon, z)) of a frame AE at small width, made once a module
    for the forward test and the experiment-task test (one XLA compile
    each)."""
    made = {}

    def case(kind):
        if kind not in made:
            j = {"vit_ae": lambda: jvit.ViTAE(**SMALL_VIT),
                 "structured_conv_ae": lambda: jleg.StructuredConvAE(**SMALL_SC),
                 "conv_autoencoder": lambda: jpa.ConvAutoencoder(**SMALL_PA)
                 }[kind]()
            params = _init(j, (1, 1, 32, 32))
            x = _x((2, 1, 32, 32))
            made[kind] = j, params, x, _apply(j, params, x)
        return made[kind]

    return case


CONVERT = {"vit_ae": pvit.vit_ae_state_dict_from_flax,
           "structured_conv_ae": pleg.structured_conv_ae_state_dict_from_flax,
           "conv_autoencoder": ppa.path_a_state_dict_from_flax}


# ------------------------------------------------------ CustomAutoencoderKL
@pytest.mark.parametrize("scales,hw", [(None, 16), ((4, 2), 32)],
                         ids=["2x", "4x"])
def test_custom_akl_forward_matches_jax(scales, hw):
    """recon, z_timeseries and the posterior's mean and logvar; the 4x
    variant stacks two stride-2 resamplers in the first block (scales)."""
    cfg = dict(SMALL_AKL, scales=scales)
    j = jakl.CustomAutoencoderKL(**cfg)
    t = pakl.CustomAutoencoderKL(**cfg, device="cpu")
    params = _pair(j, t, pakl.state_dict_from_flax, (1, 1, hw, hw))
    x = _x((2, 1, hw, hw))
    jr, jz, jmean, jlogvar = _apply(
        j, params, x, out=lambda r: (r[0], r[1], r[2].mean, r[2].logvar))
    with torch.no_grad():
        pr, pz, ppost = t(torch.from_numpy(x))
    _close(pz, jz)
    _close(ppost.mean, jmean)
    _close(ppost.logvar, jlogvar)
    _close(pr, jr)
    z = _x((2, 4 * 8 * 8), seed=2)
    with torch.no_grad():
        _close(t.decode(torch.from_numpy(z)),
               _apply(j, params, z, method="decode"))


def test_custom_akl_embedding_and_remat():
    """The 2-D embedding equals JAX's bits; remat gives the same loss and
    gradients as the plain forward (each block recomputed)."""
    np.testing.assert_array_equal(pakl.sinusoidal_pos_emb_2d(8, 3, 5),
                                  jakl.sinusoidal_pos_emb_2d(8, 3, 5))
    with pytest.raises(ValueError):
        pakl.sinusoidal_pos_emb_2d(6, 2, 2)
    x = torch.from_numpy(_x((2, 1, 16, 16)))
    grads = []
    for remat in (False, True):
        t = pakl.CustomAutoencoderKL(**SMALL_AKL, remat=remat, device="cpu",
                                     seed=3)
        recon, z, _ = t(x)
        loss = (recon ** 2).mean() + z.abs().mean()
        grads.append([g.clone() for g in torch.autograd.grad(
            loss, list(t.parameters()))])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_fir_resamplers_match_jax():
    """fir_upsample_2d and fir_downsample_2d, NHWC: JAX's bits on inputs
    whose every product and partial sum is exact in fp32 (multiples of
    1/64 in [-2, 2]; the filter taps are multiples of 1/64), so that any
    difference of geometry, padding or taps shows; on random inputs within
    one fp32 ulp of the sums (2.4e-7): the depthwise convs add the taps in
    another order than XLA's."""
    rng = np.random.default_rng(1)
    exact = (rng.integers(-128, 129, (2, 6, 10, 3)) / 64.0).astype(np.float32)
    rough = _x((2, 6, 10, 3)) * 4 - 2
    for name in ("fir_upsample_2d", "fir_downsample_2d"):
        for x, atol in ((exact, 0.0), (rough, 2.4e-7)):
            got = getattr(pblocks, name)(torch.from_numpy(x))
            want = getattr(jblocks, name)(jnp.asarray(x))
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=atol, rtol=0, err_msg=name)


# --------------------------------------------------- ViTAE, token forecasters
def test_vit_ae_forward_matches_jax(cases):
    """recon and latent, and the token path (encode_tokens, decode_tokens),
    deterministic."""
    j, params, x, (jr, jl) = cases("vit_ae")
    t = pvit.ViTAE(**SMALL_VIT, device="cpu")
    t.load_state_dict(CONVERT["vit_ae"](_np(params)), strict=True)
    with torch.no_grad():
        pr, pl = t(torch.from_numpy(x))
        ptok_ = t.encode_tokens(torch.from_numpy(x))
        pdec = t.decode_tokens(ptok_)
    _close(pl, jl)
    _close(pr, jr)
    jt = _apply(j, params, x, method="encode_tokens")
    _close(ptok_, jt)
    _close(pdec, _apply(j, params, jt, method="decode_tokens"))
    assert t.encoder.layers[0].dropout == 0.1        # the JAX default


def test_token_forecasters_match_jax():
    """TokenSequenceForecaster (B, T_in, N, D) -> (B, T_out, N, D) and
    LatentTokenForecaster over a (C, h, w) grid, deterministic."""
    j = jtok.TokenSequenceForecaster(t_in=3, t_out=2, d_token=16, num_heads=2,
                                     depth=2)
    t = ptok.TokenSequenceForecaster(3, 2, 16, 2, 2, device="cpu")
    params = _pair(j, t, ptok.token_forecaster_state_dict_from_flax,
                   (1, 3, 5, 16))
    x = _x((2, 3, 5, 16))
    with torch.no_grad():
        _close(t(torch.from_numpy(x)), _apply(j, params, x))
    j = jtok.LatentTokenForecaster(t_in=3, t_out=2, latent_shape=(4, 2, 3),
                                   d_model=16, num_heads=2, depth=1)
    t = ptok.LatentTokenForecaster(3, 2, (4, 2, 3), 16, 2, 1, device="cpu")
    params = _pair(j, t, ptok.token_forecaster_state_dict_from_flax,
                   (1, 3, 24))
    z = _x((2, 3, 24))
    with torch.no_grad():
        _close(t(torch.from_numpy(z)), _apply(j, params, z))
    fresh = ptok.LatentTokenForecaster(3, 2, (4, 2, 3), 16, 2, 1,
                                       device="cpu")
    with torch.no_grad():                  # zero-initialised head
        assert not fresh(torch.from_numpy(z)).any()


# --------------------------------------------------------------- latent AEs
def test_conv_transpose_same_k3_geometry():
    """flax ConvTranspose(3, strides 2, "SAME") is torch's padding=0 with the
    first 2H x 2W kept (the port's SameConvTranspose3x3); padding=1 with
    output_padding=1 is another function."""
    x = _x((2, 5, 4, 3), seed=4)                                # NHWC
    mod = jlat.nn.ConvTranspose(6, (3, 3), strides=(2, 2), padding="SAME")
    params = _init(mod, (1, 5, 4, 3))
    want = np.asarray(_apply(mod, params, x))
    k = np.asarray(params["params"]["kernel"])
    w = torch.from_numpy(np.ascontiguousarray(
        np.transpose(k[::-1, ::-1], (2, 3, 0, 1))))
    conv = plat.SameConvTranspose3x3(3, 6)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(torch.from_numpy(np.asarray(params["params"]["bias"])))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        wrong = torch.nn.functional.conv_transpose2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), w, conv.bias, stride=2,
            padding=1, output_padding=1).permute(0, 2, 3, 1)
    assert got.shape == (2, 10, 8, 6)
    _close(got, want, atol=1e-6)
    assert np.abs(wrong.numpy() - want).max() > 0.1


def test_latent_conv_model_matches_jax():
    """ConvModel at its fixed ladder (128..1024 channels, 16x16 -> 1x1),
    small latent_dim: (z, recon)."""
    j = jlat.ConvModel(latent_dim=8, in_channels=4)
    t = plat.ConvModel(latent_dim=8, in_channels=4, device="cpu")
    params = _pair(j, t, plat.latent_ae_state_dict_from_flax, (1, 4, 16, 16))
    x = _x((2, 4, 16, 16))
    jz, jr = _apply(j, params, x)
    with torch.no_grad():
        pz, pr = t(torch.from_numpy(x))
    _close(pz, jz, atol=2e-5)     # 1e-5 of a |z| near 10: fp32 over 9k terms
    _close(pr, jr)


def test_latent_conv_attn_model_matches_jax():
    j = jlat.ConvAttnModel(in_channels=4, embed_dim=16, nhead=2,
                           num_tf_layers=1, latent_dim=8, grid=4)
    t = plat.ConvAttnModel(4, 16, 2, 1, 8, 4, device="cpu")
    params = _pair(j, t, plat.latent_ae_state_dict_from_flax, (1, 4, 16, 16))
    x = _x((2, 4, 16, 16))
    jr, jz = _apply(j, params, x)
    with torch.no_grad():
        pr, pz = t(torch.from_numpy(x))
    _close(pz, jz)
    _close(pr, jr)


# ------------------------------------------------- Path A, StructuredConvAE
# Path-A and StructuredConvAE forwards: atol 1e-4 on outputs up to 4 in
# magnitude. Through these random-weight ladders (GroupNorms of 8 to 16
# elements, flax's with variance E[x^2] - E[x]^2) fp32 rounding puts each
# package's output up to 6e-5 from a float64 evaluation of the port on the
# same weights (JAX up to 5.9e-5, the port up to 4.4e-5, on these draws).
LADDER_ATOL = 1e-4


@pytest.mark.parametrize("kind", ["conv_autoencoder", "attention_charged_ae"])
def test_path_a_matches_jax(kind, cases):
    """ConvAutoencoder (32x32 -> 1x1 in five stride-2 blocks) and
    AttentionChargedAutoencoder (strides 2, 2, 8; a 4x4 query grid), with
    their nearest-2x upsample ladders: (recon, z), deterministic, within
    LADDER_ATOL."""
    if kind == "conv_autoencoder":
        j, params, x, (jr, jz) = cases(kind)
        t = ppa.ConvAutoencoder(**SMALL_PA, img_size=32, device="cpu")
        t.load_state_dict(CONVERT[kind](_np(params)), strict=True)
    else:
        j = jpa.AttentionChargedAutoencoder(**SMALL_AC)
        t = ppa.AttentionChargedAutoencoder(**SMALL_AC, img_size=32,
                                            device="cpu")
        params = _pair(j, t, ppa.path_a_state_dict_from_flax, (1, 1, 32, 32))
        x = _x((2, 1, 32, 32))
        jr, jz = _apply(j, params, x)
    with torch.no_grad():
        pr, pz = t(torch.from_numpy(x))
    _close(pz, jz, LADDER_ATOL)
    _close(pr, jr, LADDER_ATOL)


@pytest.mark.parametrize("tf_depth", [0, 1])
def test_structured_conv_ae_matches_jax(tf_depth, cases):
    """The spatial latent (B, 4, 8, 8) and the recon, with and without the
    latent transformer, within LADDER_ATOL."""
    cfg = dict(SMALL_SC, tf_depth=tf_depth, tf_heads=2)
    t = pleg.StructuredConvAE(**cfg, device="cpu")
    if tf_depth == 0:
        j, params, x, (jr, jz) = cases("structured_conv_ae")
        t.load_state_dict(CONVERT["structured_conv_ae"](_np(params)),
                          strict=True)
    else:
        j = jleg.StructuredConvAE(**cfg)
        params = _pair(j, t, pleg.structured_conv_ae_state_dict_from_flax,
                       (1, 1, 32, 32))
        x = _x((2, 1, 32, 32))
        jr, jz = _apply(j, params, x)
    with torch.no_grad():
        pr, pz = t(torch.from_numpy(x))
    assert pz.shape == (2, 4, 8, 8)
    _close(pz, jz, LADDER_ATOL)
    _close(pr, jr, LADDER_ATOL)


# ------------------------------------------------------------- the registry
# small arguments for every name; the port's constructors also take
# device (and most a seed)
SMALL_KWARGS = {
    "pos_aware_ae": dict(enc_channels=[8, 16], dec_channels=[16, 8, 8],
                         num_blocks=1, latent_channels=4, latent_dim=8),
    "pos_aware_ae_tf": dict(enc_channels=[8, 16], dec_channels=[16, 8, 8],
                            num_blocks=1, latent_channels=4, latent_dim=8,
                            tf_heads=2, tf_ffn=8, decoder_tf_depth=1),
    "vit_ae": SMALL_VIT,
    "autoencoder_kl": dict(in_channels=1, out_channels=1,
                           block_out_channels=[8], norm_num_groups=4),
    "custom_autoencoder_kl": SMALL_AKL,
    "structured_conv_ae": SMALL_SC,
    "conv_autoencoder": dict(SMALL_PA, img_size=32),
    "attention_charged_ae": dict(SMALL_AC, img_size=32),
    "latent_conv_model": dict(latent_dim=8),
    "latent_conv_attn": dict(embed_dim=16, nhead=2, num_tf_layers=1,
                             latent_dim=8, grid=4),
    "dlinear": dict(seq_len=4, pred_len=2),
    "linear_forecaster": dict(t_in=4, t_out=2, d=3),
    "per_pixel_linear": dict(t_in=4, t_out=2, c=3),
    "time_mlp": dict(t_in=4, t_out=2, hidden_dim=8),
    "earthformer": dict(t_in=3, t_out=2, patch=4, dim=16, depth=1,
                        num_heads=2, window=[2, 2], img_size=16),
    "token_sequence_forecaster": dict(t_in=3, t_out=2, d_token=16,
                                      num_heads=2, depth=1),
    "alphapre": dict(pre_seq_length=3, aft_seq_length=2, input_shape=[8, 8],
                     input_dim=1, hidden_dim=8, n_layers=1),
}


def test_registry_names_and_build_model(monkeypatch):
    """The same 17 names as JAX's registry; build_model builds each on the
    CPU and turns list arguments into tuples; an unknown name raises."""
    assert preg.available_models() == jreg.available_models()
    assert sorted(SMALL_KWARGS) == preg.available_models()
    for name, kwargs in SMALL_KWARGS.items():
        m = preg.build_model(name, **kwargs, device="cpu")
        assert isinstance(m, torch.nn.Module), name
        assert all(p.device.type == "cpu" for p in m.parameters()), name
    monkeypatch.setitem(preg._REGISTRY, "probe", lambda **kw: kw)
    assert preg.build_model("probe", a=[1, 2], b=3) == {"a": (1, 2), "b": 3}
    with pytest.raises(KeyError, match="available"):
        preg.build_model("nope")


# ------------------------------------------------------- experiment tasks
def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,kwargs", [
    ("structured_conv_ae", SMALL_SC),
    ("conv_autoencoder", dict(SMALL_PA, img_size=32)),
    ("vit_ae", dict(SMALL_VIT, dropout=0.0))])
def test_ae_recon_task_matches_jax(name, kwargs, cases):
    """experiments_gpu/ae_recon's build_task (build_model by name +
    reconstruction_task) on the JAX model's weights: the L1 loss and the
    latent norm against the JAX forward's on the same frames (rel 1e-5;
    LADDER_ATOL's reason for the two conv ladders), and gradients for every
    parameter. (reconstruction_task's gradients against jax.grad:
    test_torch_port_gan.py.) The JAX reconstruction_task calls the model
    with deterministic=False, which StructuredConvAE and ConvAutoencoder do
    not take (a TypeError), so the JAX side is the model's own apply."""
    mod = _load(REPO / "experiments_gpu" / "ae_recon" / "train.py",
                "_port_ae_recon_train")
    cfg = Config({"experiment_name": "ae_recon", "seed": 0, "loss": "l1",
                  "model": dict(kwargs, name=name),
                  "trainer": {"mixed_precision": False}})
    task = mod.build_task(cfg)
    model = task.init_params(0, torch.device("cpu"))
    _, params, x, (jr, jz) = cases(name)
    model.load_state_dict(CONVERT[name](_np(params)), strict=True)
    loss, aux = task.loss_fn(model, {"vil": torch.from_numpy(x)[None]}, None,
                             0)
    loss.backward()
    rel = 1e-5 if name == "vit_ae" else LADDER_ATOL
    want = np.mean(np.abs(np.asarray(jr) - x))
    assert float(loss.detach()) == pytest.approx(float(want), rel=rel)
    assert float(aux["latent_norm"]) == pytest.approx(
        float(np.mean(np.abs(np.asarray(jz)))), rel=rel)
    assert all(p.grad is not None for p in model.parameters())


def test_token_vit_task_matches_jax():
    """experiments_gpu/token_vit's build_task at small widths against the
    JAX models on the same weights: the frozen ViTAE's token latents and the
    forecaster's latent MSE on one batch (rel 1e-5); the ViTAE gets no
    gradient, the forecaster does."""
    pmod = _load(REPO / "experiments_gpu" / "token_vit" / "train.py",
                 "_port_token_vit_train")
    cfg = Config({"experiment_name": "token_vit", "seed": 0,
                  "vit_ae": dict(SMALL_VIT, ckpt_run_dir=None, init_seed=7),
                  "forecaster": {"depth": 1, "num_heads": 2},
                  "dataset": {"input_frames": 3, "pred_frames": 2}})
    vit = pmod.make_vit(cfg, device="cpu")
    assert not any(p.requires_grad for p in vit.parameters())
    ptask = pmod.build_task(cfg, vit=vit)
    fc = ptask.init_params(0, torch.device("cpu"))
    j_vit = jvit.ViTAE(**SMALL_VIT, dropout=0.0)
    vit_params = _init(j_vit, (1, 1, 32, 32), seed=7)
    vit.load_state_dict(pvit.vit_ae_state_dict_from_flax(_np(vit_params)))
    jfc = jtok.TokenSequenceForecaster(t_in=3, t_out=2, d_token=16,
                                       num_heads=2, depth=1)
    fc_params = _init(jfc, (1, 3, 16, 16), seed=8)
    fc.load_state_dict(ptok.token_forecaster_state_dict_from_flax(
        _np(fc_params)))
    vil = _x((2, 5, 1, 32, 32), seed=6)
    frames = jnp.asarray(vil).reshape(10, 1, 32, 32)
    z = _apply(j_vit, vit_params, frames, method="encode_tokens")
    z = z.reshape(2, 5, 16, 16)
    want = jnp.mean((_apply(jfc, fc_params, z[:, :3]) - z[:, 3:]) ** 2)
    loss, _ = ptask.loss_fn(fc, {"vil": torch.from_numpy(vil)}, None, 0)
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    loss.backward()
    assert all(p.grad is None for p in vit.parameters())
    assert all(p.grad is not None for p in fc.parameters())
    pred, gt = ptask.eval_fn(fc, {"vil": torch.from_numpy(vil)}, None)
    assert pred.shape == gt.shape == (2, 2, 1, 32, 32)
    assert float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0
