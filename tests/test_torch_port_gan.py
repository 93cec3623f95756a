"""The port's GAN training stack against the JAX package, on the CPU: the
same numpy inputs and the same weights (carried across by the port's
``*_state_dict_from_flax``) through both.

Covered: ``PosAwareAE``/``PosAwareAETF`` (deterministic forward, within
1e-5), ``remat``, the PatchGAN discriminator (GroupNorm and ActNorm; logits
and features), ``ActNorm.stats_from``, the d-losses, ``adopt_weight``,
``adaptive_weight``, ``feature_matching_distance``, LPIPS on random weights
and its torchvision-dict loader, ``cast_floats``, ``reconstruction_task``
(loss and gradients against ``jax.grad``), two steps of the two-optimizer
``make_vae_gan_task`` against the JAX ``custom_train_step`` (with the
``disc_start`` gate closed, then open; the KL + learnable logvar + LPIPS
and the feature-matching variants; bf16 mixed precision), a resumed
``Trainer.fit`` against a straight one. (What the new modules import is
checked with every port file by test_torch_port_training.py's
``test_port_imports_no_jax``.)

Randomness cannot match across the frameworks (JAX's RNG against a
``torch.Generator``), so every comparison runs a deterministic path:
``PosAwareAE`` has no randomness, the VAE generator takes the posterior's
mode, and ``PosAwareAETF`` runs with ``deterministic=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import conv_ae as jae
from weatherforecastingtoolkit_tpu.models.losses import gan as jgan
from weatherforecastingtoolkit_tpu.models.losses import lpips as jlp
from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL)
from weatherforecastingtoolkit_tpu.ops import amp as jamp
from weatherforecastingtoolkit_tpu.training import gan as jtgan
from weatherforecastingtoolkit_tpu.training import tasks as jtasks
from weatherforecastingtoolkit_tpu.training.trainer import TrainState as JState
from weatherforecastingtoolkit_tpu_torch.models import conv_ae as pae
from weatherforecastingtoolkit_tpu_torch.models.losses import gan as pgan
from weatherforecastingtoolkit_tpu_torch.models.losses import lpips as plp
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL as PAKL, state_dict_from_flax as vae_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.ops import amp as pamp
from weatherforecastingtoolkit_tpu_torch.training import gan as ptgan
from weatherforecastingtoolkit_tpu_torch.training import optim as poptim
from weatherforecastingtoolkit_tpu_torch.training import tasks as ptasks
from weatherforecastingtoolkit_tpu_torch.training import trainer as ptrainer
from weatherforecastingtoolkit_tpu_torch.utils.config import Config

HW = 32
# tests/test_gan.py's sizes
SMALL_AE = dict(enc_channels=(8, 16), dec_channels=(16, 8, 8), num_blocks=1,
                latent_hw=8, latent_channels=4, latent_dim=32)
SMALL_TF = dict(SMALL_AE, decoder_tf_depth=2, tf_heads=2, tf_ffn=16)
SMALL_VAE = dict(in_channels=1, out_channels=1, block_out_channels=(8, 16),
                 layers_per_block=1, latent_channels=4, norm_num_groups=4)
# bench.py's optimizers
GEN_LR, DISC_LR = 1e-4, 4.5e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(module, *shapes, seed=0):
    """Variables with the module's flax structure, drawn with numpy from a
    seed as flax's initializers draw them (XLA compiles flax's own init
    slowly on the CPU): kernels normal / sqrt(fan_in), biases zero, norm
    scales one, ``pos_emb`` normal; ActNorm's (1, 1, 1, C) loc and scale
    moved off their init (0.1 normal, 1 + 0.1 normal) so that their layout
    shows."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(module.init, jax.random.key(0),
                          *[jnp.zeros(s) for s in shapes])

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "pos_emb":
            v = rng.standard_normal(shape)
        elif len(shape) == 4:                      # ActNorm's loc, scale
            v = (name == "scale") + 0.1 * rng.standard_normal(shape)
        else:
            v = np.full(shape, float(name == "scale"))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _frames(n, seed, c=1):
    return np.random.default_rng(seed).random((n, c, HW, HW)).astype(np.float32)


def _ae_pair(cfg=SMALL_AE, seed=0):
    j = jae.PosAwareAE(**cfg)
    params = _init(j, (1, 1, HW, HW), seed=seed)
    t = pae.PosAwareAE(**cfg, device="cpu")
    t.load_state_dict(pae.pos_aware_ae_state_dict_from_flax(params))
    return j, params, t


def _disc_pair(actnorm=False, ndf=8, n_layers=2):
    j = jgan.NLayerDiscriminator(input_nc=1, ndf=ndf, n_layers=n_layers,
                                 use_actnorm=actnorm)
    params = _init(j, (1, 1, HW, HW), seed=1)
    t = pgan.NLayerDiscriminator(1, ndf, n_layers, actnorm, device="cpu")
    t.load_state_dict(pgan.discriminator_state_dict_from_flax(params))
    return j, params, t


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float() if
                                          isinstance(got, torch.Tensor)
                                          else got),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------ the models
@pytest.mark.parametrize("cfg,atol", [(SMALL_AE, 1e-5), (SMALL_TF, 2e-5)],
                         ids=["ae", "tf"])
def test_pos_aware_ae_forward_matches_jax(cfg, atol):
    """PosAwareAE and PosAwareAETF (deterministic): z, and the decoder's
    output on JAX's z, within 1e-5; the end-to-end reconstruction within
    1e-5, and 2e-5 through the transformer decoder, which amplifies the
    last-bit differences of z. The port's fp32 forward is also held within
    1e-5 of its own float64 evaluation."""
    j, params, t = _ae_pair(cfg)
    x = _frames(3, seed=2)
    recon, z = jax.jit(j.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        trecon, tz = t(_t(x))
        _close(t.encode(_t(x)), z, 1e-5)
        _close(t.decode(_t(np.asarray(z))), recon, 1e-5)
    assert tuple(trecon.shape) == (3, 1, HW, HW) and tuple(tz.shape) == (3, 32)
    _close(trecon, recon, atol)
    _close(tz, z, 1e-5)
    t64 = pae.PosAwareAE(**cfg, device="cpu").double()
    t64.load_state_dict(t.state_dict())
    with torch.no_grad():
        r64, z64 = t64(_t(x).double())
    _close(trecon, r64.numpy(), 1e-5)
    _close(tz, z64.numpy(), 1e-5)
    assert pae.PosAwareAETF(**SMALL_AE, device="cpu").decoder_tf_depth == 8


def _n_params(module):
    return sum(p.numel() for p in module.parameters())


def _jax_n_params(module, shape):
    shapes = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))
    return sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes))


def test_pos_aware_ae_param_count_and_remat(monkeypatch):
    """The bench's PosAwareAE has JAX's parameter count (80,750,017, the
    port's counted on the meta device, its weights not drawn); remat=True
    gives the same outputs and gradients as remat=False."""
    want = _jax_n_params(jae.PosAwareAE(latent_dim=2048), (1, 1, 128, 128))
    assert want == 80_750_017
    with monkeypatch.context() as mp:
        mp.setattr(pae.PosAwareAE, "_init_weights", lambda self, rng: None)
        assert _n_params(pae.PosAwareAE(latent_dim=2048, device="meta")) == want

    _, params, plain = _ae_pair()
    remat = pae.PosAwareAE(**SMALL_AE, remat=True, device="cpu")
    remat.load_state_dict(plain.state_dict())
    x = _t(_frames(2, seed=3))
    outs = []
    for m in (plain, remat):
        m.zero_grad()
        recon, z = m(x)
        (recon.square().mean() + z.abs().mean()).backward()
        outs.append([recon.detach()] + [p.grad.clone()
                                        for p in m.parameters()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


@pytest.mark.parametrize("actnorm", [False, True], ids=["groupnorm", "actnorm"])
def test_discriminator_logits_and_features_match_jax(actnorm):
    j, params, t = _disc_pair(actnorm)
    x = _frames(2, seed=4)
    logits, feats = jax.jit(lambda p, v: j.apply(p, v, return_features=True))(
        params, jnp.asarray(x))
    with torch.no_grad():
        tlogits, tfeats = t(_t(x), return_features=True)
        _close(t(_t(x)), logits, 1e-5)
    assert tuple(tlogits.shape) == tuple(logits.shape) == (2, 1, 9, 9)
    _close(tlogits, logits, 1e-5)
    assert len(tfeats) == len(feats) == 3
    for a, b in zip(tfeats, feats):
        _close(a, b, 1e-5)


def test_discriminator_geometry_and_param_count(monkeypatch):
    """NLayerDiscriminator(1, 64, 3): 2,755,905 parameters (JAX's count) and
    (B, 1, 17, 17) logits for 128x128 frames (the 1x1 head with padding 1),
    on the meta device."""
    want = _jax_n_params(jgan.NLayerDiscriminator(input_nc=1, ndf=64,
                                                  n_layers=3),
                         (1, 1, 128, 128))
    monkeypatch.setattr(pgan.NLayerDiscriminator, "_init_weights",
                        lambda self, rng: None)
    t = pgan.NLayerDiscriminator(1, 64, 3, device="meta")
    assert want == 2_755_905 == _n_params(t)
    assert tuple(t(torch.empty(2, 1, 128, 128, device="meta")).shape) == (
        2, 1, 17, 17)


def test_loss_helpers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 4, 4)).astype(np.float32) * 2 + 1
    loc, scale = pgan.ActNorm.stats_from(_t(x))
    jloc, jscale = jgan.ActNorm.stats_from(jnp.asarray(x.transpose(0, 2, 3, 1)))
    _close(loc, np.asarray(jloc).transpose(0, 3, 1, 2), 1e-6)
    _close(scale, np.asarray(jscale).transpose(0, 3, 1, 2), 0, rtol=1e-6)

    real, fake = (rng.standard_normal((2, 1, 5, 5)).astype(np.float32) * 2
                  for _ in range(2))
    for p, j in ((pgan.hinge_d_loss, jgan.hinge_d_loss),
                 (pgan.vanilla_d_loss, jgan.vanilla_d_loss)):
        _close(p(_t(real), _t(fake)), j(jnp.asarray(real), jnp.asarray(fake)),
               0, rtol=1e-6)
    for step in (0, 4, 5, 9):
        assert np.float32(pgan.adopt_weight(0.7, step, 5)) == np.float32(
            jgan.adopt_weight(0.7, jnp.asarray(step), 5))
    a, b = (rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
            for _ in range(2))
    for w in (0.5, 2.0):
        _close(pgan.adaptive_weight(_t(a), _t(b), w),
               jgan.adaptive_weight(jnp.asarray(a), jnp.asarray(b), w),
               0, rtol=1e-6)
    huge = pgan.adaptive_weight(_t(a), torch.zeros(4, 3, 3, 3), 1.0)
    assert float(huge) == float(jgan.adaptive_weight(
        jnp.asarray(a), jnp.zeros((4, 3, 3, 3)), 1.0)) == 1e4
    fa = [rng.standard_normal((2, c, 4, 4)).astype(np.float32) for c in (3, 5)]
    fb = [rng.standard_normal((2, c, 4, 4)).astype(np.float32) for c in (3, 5)]
    got = pgan.feature_matching_distance([_t(v) for v in fa],
                                         [_t(v) for v in fb])
    assert tuple(got.shape) == (2, 1, 1, 1)
    _close(got, jgan.feature_matching_distance(
        [jnp.asarray(v) for v in fa], [jnp.asarray(v) for v in fb]),
        0, rtol=1e-6)


def _lpips_pair():
    j = jlp.LPIPS()
    params = _init(j, (1, 3, HW, HW), (1, 3, HW, HW), seed=7)
    t = plp.LPIPS(device="cpu")
    t.load_state_dict(plp.lpips_state_dict_from_flax(params))
    return j, params, t


def test_lpips_random_weights_and_torchvision_loader():
    """LPIPS on the JAX package's random weights within rel 1e-5; then both
    packages load one torchvision-layout state dict the test builds (VGG16
    ``features.{i}`` convs, ``lin{i}.model.1.weight`` heads) and agree."""
    j, params, t = _lpips_pair()
    rng = np.random.default_rng(8)
    a, b = (rng.uniform(-1, 1, (2, 3, HW, HW)).astype(np.float32)
            for _ in range(2))
    apply = jax.jit(j.apply)
    want = apply(params, jnp.asarray(a), jnp.asarray(b))
    with torch.no_grad():
        got = t(_t(a), _t(b))
    assert tuple(got.shape) == (2, 1, 1, 1)
    _close(got, want, 0, rtol=1e-5)

    vgg, cin = {}, 3
    for i, li in enumerate(plp.TORCHVISION_CONVS):
        cout = t.vgg.get_submodule(f"conv_{i}").out_channels
        vgg[f"features.{li}.weight"] = (rng.standard_normal(
            (cout, cin, 3, 3)) * (2.0 / (9 * cin)) ** 0.5).astype(np.float32)
        vgg[f"features.{li}.bias"] = (rng.standard_normal(cout) * 0.01
                                      ).astype(np.float32)
        cin = cout
    lin = {f"lin{i}.model.1.weight": rng.random((1, c, 1, 1)).astype(np.float32)
           for i, c in enumerate((64, 128, 256, 512, 512))}
    t.load_state_dict(plp.lpips_state_dict_from_torch(vgg, lin), strict=True)
    jp = jlp.lpips_params_from_torch(vgg, lin)
    with torch.no_grad():
        got = t(_t(a), _t(b))
    _close(got, apply(jp, jnp.asarray(a), jnp.asarray(b)), 0, rtol=1e-5)


def test_cast_floats_matches_jax():
    tree = {"w": np.ones((2, 2), np.float32), "i": np.arange(3),
            "h": np.ones(2, np.float16), "n": [np.zeros(1, np.float32)]}
    jt = jamp.cast_floats(tree)
    pt = pamp.cast_floats(jax.tree_util.tree_map(_t, tree))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jt):
        p = pt
        for k in path:
            p = p[k.key if hasattr(k, "key") else k.idx]
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), path
    back = pamp.to_f32(pt)
    assert back["w"].dtype == back["h"].dtype == torch.float32
    assert back["i"].dtype == torch.int64
    m = torch.nn.Linear(3, 2)
    cast = pamp.cast_floats(m)
    assert set(cast) == {"weight", "bias"}
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    # a bf16 call through cast_call reaches the fp32 masters
    y = pamp.cast_call(lambda mod, x: mod(x), m, torch.ones(4, 3))
    assert y.dtype == torch.bfloat16 and m.weight.dtype == torch.float32
    y.float().sum().backward()
    assert m.weight.grad.dtype == torch.float32
    loss, aux = pamp.mixed_loss(lambda mod, b, r, s: (
        mod(b["x"]).sum(), {"a": mod(b["x"]).mean()}))(
            m, {"x": torch.ones(4, 3)}, None, 0)
    assert loss.dtype == aux["a"].dtype == torch.float32


def _jax_recon_grads(j, params, batch, loss, mixed):
    task = jtasks.reconstruction_task(j, loss=loss, mixed_precision=mixed)
    (jloss, jaux), grads = jax.jit(jax.value_and_grad(
        task.loss_fn, has_aux=True), static_argnums=3)(
            params, {"vil": jnp.asarray(batch)}, jax.random.key(0), 0)
    return jloss, jaux, pae.pos_aware_ae_state_dict_from_flax(_np(grads))


def _flat(grads, names):
    return np.concatenate([np.asarray(grads[n]).ravel() for n in names])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16"])
def test_reconstruction_task_matches_jax(mixed):
    """fp32 (L1): loss within rel 1e-5, every gradient within 1e-4 of its
    largest magnitude, against jax.grad of the JAX task. bf16 (MSE): loss
    within rel 1e-2; bf16 gradients of a random network are noisy (JAX's
    own lie a few percent in rel-L2 from its fp32 ones), so the port's
    whole gradient must lie no further from JAX's fp32 gradient than 1.5
    times JAX's bf16 gradient does."""
    j, params, t = _ae_pair()
    batch = np.random.default_rng(9).random((2, 2, 1, HW, HW)).astype(np.float32)
    loss_kind = "mse" if mixed else "l1"
    jloss, jaux, jgrads = _jax_recon_grads(j, params, batch, loss_kind, mixed)
    ptask = ptasks.reconstruction_task(t, loss=loss_kind,
                                       mixed_precision=mixed)
    model = ptask.init_params(0, torch.device("cpu"))
    loss, aux = ptask.loss_fn(model, {"vil": _t(batch)}, None, 0)
    loss.backward()
    assert loss.dtype == torch.float32
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
    if mixed:
        _close(loss, jloss, 0, rtol=1e-2)
        _close(aux["latent_norm"], jaux["latent_norm"], 0, rtol=1e-2)
        _, _, f32 = _jax_recon_grads(j, params, batch, loss_kind, False)
        names = list(grads)
        ref = _flat(f32, names)
        assert _rel(_flat(grads, names), ref) <= 1.5 * _rel(
            _flat(jgrads, names), ref)
    else:
        _close(loss, jloss, 0, rtol=1e-5)
        _close(aux["latent_norm"], jaux["latent_norm"], 0, rtol=1e-5)
        for name, g in grads.items():
            want = jgrads[name].numpy()
            _close(g, want, 1e-4 * float(np.abs(want).max()) + 1e-12)
    pred, target = ptask.eval_fn(model, {"vil": _t(batch)}, None)
    assert tuple(pred.shape) == tuple(target.shape) == batch.shape


# --------------------------------------------------- the two-optimizer step
def _vae_pair():
    j = JAKL(**SMALL_VAE)
    params = _init(j, (1, 1, HW, HW), seed=3)
    t = PAKL(**SMALL_VAE, device="cpu")
    t.load_state_dict(vae_state_dict_from_flax(params))
    return j, params, t


def _gan_tasks(kind, mixed, disc_start):
    """The JAX task and the port's on the same weights: 'ae' (PosAwareAE)
    or 'kl' (a small AutoencoderKL at its posterior's mode, with KL, the
    learnable logvar, LPIPS and the discriminator's feature matching).
    bench.py's optimizers."""
    jd, dparams, td = _disc_pair()
    common = dict(disc_start=disc_start, disc_weight=0.5,
                  mixed_precision=mixed)
    jkw, pkw = dict(common), dict(common)
    if kind == "kl":
        jg, gparams, tg = _vae_pair()

        def jgen_apply(p, f, r):
            recon, post = jg.apply(p, f, return_posterior=True)
            return recon, post.kl()

        def pgen_apply(g, f, r):
            recon, post = g(f, return_posterior=True)
            return recon, post.kl()

        jl, lparams, tl = _lpips_pair()
        jkw.update(kl_weight=1e-3, perceptual_weight=0.5,
                   perceptual_apply=lambda a, b: jl.apply(lparams, a, b),
                   last_layer_path=("params", "decoder", "conv_out", "kernel"),
                   feature_matching_weight=0.1,
                   disc_feats_apply=lambda p, f: jd.apply(
                       p, f, return_features=True))
        pkw.update(kl_weight=1e-3, perceptual_weight=0.5,
                   perceptual_apply=tl, last_layer_path="decoder.conv_out.weight",
                   feature_matching_weight=0.1,
                   disc_feats_apply=lambda d, f: d(f, return_features=True))
    else:
        jg, gparams, tg = _ae_pair()

        def jgen_apply(p, f, r):
            return jg.apply(p, f)[0], None

        def pgen_apply(g, f, r):
            return g(f)[0], None

        jkw["last_layer_path"] = ("params", "dec_out", "kernel")
        pkw["last_layer_path"] = "dec_out.weight"
    jtask = jtgan.make_vae_gan_task(
        name="gan", generator_apply=jgen_apply,
        gen_init=lambda r: jax.tree_util.tree_map(jnp.asarray, gparams),
        disc_apply=lambda p, f: jd.apply(p, f),
        disc_init=lambda r: jax.tree_util.tree_map(jnp.asarray, dparams),
        disc_tx=optax.adam(DISC_LR, b1=0.5, b2=0.9), **jkw)
    ptask = ptgan.make_vae_gan_task(
        name="gan", generator_apply=pgen_apply,
        gen_init=lambda s, d: tg, disc_init=lambda s, d: td,
        disc_apply=lambda d, f: d(f),
        disc_tx=poptim.adam(DISC_LR, b1=0.5, b2=0.9), **pkw)
    return jtask, ptask, kind == "kl"


def _run_both(kind, mixed=False, disc_start=1, steps=2):
    jtask, ptask, vae = _gan_tasks(kind, mixed, disc_start)
    jtx = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(GEN_LR, weight_decay=1e-4))
    ptx = poptim.adamw(GEN_LR, weight_decay=1e-4, grad_clip=1.0)
    rng = jax.random.key(0)
    jp = jtask.init_params(rng)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=jp,
                    opt_state=jtx.init(jp), rng=rng,
                    extra=jtask.init_extra(rng, jp))
    pp = ptask.init_params(0, torch.device("cpu"))
    pstate = ptrainer.TrainState(step=0, params=pp,
                                 opt_state=ptx.init(list(pp.parameters())),
                                 rng=torch.Generator().manual_seed(0),
                                 extra=ptask.init_extra(0, pp))
    before = {k: w.detach().numpy().copy()
              for k, w, _ in _param_pairs(jstate, pstate, vae)}
    jstep = jax.jit(lambda s, b: jtask.custom_train_step(s, b, jtx))
    data = np.random.default_rng(10).random((steps, 2, 2, 1, HW, HW)
                                            ).astype(np.float32)
    auxes = []
    for i in range(steps):
        jstate, jaux = jstep(jstate, {"vil": jnp.asarray(data[i])})
        pstate, paux = ptask.custom_train_step(pstate, {"vil": _t(data[i])},
                                               ptx)
        auxes.append((_np(jaux), {k: float(v) for k, v in paux.items()}))
    return jstate, pstate, auxes, vae, before


def _param_pairs(jstate, pstate, vae):
    """(name, port tensor, JAX array) for every generator, logvar and
    discriminator parameter."""
    to_sd = (vae_state_dict_from_flax if vae
             else pae.pos_aware_ae_state_dict_from_flax)
    want = {f"gen.{k}": v for k, v in to_sd(_np(jstate.params["gen"])).items()}
    if "logvar" in jstate.params:
        want["logvar"] = np.asarray(jstate.params["logvar"])
    want.update({f"disc.{k}": v for k, v in pgan.discriminator_state_dict_from_flax(
        _np(jstate.extra["disc_params"])).items()})
    got = dict(pstate.params.named_parameters())
    got.update({f"disc.{k}": v for k, v in
                pstate.extra["disc_params"].named_parameters()})
    assert set(got) == set(want)
    return [(k, got[k], np.asarray(want[k])) for k in sorted(got)]


# Adam normalises each element's step: by Cauchy-Schwarz |m_hat / sqrt(v_hat)|
# is at most 1 (1.0014 at the second step with these betas), so a step moves
# an element by at most about lr whatever its gradient. Where a gradient is
# near zero, rounding in another order can flip its sign, and the two
# packages then move that element apart by up to 2 * lr a step. So every
# parameter is held to atol 2.5 * lr * steps; and the update as a whole
# (after minus before, over every parameter, in units of each one's lr) to
# a relative L2 error ``upd_rtol``, which a wrong update rule (a flipped
# sign, a missed term) would exceed however small it left each element.
def _check_params(jstate, pstate, vae, steps, before, upd_rtol):
    got_upd, want_upd = [], []
    for name, got, want in _param_pairs(jstate, pstate, vae):
        lr = DISC_LR if name.startswith("disc.") else GEN_LR
        got = got.detach().numpy()
        _close(got, want, 2.5 * lr * steps + 1e-6)
        got_upd.append((got - before[name]).ravel() / lr)
        want_upd.append((want - before[name]).ravel() / lr)
    err = _rel(np.concatenate(got_upd), np.concatenate(want_upd))
    assert err <= upd_rtol, err


@pytest.mark.parametrize("kind", ["ae", "kl"])
def test_two_gan_steps_match_jax(kind):
    """Two steps with disc_start=1: the gate closed on the first (the
    discriminator stays, its Adam moments stay zero, its count advances),
    open on the second. Every aux scalar within rel 1e-4 (abs 1e-7 near
    zero); every parameter as ``_check_params`` says."""
    jstate, pstate, auxes, vae, before = _run_both(kind)
    for i, (ja, pa) in enumerate(auxes):
        assert set(pa) == set(ja), (set(pa) ^ set(ja))
        for k in ja:
            np.testing.assert_allclose(pa[k], float(ja[k]), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert auxes[0][1]["disc_factor"] == 0.0 and auxes[0][1]["disc_loss"] == 0
    assert auxes[1][1]["disc_factor"] == 1.0 and auxes[1][1]["d_weight"] > 0
    _check_params(jstate, pstate, vae, 2, before, upd_rtol=1e-3)
    disc_state = pstate.extra["disc_opt_state"]
    assert disc_state["count"] == 2 == int(jstate.extra["disc_opt_state"][0].count)
    assert pstate.step == 2


def test_closed_gate_keeps_the_discriminator():
    """Before disc_start the discriminator and its Adam moments stay
    exactly as they were while the count advances (optax's behaviour)."""
    _, ptask, _ = _gan_tasks("ae", False, disc_start=5)
    ptx = poptim.adamw(GEN_LR, weight_decay=1e-4, grad_clip=1.0)
    pp = ptask.init_params(0, torch.device("cpu"))
    state = ptrainer.TrainState(step=0, params=pp,
                                opt_state=ptx.init(list(pp.parameters())),
                                rng=torch.Generator().manual_seed(0),
                                extra=ptask.init_extra(0, pp))
    disc = {k: v.clone() for k, v in state.extra["disc_params"].state_dict().items()}
    gen = {k: v.clone() for k, v in pp.state_dict().items()}
    batch = {"vil": _t(np.random.default_rng(1).random((2, 2, 1, HW, HW)
                                                      ).astype(np.float32))}
    state, aux = ptask.custom_train_step(state, batch, ptx)
    for k, v in state.extra["disc_params"].state_dict().items():
        assert torch.equal(v, disc[k]), k
    opt = state.extra["disc_opt_state"]
    assert opt["count"] == 1
    assert not any(m.any() for m in opt["mu"] + opt["nu"])
    assert any(not torch.equal(v, gen[k]) for k, v in pp.state_dict().items())
    assert all(p.grad is None for p in state.extra["disc_params"].parameters())
    assert all(p.grad is None for p in pp.parameters())


# bf16 gradient noise flips the sign of many small Adam steps, so the bf16
# update lies far from JAX's (about half its norm in rel-L2); a flipped
# update would lie 2 from it and a missing one 1
BF16_UPD_RTOL = 0.75
# aux scalars made from gradients; the rest are losses and logits
GRADIENT_AUX = ("d_weight", "grad_norm", "loss")


def test_gan_step_mixed_precision_matches_jax():
    """bf16 mixed precision, one step each side of the gate. The losses and
    logits within rel 2e-2 (bf16 keeps 8 significant bits; they are means
    over many elements). The scalars made from gradients (d_weight, the
    gradient norm, and the loss, which d_weight scales) within rel 0.1:
    the bf16 gradients of this random network differ by several percent
    between the packages and from fp32 (``test_reconstruction_task``).
    Every parameter as ``_check_params`` says
    (the sign argument holds for bf16 gradients too)."""
    jstate, pstate, auxes, vae, before = _run_both("ae", mixed=True)
    for i, (ja, pa) in enumerate(auxes):
        for k in ja:
            rtol = 0.1 if k in GRADIENT_AUX else 2e-2
            np.testing.assert_allclose(pa[k], float(ja[k]), rtol=rtol,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    _check_params(jstate, pstate, vae, 2, before, upd_rtol=BF16_UPD_RTOL)
    for p in pstate.params.parameters():
        assert p.dtype == torch.float32


def _gan_config(tmp, steps):
    return Config({
        "experiment_name": "gan", "experiment_path": str(tmp), "seed": 0,
        "optim": {"schedule": "constant", "lr": GEN_LR, "weight_decay": 1e-4,
                  "grad_clip": 1.0},
        "trainer": {"total_train_steps": steps, "max_epochs": 1,
                    "async_checkpoint": False, "save_every_n_steps": 0.5},
        "logging": {"log_every_n_steps": 1}})


def _fit_task():
    def gen_init(seed, device):
        return pae.PosAwareAE(**SMALL_AE, device=device, seed=seed)

    return ptgan.make_vae_gan_task(
        name="gan", generator_apply=lambda g, f, r: (g(f)[0], None),
        gen_init=gen_init,
        disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: pgan.NLayerDiscriminator(1, 8, 2, device=d,
                                                        seed=s),
        disc_tx=poptim.adam(DISC_LR, b1=0.5, b2=0.9),
        last_layer_path="dec_out.weight", disc_weight=0.5, disc_start=1,
        kl_weight=1e-3)


def test_trainer_fit_resume_equals_straight_run(tmp_path):
    """Trainer.fit with the GAN task: 2 steps, a new Trainer(resume=True),
    2 more equal 4 straight steps exactly (generator, logvar, discriminator
    and both optimizers' states)."""
    batches = [{"vil": np.random.default_rng(i).random(
        (2, 2, 1, HW, HW)).astype(np.float32)} for i in range(4)]
    straight = ptrainer.Trainer(_gan_config(tmp_path / "a", 4), _fit_task(),
                                device="cpu")
    want = straight.fit(batches)
    straight.close()
    first = ptrainer.Trainer(_gan_config(tmp_path / "b", 4), _fit_task(),
                             device="cpu")
    first.fit(batches[:2])
    first.close()
    second = ptrainer.Trainer(_gan_config(tmp_path / "b", 4), _fit_task(),
                              device="cpu", resume=True)
    state = second.init_state()
    assert state.step == 2 and state.extra["disc_opt_state"]["count"] == 2
    state = second.fit(batches[2:], state=state)
    val = second.validate(state, batches[:1], 4)
    second.close()
    assert np.isfinite(val["loss"]) and "SSIM" in val
    assert state.step == want.step == 4
    for a, b in ((want.params, state.params),
                 (want.extra["disc_params"], state.extra["disc_params"])):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    for key in ("mu", "nu"):
        for x, y in zip(want.extra["disc_opt_state"][key] + want.opt_state[key],
                        state.extra["disc_opt_state"][key] + state.opt_state[key]):
            assert torch.equal(x, y)


def test_vae_remat_gives_the_same_gradients():
    """AutoencoderKL(remat=True) recomputes its blocks in the backward: the
    same reconstruction and gradients as remat=False."""
    _, _, plain = _vae_pair()
    remat = PAKL(**SMALL_VAE, remat=True, device="cpu")
    remat.load_state_dict(plain.state_dict())
    x = _t(_frames(2, seed=11))
    outs = []
    for m in (plain, remat):
        m.zero_grad()
        recon, post = m(x, return_posterior=True)
        (recon.square().mean() + post.kl().mean()).backward()
        outs.append([recon.detach()] + [p.grad for p in m.parameters()])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)
