"""The port's remaining experiment commands against the JAX package's, on
the CPU: ``experiments_gpu/{ae_gan,vae_gan_kl,vae_sevir384,latent_convae,
latent_convattn,mlp_intensity}/train.py::build_task`` against
``experiments/<name>/train.py::build_task`` on each experiment's own
config.yaml at tests/test_experiments.py's narrow overrides.

Both sides get the same weights and the same batch: the JAX variables are
drawn with numpy in flax's tree (``flax.linen.Module.init`` replaced by a
numpy draw of ``jax.eval_shape``'s tree: XLA compiles flax's own init of a
conv AE for seconds on the CPU) and carried across with the port's
``*_state_dict_from_flax``; the latent experiments' frozen VAE is a torch
state dict both load through ``ae_kl.ckpt_path``; the posterior's noise is
drawn once with numpy and given to both packages' ``sample``.

Checked: the mlp_intensity loss (rel 1e-5); the latent_convae and
latent_convattn losses (rel 1e-4); two GAN steps of ae_gan (PosAwareAE),
vae_gan_kl and vae_sevir384 (AutoencoderKL with KL, logvar and feature
matching; vae_sevir384 with remat, in fp32) and latent_convae's latent-space
GAN, each against the jitted JAX ``custom_train_step`` (aux scalars rel
1e-4, every parameter's update rel-L2 1e-3, as tests/test_torch_port_gan.py
holds the GAN task); and each command through ``experiments_gpu/common.py::
main`` with ``--device cpu`` to its ``done``.

The JAX GAN step is traced and compiled once for each distinct program
(most of these tests' time): vae_sevir384's JAX side runs without remat,
which recomputes and changes no value, so that it is vae_gan_kl's program;
the port's side keeps remat on, the path under test.
"""

import importlib.util
import json
import zlib
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weatherforecastingtoolkit_tpu.models.registry import build_model as jbuild
from weatherforecastingtoolkit_tpu.models.vae import distributions as jdist
from weatherforecastingtoolkit_tpu.training.trainer import TrainState as JState
from weatherforecastingtoolkit_tpu.utils.config import Config as JConfig
from weatherforecastingtoolkit_tpu_torch.models.conv_ae import (
    pos_aware_ae_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.forecasters import (
    time_mlp_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.latent_ae import (
    latent_ae_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (
    discriminator_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.vae import distributions as pdist
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL, state_dict_from_flax as vae_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.training import optim as poptim
from weatherforecastingtoolkit_tpu_torch.training import trainer as ptrainer
from weatherforecastingtoolkit_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
HW = 32
# tests/test_experiments.py's overrides
SPECIFIC = {
    "ae_gan": ["model.latent_dim=32", "model.latent_channels=4",
               "dataset.seq_len=4",
               "model.enc_channels=[8,16]", "model.dec_channels=[16,8,8]",
               "model.num_blocks=1", "lpips.disc_num_layers=1",
               "lpips.disc_ndf=8", "lpips.disc_start=0"],
    "vae_gan_kl": ["model.block_out_channels=[8,16]",
                   "model.latent_channels=4", "model.norm_num_groups=4",
                   "dataset.seq_len=4",
                   "lpips.disc_num_layers=1", "lpips.disc_ndf=8",
                   "lpips.disc_start=0"],
    "latent_convae": ["ae_kl.block_out_channels=[8,16]",
                      "ae_kl.latent_channels=4", "ae_kl.norm_num_groups=4",
                      "dataset.seq_len=4", "model.latent_dim=32"],
    "latent_convattn": ["ae_kl.block_out_channels=[8,16]",
                        "ae_kl.latent_channels=4", "ae_kl.norm_num_groups=4",
                        "dataset.seq_len=4", "model.embed_dim=16",
                        "model.nhead=2", "model.num_tf_layers=1",
                        "model.latent_dim=16"],
    "mlp_intensity": ["dataset.seq_len=13", "dataset.input_frames=5",
                      "dataset.pred_frames=8", "model.hidden_dim=16"],
    "vae_sevir384": ["model.block_out_channels=[4,4,8,8]",
                     "model.norm_num_groups=4", "dataset.raw_seq_len=49",
                     "dataset.seq_len=4", "dataset.stride=45",
                     "dataset.batch_size=1", "lpips.disc_num_layers=1",
                     "lpips.disc_ndf=8", "lpips.disc_start=0"],
}
LATENT_GAN = ["lpips.enabled=true", "lpips.disc_num_layers=1",
              "lpips.disc_ndf=8", "lpips.disc_start=0"]
# the CLI runs: tests/test_experiments.py's COMMON
COMMON = ["dataset.batch_size=2", "dataset.num_workers=1",
          "dataset.synthetic_events=6", "dataset.img_size=32",
          "trainer.max_epochs=1", "trainer.limit_train_batches=2",
          "trainer.limit_val_batches=1", "trainer.run_test=false",
          "trainer.async_checkpoint=false", "logging.log_every_n_steps=1",
          "logging.val_every_n=10.0", "trainer.save_every_n_steps=10.0"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modules(name):
    """(JAX experiment module, port experiment module) of `name`."""
    return (_load(REPO / "experiments" / name / "train.py", f"_jax_{name}"),
            _load(REPO / "experiments_gpu" / name / "train.py",
                  f"_port_{name}"))


def _configs(name, extra=()):
    path = REPO / "experiments" / name / "config.yaml"
    dots = SPECIFIC[name] + [f"dataset.img_size={HW}"] + list(extra)
    return (JConfig.load(str(path)).merged_dotlist(dots),
            Config.load(str(path)).merged_dotlist(dots))


def _draw(tree, seed):
    """flax's variables drawn with numpy: kernels normal / sqrt(fan_in),
    biases zero, norm scales one, every other parameter 0.02 normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name, shape = path[-1].key, x.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("bias", "scale"):
            v = np.full(shape, float(name == "scale"))
        else:
            v = 0.02 * rng.standard_normal(shape)
        return jnp.asarray(v, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.fixture
def numpy_init(monkeypatch):
    """Every flax Module.init draws its variables with numpy, seeded by the
    module's class name."""
    orig = fnn.Module.init

    def init(self, rngs, *args, **kwargs):
        tree = jax.eval_shape(lambda r: orig(self, r, *args, **kwargs), rngs)
        return _draw(tree, zlib.crc32(type(self).__name__.encode()))

    monkeypatch.setattr(fnn.Module, "init", init)


@pytest.fixture
def shared_noise(monkeypatch):
    """Both packages' posterior samples take the same numpy noise, one
    draw per latent shape."""
    noise = {}

    def draw(shape):
        if shape not in noise:
            noise[shape] = np.random.default_rng(len(noise) + 5).standard_normal(
                shape).astype(np.float32)
        return noise[shape]

    monkeypatch.setattr(jdist.DiagonalGaussianDistribution, "sample",
                        lambda self, rng: self.mean + self.std * jnp.asarray(
                            draw(tuple(self.mean.shape)), self.mean.dtype))
    monkeypatch.setattr(pdist.DiagonalGaussianDistribution, "sample",
                        lambda self, generator=None: self.mean + self.std *
                        torch.from_numpy(draw(tuple(self.mean.shape))).to(
                            self.mean.device, self.mean.dtype))


def _frozen_vae_file(tmp, cfg):
    """A torch state dict of the config's frozen VAE (numpy draw from its
    init_seed) that both packages load through ae_kl.ckpt_path."""
    a = cfg.ae_kl
    vae = AutoencoderKL(in_channels=1, out_channels=1,
                        block_out_channels=tuple(a.block_out_channels),
                        latent_channels=a.latent_channels,
                        norm_num_groups=a.norm_num_groups, device="cpu",
                        seed=3)
    path = str(tmp / "frozen_vae.pt")
    torch.save(vae.state_dict(), path)
    return [f"ae_kl.ckpt_path={path}"]


def _batch(shape, seed=10):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return {"vil": jnp.asarray(x)}, {"vil": torch.from_numpy(x)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------ plain-loss tasks
def test_mlp_intensity_loss_matches_jax(numpy_init):
    jmod, pmod = _modules("mlp_intensity")
    jcfg, pcfg = _configs("mlp_intensity")
    jtask = jmod.build_task(jcfg, None)
    jparams = jtask.init_params(jax.random.key(0))
    ptask = pmod.build_task(pcfg)
    model = ptask.init_params(0, torch.device("cpu"))
    model.load_state_dict(time_mlp_state_dict_from_flax(_np(jparams)))
    jb, pb = _batch((4, 13, 1, HW, HW))
    want, _ = jtask.loss_fn(jparams, jb, jax.random.key(1), 0)
    got, _ = ptask.loss_fn(model, pb, None, 0)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("name", ["latent_convae", "latent_convattn"])
def test_latent_ae_loss_matches_jax(name, numpy_init, shared_noise, tmp_path):
    """The frozen VAE's sampled latents through the latent AE, Huber loss,
    the same posterior noise on both sides."""
    jmod, pmod = _modules(name)
    _, cfg = _configs(name)
    jcfg, pcfg = _configs(name, _frozen_vae_file(tmp_path, cfg))
    jtask = jmod.build_task(jcfg, None)
    jparams = jtask.init_params(jax.random.key(0))
    ptask = pmod.build_task(pcfg, device="cpu")
    model = ptask.init_params(0, torch.device("cpu"))
    model.load_state_dict(latent_ae_state_dict_from_flax(_np(jparams)),
                          strict=True)
    jb, pb = _batch((2, 4, 1, HW, HW))
    want, _ = jax.jit(lambda p, b: jtask.loss_fn(p, b, jax.random.key(1), 0))(
        jparams, jb)
    got, _ = ptask.loss_fn(model, pb, torch.Generator(), 0)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-4)
    got.backward()
    assert all(p.grad is not None for p in model.parameters())


# ------------------------------------------------------------ GAN tasks
# (experiment, extra overrides, the JAX side's own overrides, generator
# converter)
GAN_CASES = {
    "ae_gan": ("ae_gan", [], [], pos_aware_ae_state_dict_from_flax),
    "vae_gan_kl": ("vae_gan_kl", [], [], vae_state_dict_from_flax),
    # at least two channels a GroupNorm group: with one, a conv bias before
    # the norm has no effect on the loss, and the rounding noise of its zero
    # gradient becomes a full Adam step in either package
    "vae_sevir384": ("vae_sevir384", ["trainer.mixed_precision=false",
                                      "model.block_out_channels=[8,16]"],
                     ["model.remat=false"], vae_state_dict_from_flax),
    "latent_convae_gan": ("latent_convae", LATENT_GAN, [],
                          latent_ae_state_dict_from_flax),
}
# (jitted JAX step, its task, its optimizer) by the batch's shape and the
# config as the JAX build_task and step read it: the model built (its
# defaults filled in), img_size, and every other section but the dataset
_JAX_STEPS = {}


def _jax_gan_step(jmod, jcfg, batch_shape):
    cfg = jcfg.to_dict()
    model = cfg.pop("model")
    if "name" in model:
        model = repr(jbuild(model.pop("name"), **model))
    for k in ("experiment_name", "experiment_path", "dataset"):
        cfg.pop(k)
    key = json.dumps([model, cfg, jcfg.dataset.img_size, batch_shape],
                     sort_keys=True)
    if key not in _JAX_STEPS:
        op = jcfg.optim
        jtask = jmod.build_task(jcfg, None)
        jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
            float(op.lr), b1=op.beta1, b2=op.beta2,
            weight_decay=op.weight_decay))
        _JAX_STEPS[key] = (jax.jit(lambda s, b: jtask.custom_train_step(
            s, b, jtx)), jtask, jtx)
    return _JAX_STEPS[key]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case", list(GAN_CASES))
def test_two_gan_steps_match_jax(case, numpy_init, shared_noise, tmp_path):
    """Two steps of the experiment's VAE-GAN task (disc_start 0) on the same
    weights and batches, the config's lr, betas and weight decay with the
    clip at 1.0. Aux scalars rel 1e-4 (abs 1e-7 near zero); each parameter
    within 2.5 lr a step of JAX's and the whole update (in units of each
    one's lr) within rel-L2 1e-3: Adam bounds every element's step by about
    its lr, so a gradient that rounds to the other sign moves that element
    by up to 2 lr (tests/test_torch_port_gan.py)."""
    name, extra, jax_extra, to_sd = GAN_CASES[case]
    jmod, pmod = _modules(name)
    if name == "latent_convae":
        _, cfg = _configs(name, extra)
        extra = extra + _frozen_vae_file(tmp_path, cfg)
    jcfg, _ = _configs(name, extra + jax_extra)
    _, pcfg = _configs(name, extra)
    shape = (2, 4, 1, HW, HW)
    jstep, jtask, jtx = _jax_gan_step(jmod, jcfg, shape)
    ptask = pmod.build_task(pcfg, device="cpu")
    op = pcfg.optim
    lr, disc_lr = float(op.lr), float(pcfg.lpips.get("disc_lr", 4.5e-5))
    ptx = poptim.adamw(lr, weight_decay=op.weight_decay, beta1=op.beta1,
                       beta2=op.beta2, grad_clip=1.0)
    rng = jax.random.key(0)
    jp = jtask.init_params(rng)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=jp,
                    opt_state=jtx.init(jp), rng=rng,
                    extra=jtask.init_extra(rng, jp))
    pp = ptask.init_params(0, torch.device("cpu"))
    pp.gen.load_state_dict(to_sd(_np(jp["gen"])), strict=True)
    pstate = ptrainer.TrainState(step=0, params=pp,
                                 opt_state=ptx.init(list(pp.parameters())),
                                 rng=torch.Generator().manual_seed(0),
                                 extra=ptask.init_extra(0, pp))
    pstate.extra["disc_params"].load_state_dict(
        discriminator_state_dict_from_flax(_np(jstate.extra["disc_params"])),
        strict=True)

    def params(jstate, pstate):
        want = {f"gen.{k}": v for k, v in to_sd(_np(jstate.params["gen"])).items()}
        want.update({f"disc.{k}": v for k, v in discriminator_state_dict_from_flax(
            _np(jstate.extra["disc_params"])).items()})
        if "logvar" in jstate.params:
            want["logvar"] = np.asarray(jstate.params["logvar"])
        got = {k: v.detach().numpy().copy() for k, v in pp.named_parameters()}
        got.update({f"disc.{k}": v.detach().numpy().copy() for k, v in
                    pstate.extra["disc_params"].named_parameters()})
        assert set(got) == set(want)
        return got, {k: np.asarray(want[k]) for k in got}

    before, _ = params(jstate, pstate)
    for i in range(2):
        jb, pb = _batch(shape, seed=20 + i)
        jstate, jaux = jstep(jstate, jb)
        pstate, paux = ptask.custom_train_step(pstate, pb, ptx)
        assert set(paux) == set(jaux), set(paux) ^ set(jaux)
        for k, v in _np(jaux).items():
            np.testing.assert_allclose(float(paux[k]), float(v), rtol=1e-4,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    got, want = params(jstate, pstate)
    got_upd, want_upd = [], []
    for k in got:
        step_lr = disc_lr if k.startswith("disc.") else lr
        np.testing.assert_allclose(got[k], want[k], atol=2.5 * step_lr * 2
                                   + 1e-6, err_msg=k)
        got_upd.append((got[k] - before[k]).ravel() / step_lr)
        want_upd.append((want[k] - before[k]).ravel() / step_lr)
    assert _rel(np.concatenate(got_upd), np.concatenate(want_upd)) <= 1e-3
    assert pstate.step == 2


# --------------------------------------------------- the command lines
CLI_CASES = {
    "ae_gan": [], "vae_gan_kl": [], "vae_sevir384": [],
    "latent_convae": [], "latent_convae_gan": LATENT_GAN,
    "latent_convattn": [], "mlp_intensity": [],
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_command_line_trains_on_cpu(case, tmp_path, capsys):
    """python experiments_gpu/<name>/train.py --device cpu at the narrow
    overrides: two steps on a synthetic cache tree, then "done"."""
    from experiments_gpu.common import main

    name = case.replace("_gan", "") if case == "latent_convae_gan" else case
    mod = _load(REPO / "experiments_gpu" / name / "train.py", f"_cli_{name}")
    main(mod.__file__, mod.build_task, argv=[
        "--device", "cpu", *COMMON, *SPECIFIC[name], *CLI_CASES[case],
        f"experiment_path={tmp_path}"])
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "done"
    assert "[data] train: 2 batches" in out or "[data] train: " in out
