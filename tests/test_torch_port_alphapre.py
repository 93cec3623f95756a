"""The port's AlphaPre and its training task against the JAX package, on the
CPU: the same numpy inputs and weights (``alphapre_state_dict_from_flax``)
through both, at a small size (5 -> 4 frames of 16x16, dim 16, one AmpCell).

Covered: the forward's five outputs, the four losses and their total (the
amplitude weight at a step), the parameter gradients against ``jax.grad``,
``irfft2`` on spectra that are not Hermitian, the input phase,
and two ``Trainer.fit`` steps of the AlphaPre + advection-diffusion prior
task (experiments_gpu/alphapre/train.py against experiments/alphapre/
train.py; on the CPU the JAX stencil takes its XLA version). (The stencil
kernel inside the AlphaPre step on the card: tests/test_torch_port_stencil.py,
which imports no JAX at module level.)

Tolerances: the phase is ill-conditioned at small spectral bins (``angle``
of the same spectrum differs by up to ~3e-5 between XLA's and torch's FFTs
on these frames), and it feeds PhaseNet's convs; the outputs and losses
agree within 1e-5 absolute or relative where stated, the gradients within
1e-4 of each tensor's largest.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import alphapre as jap
from weatherforecastingtoolkit_tpu.training import trainer as jtrainer
from weatherforecastingtoolkit_tpu.training.logging import (
    read_jsonl_metrics as j_read_metrics)
from weatherforecastingtoolkit_tpu.utils import config as jconfig
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.models import alphapre as pap
from weatherforecastingtoolkit_tpu_torch.training import trainer as ptrainer
from weatherforecastingtoolkit_tpu_torch.training.logging import (
    read_jsonl_metrics)
from weatherforecastingtoolkit_tpu_torch.utils import config as pconfig

REPO = Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "experiments" / "alphapre" / "config.yaml")
# hidden 16: two channels a GroupNorm group (8 groups), as the config's 32
# keeps four; with one, a conv bias before the norm has no effect, its
# gradient is rounding noise and AdamW turns that noise into a full step
SMALL = dict(pre_seq_length=5, aft_seq_length=4, input_shape=(16, 16),
             input_dim=1, hidden_dim=16, n_layers=1, spec_num=4)
SMALL_CFG = ["model.T_in=5", "model.T_out=4", "model.input_shape=[16,16]",
             "model.dim=16", "model.n_layers=1", "model.spec_num=4",
             "dataset.img_size=16", "physics_prior.enabled=true",
             "trainer.max_epochs=1", "logging.log_every_n_steps=1",
             "trainer.async_checkpoint=false"]
STEP = 3000          # amp weight 0.01 * (1 - 0.3)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _init(module, shape, seed=0):
    """Variables in the JAX module's tree (``jax.eval_shape`` of its init),
    drawn with numpy: kernels normal / sqrt(fan_in), biases 0.1 normal,
    GroupNorm scales 1 + 0.1 normal, the complex-mixing weights 0.1 normal."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _vil(b, t, hw=16, seed=0):
    ev = synthetic_vil_events(b, hw, hw, t, seed=seed)
    return np.ascontiguousarray(np.transpose(ev, (0, 3, 1, 2))[:, :, None])


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its variables, port model on the same weights, frames_in,
    frames_gt): 2 synthetic VIL sequences, dequantized."""
    j = jap.AlphaPre(**SMALL)
    params = _init(j, (1, 5, 1, 16, 16))
    t = pap.AlphaPre(**SMALL, device="cpu")
    t.load_state_dict(pap.alphapre_state_dict_from_flax(_np(params)),
                      strict=True)
    x = _vil(2, 9).astype(np.float32) / 255.0
    return j, params, t, x[:, :5], x[:, 5:]


@pytest.fixture(scope="module")
def jax_ref(pair):
    """step -> (the JAX forward's five outputs, its loss dict, jax.grad of
    the total loss as a port state dict): one jitted function (one XLA
    compile), the step an argument."""
    j, params, _, fin, fgt = pair

    def total(p, step):
        outs = j.apply(p, jnp.asarray(fin))
        _, losses = j.apply(p, jnp.asarray(fin), jnp.asarray(fgt),
                            compute_loss=True, step=step, method=j.predict)
        return losses["total_loss"], (outs, losses)

    fn = jax.jit(jax.value_and_grad(total, has_aux=True))

    def at(step):
        (_, (outs, losses)), grads = fn(params, jnp.asarray(step, jnp.int32))
        return outs, losses, pap.alphapre_state_dict_from_flax(_np(grads))

    return at


def test_forward_and_losses_match_jax(pair, jax_ref):
    """The five forward outputs (xt, xps, xas, the predicted phase, the
    input amplitudes) within 1e-5 of their magnitude, and the four weighted
    losses and their total rel 1e-5, at step 3000 and past
    aweight_stop_steps."""
    _, _, t, fin, fgt = pair
    want, _, _ = jax_ref(STEP)
    with torch.no_grad():
        got = t(torch.from_numpy(fin))
    for name, g, w in zip(("xt", "xps", "xas", "pha_t", "amps"), got, want):
        atol = 1e-5 * max(1.0, float(np.abs(np.asarray(w)).max()))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=name)
    for step in (STEP, 12000):
        _, jl, _ = jax_ref(step)
        with torch.no_grad():
            _, pl = t.predict(torch.from_numpy(fin), torch.from_numpy(fgt),
                              compute_loss=True, step=step)
        assert sorted(pl) == sorted(jl)
        for k in jl:
            assert float(pl[k]) == pytest.approx(float(jl[k]), rel=1e-5,
                                                 abs=1e-9), (step, k)
    assert float(t.amp_weight_at(STEP)) == pytest.approx(0.007, rel=1e-6)
    assert float(t.amp_weight_at(12000)) == 0.0
    with torch.no_grad():
        pred, none = t.predict(torch.from_numpy(fin))
    assert none is None and pred.shape == fgt.shape


def test_parameter_gradients_match_jax(pair, jax_ref):
    """Gradients of the total loss for every parameter against jax.grad,
    within 1e-4 of each tensor's largest (plus 1e-7): they pass through
    abs(rfft2(.)) and exp(1j * phase) and the complex mixing."""
    _, _, t, fin, fgt = pair
    _, _, want = jax_ref(STEP)
    _, pl = t.predict(torch.from_numpy(fin), torch.from_numpy(fgt),
                      compute_loss=True, step=STEP)
    names, ps = zip(*t.named_parameters())
    grads = torch.autograd.grad(pl["total_loss"], ps)
    assert set(names) == set(want)
    for k, g in zip(names, grads):
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=k,
                                   atol=1e-4 * np.abs(w).max() + 1e-7)


@pytest.mark.parametrize("h,w", [(16, 16), (12, 9)])
@pytest.mark.parametrize("norm", ["backward", "ortho"])
def test_irfft2_takes_non_hermitian_spectra_as_numpy(h, w, norm):
    """The port's irfft2 on random spectra that are not Hermitian in the
    W=0 and W=W/2 columns, over the last two axes and over axes (2, 3) of
    AmpTimeCell's (B, C, H, W_f, T): np.fft.irfft2 in float64 within 1e-6
    (a few fp32 ulps of outputs up to 4), as jnp.fft.irfft2; the imaginary
    parts it drops change nothing."""
    rng = np.random.default_rng(0)
    wf = w // 2 + 1
    spec = (rng.standard_normal((3, h, wf))
            + 1j * rng.standard_normal((3, h, wf))).astype(np.complex64)
    want = np.fft.irfft2(spec.astype(np.complex128), s=(h, w), norm=norm)
    got = pap.irfft2(torch.from_numpy(spec), (h, w), norm=norm).numpy()
    jgot = np.asarray(jnp.fft.irfft2(jnp.asarray(spec), s=(h, w), norm=norm))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(jgot, want, atol=1e-6, rtol=0)
    moved = spec.copy()
    moved[..., 0] += 5j
    if w % 2 == 0:
        moved[..., -1] -= 3j
    np.testing.assert_allclose(
        pap.irfft2(torch.from_numpy(moved), (h, w), norm=norm).numpy(), got,
        atol=1e-6, rtol=0)
    t_last = torch.from_numpy(spec.transpose(1, 2, 0)[None, None].copy())
    np.testing.assert_allclose(
        pap.irfft2(t_last, (h, w), dim=(2, 3), norm=norm)[0, 0].numpy(),
        want.transpose(1, 2, 0), atol=1e-6, rtol=0)


def test_input_phase_matches_jax():
    """PhaseNet's input phase, torch.angle of rfft2(frames): jnp.angle's
    within 1e-4 on random frames (the FFTs round differently; no 2*pi
    jump); pi at the real negative bins ((0, W/2), (H/2, 0), (H/2, W/2)
    carry +0 imaginary parts in both); 0 on an all-zero frame."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 1, 16, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    spec = torch.fft.rfft2(torch.from_numpy(x))
    got = torch.angle(spec).numpy()
    want = np.asarray(jnp.angle(jnp.fft.rfft2(jnp.asarray(x))))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert not got[0, 0, 0].any()
    for i, j in ((0, 8), (8, 0), (8, 8)):
        re = spec.real[..., i, j].numpy()
        assert not spec.imag[..., i, j].any()
        np.testing.assert_array_equal(got[..., i, j][re < 0], np.float32(np.pi))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(cls, tmp, n_batches):
    cfg = cls.load(CONFIG).merged_dotlist(SMALL_CFG + [f"experiment_path={tmp}"])
    derive = jtrainer.derive_steps if cls is jconfig.Config else \
        ptrainer.derive_steps
    return derive(cfg, n_batches, 0)


def test_trainer_two_steps_match_jax_trainer(tmp_path, pair):
    """Two Trainer.fit steps of the AlphaPre + physics-prior task (each
    package's experiment build_task) from the same weights on the same
    batches: every logged loss term, the prior, the grad norm and the LR
    rel 1e-5; params after the two AdamW steps atol 1e-6."""
    _, params, _, _, _ = pair
    jmod = _load(REPO / "experiments" / "alphapre" / "train.py",
                 "_jax_alphapre_train")
    pmod = _load(REPO / "experiments_gpu" / "alphapre" / "train.py",
                 "_port_alphapre_train")
    batches = [{"vil": _vil(2, 9, seed=s)} for s in (1, 2)]
    jcfg = _config(jconfig.Config, tmp_path / "jax", 2)
    pcfg = _config(pconfig.Config, tmp_path / "port", 2)
    jtask = jmod.build_task(jcfg, None)
    jtask.init_params = lambda rng: jax.tree_util.tree_map(jnp.asarray, params)
    jt = jtrainer.Trainer(jcfg, jtask)
    jstate = jt.fit(batches, state=jt.init_state())
    pt = ptrainer.Trainer(pcfg, pmod.build_task(pcfg), device="cpu")
    pstate = pt.init_state()
    pstate.params.load_state_dict(pap.alphapre_state_dict_from_flax(
        _np(params)), strict=True)
    pstate = pt.fit(batches, state=pstate)
    jt.close()
    pt.close()
    keys = ("train_loss", "train_phase_loss", "train_ampli_loss",
            "train_anet_loss", "train_physics_prior", "train_grad_norm",
            "train_lr")
    jrec = [r for r in j_read_metrics(jt.run_dir) if "train_loss" in r]
    prec = [r for r in read_jsonl_metrics(pt.run_dir) if "train_loss" in r]
    assert [r["step"] for r in prec] == [1, 2] == [r["step"] for r in jrec]
    for jr, pr in zip(jrec, prec):
        for k in keys:
            assert pr[k] == pytest.approx(jr[k], rel=1e-5), (pr["step"], k)
    assert pstate.step == 2
    want = pap.alphapre_state_dict_from_flax(jax.device_get(jstate.params))
    for k, v in pstate.params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)
