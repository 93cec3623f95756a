"""The port's training slice against the JAX package (CPU): schedules and
AdamW against optax, three Trainer steps of the Earthformer + physics-prior
task against the JAX Trainer on the same weights and batches, latent
forecasting on a frozen VAE, checkpoints and resume, EMA gating, Config,
and what the port may import."""

import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import forecasters as jfc
from weatherforecastingtoolkit_tpu.models.vae.autoencoder_kl import (
    AutoencoderKL as JAKL, from_torch_state_dict)
from weatherforecastingtoolkit_tpu.training import optim as joptim
from weatherforecastingtoolkit_tpu.training import tasks as jtasks
from weatherforecastingtoolkit_tpu.training import trainer as jtrainer
from weatherforecastingtoolkit_tpu.training.logging import (
    read_jsonl_metrics as j_read_metrics)
from weatherforecastingtoolkit_tpu.utils import config as jconfig
from weatherforecastingtoolkit_tpu_torch.data.prefetch import device_prefetch
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    synthetic_vil_events)
from weatherforecastingtoolkit_tpu_torch.models import forecasters as pfc
from weatherforecastingtoolkit_tpu_torch.models.earthformer import (
    earthformer_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.training import checkpoint as pckpt
from weatherforecastingtoolkit_tpu_torch.training import optim as poptim
from weatherforecastingtoolkit_tpu_torch.training import tasks as ptasks
from weatherforecastingtoolkit_tpu_torch.training import trainer as ptrainer
from weatherforecastingtoolkit_tpu_torch.training.logging import (
    RunLogger, read_jsonl_metrics)
from weatherforecastingtoolkit_tpu_torch.utils import config as pconfig

REPO = Path(__file__).resolve().parents[1]
EF_CONFIG = str(REPO / "experiments" / "earthformer" / "config.yaml")
# the Earthformer experiment cut to a CPU test: widths, frames and steps
SMALL_EF = ["model.t_in=5", "model.t_out=4", "model.patch=4", "model.dim=32",
            "model.depth=2", "dataset.img_size=32", "trainer.max_epochs=1",
            "logging.log_every_n_steps=1", "trainer.async_checkpoint=false"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each
    keep this file from crowding the other workers out."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vil_batches(n, t, hw=32, batch=2, seed=0):
    ev = synthetic_vil_events(n * batch, hw, hw, t, seed=seed)
    vil = np.ascontiguousarray(np.transpose(ev, (0, 3, 1, 2))[:, :, None])
    return [{"vil": vil[batch * i:batch * (i + 1)]} for i in range(n)]


def _ef_config(cls, tmp, n_batches, extra=()):
    cfg = cls.load(EF_CONFIG).merged_dotlist(
        SMALL_EF + [f"experiment_path={tmp}"] + list(extra))
    derive = jtrainer.derive_steps if cls is jconfig.Config else \
        ptrainer.derive_steps
    return derive(cfg, n_batches, 0)


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name,args", [
    ("cosine_warmup_schedule", (2e-5, 5e-4, 1e-6, 100, 10)),
    ("cosine_warmup_schedule", (1e-4, 1e-3, 0.0, 37, 0)),
    ("one_cycle_schedule", (1e-5, 1e-3, 1e-6, 100, 30))])
def test_schedules_match_optax(name, args):
    """Per step for 100 updates and past the end: rel 1e-5 (optax computes
    in fp32), atol 1e-6 of the peak where the value nears zero."""
    want = getattr(joptim, name)(*args)
    got = getattr(poptim, name)(*args)
    counts = np.arange(110)
    np.testing.assert_allclose([got(int(c)) for c in counts],
                               np.asarray([want(c) for c in counts]),
                               rtol=1e-5, atol=1e-6 * args[1])


@pytest.mark.parametrize("accumulate", [1, 2])
def test_adamw_clip_accumulate_matches_optax(accumulate):
    """5 optimizer updates (5*k micro-steps) of clip(1.0) + AdamW under a
    cosine-warmup schedule, against optax's chain and MultiSteps: atol 1e-6.
    The gradients are scaled so that some updates clip and some do not."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    sched = (1e-3, 1e-2, 1e-4, 5, 2)
    jtx = joptim.adamw(joptim.cosine_warmup_schedule(*sched), 0.01, 0.9, 0.95,
                       1.0, accumulate)
    ptx = poptim.adamw(poptim.cosine_warmup_schedule(*sched), 0.01, 0.9, 0.95,
                       1.0, accumulate)
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in params]
    pstate = ptx.init(pp)
    applied = []
    for step in range(5 * accumulate):
        scale = 0.05 if step % 3 == 0 else 3.0
        g = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
        upd, jstate = jtx.update([jnp.asarray(x) for x in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        applied.append(ptx.update(pp, [torch.from_numpy(x) for x in g], pstate))
        for a, b in zip(jp, pp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    assert applied == [(i + 1) % accumulate == 0 for i in range(5 * accumulate)]
    assert pstate["count"] == 5


def test_global_norm_and_count_params():
    ts = [torch.full((2, 3), 2.0), torch.full((4,), -1.0)]
    want = float(optax.global_norm([jnp.asarray(t.numpy()) for t in ts]))
    assert float(poptim.global_norm(ts)) == pytest.approx(want, rel=1e-6)
    assert poptim.count_params(torch.nn.Linear(3, 2)) == 8


def test_lr_range_test_stops_on_divergence(tmp_path):
    lrs, losses = poptim.lr_range_test(lambda lr: 1.0 + lr * 100, 1e-4, 1.0,
                                       50, output_dir=str(tmp_path))
    jl, jlosses = joptim.lr_range_test(lambda lr: 1.0 + lr * 100, 1e-4, 1.0,
                                       50)
    np.testing.assert_array_equal(lrs, jl)
    np.testing.assert_array_equal(losses, jlosses)
    assert len(lrs) < 50


# ------------------------------------------------------------------ trainer
def test_trainer_three_steps_match_jax_trainer(tmp_path):
    """Three Trainer.fit steps of the Earthformer + advection-diffusion prior
    task (the experiment's build_task on each side) from the same weights on
    the same batches: logged loss, prior, grad norm and LR rel 1e-5; params
    atol 1e-6."""
    jtask_mod = _load(REPO / "experiments" / "earthformer" / "train.py",
                      "_jax_earthformer_train")
    ptask_mod = _load(REPO / "experiments_gpu" / "earthformer" / "train.py",
                      "_port_earthformer_train")
    batches = _vil_batches(3, 9)
    jcfg = _ef_config(jconfig.Config, tmp_path / "jax", 3)
    pcfg = _ef_config(pconfig.Config, tmp_path / "port", 3)
    jt = jtrainer.Trainer(jcfg, jtask_mod.build_task(jcfg, None))
    jstate = jt.init_state()
    pt = ptrainer.Trainer(pcfg, ptask_mod.build_task(pcfg), device="cpu")
    pstate = pt.init_state()
    pstate.params.load_state_dict(earthformer_state_dict_from_flax(
        jax.device_get(jstate.params)), strict=True)
    jstate = jt.fit(batches, state=jstate)
    pstate = pt.fit(batches, state=pstate)
    jt.close()
    pt.close()

    keys = ("train_loss", "train_physics_prior", "train_grad_norm", "train_lr")
    jrec = [r for r in j_read_metrics(jt.run_dir) if "train_loss" in r]
    prec = [r for r in read_jsonl_metrics(pt.run_dir) if "train_loss" in r]
    assert [r["step"] for r in prec] == [1, 2, 3] == [r["step"] for r in jrec]
    for jr, pr in zip(jrec, prec):
        for k in keys:
            assert pr[k] == pytest.approx(jr[k], rel=1e-5), (pr["step"], k)
    assert pstate.step == 3 and pstate.opt_state["count"] == 3
    want = earthformer_state_dict_from_flax(jax.device_get(jstate.params))
    for k, v in pstate.params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-6,
                                   err_msg=k)


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """4 steps, a new Trainer(resume=True), 2 more steps: the same params as
    6 steps straight (atol 1e-6), and the step counters carry over."""
    task_mod = _load(REPO / "experiments_gpu" / "earthformer" / "train.py",
                     "_port_earthformer_train_resume")
    batches = _vil_batches(6, 9, seed=1)
    cfg_a = _ef_config(pconfig.Config, tmp_path / "a", 6)
    straight = ptrainer.Trainer(cfg_a, task_mod.build_task(cfg_a), device="cpu")
    want = straight.fit(batches)
    straight.close()

    cfg_b = _ef_config(pconfig.Config, tmp_path / "b", 6)
    first = ptrainer.Trainer(cfg_b, task_mod.build_task(cfg_b), device="cpu")
    first.fit(batches[:4])
    first.close()
    second = ptrainer.Trainer(cfg_b, task_mod.build_task(cfg_b), device="cpu",
                              resume=True)
    assert second.run_id == first.run_id
    state = second.init_state()
    assert state.step == 4 and state.opt_state["count"] == 4
    state = second.fit(batches[4:], state=state)
    second.close()
    assert state.step == 6
    for (k, a), b in zip(want.params.state_dict().items(),
                         state.params.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, err_msg=k)
    assert torch.equal(want.rng.get_state(), state.rng.get_state())


def _tiny_task():
    def init_params(seed, device):
        torch.manual_seed(seed)
        return torch.nn.Linear(3, 1).to(device)

    def loss_fn(model, batch, rng, step):
        x = torch.as_tensor(batch["x"])
        return torch.mean((model(x) - x.sum(-1, keepdim=True)) ** 2), {}

    return ptrainer.Task(name="tiny", init_params=init_params, loss_fn=loss_fn)


def _tiny_config(tmp, **trainer):
    return pconfig.Config({
        "experiment_name": "tiny", "experiment_path": str(tmp), "seed": 0,
        "optim": {"schedule": "constant", "lr": 0.1, "weight_decay": 0.0},
        "trainer": dict({"total_train_steps": 4, "max_epochs": 1,
                         "async_checkpoint": False}, **trainer),
        "logging": {"log_every_n_steps": 1}})


def test_ema_ticks_only_on_optimizer_updates(tmp_path):
    """accumulate_grad_batches=2: the EMA moves on micro-steps 2 and 4 only,
    to d*ema + (1-d)*params, exactly."""
    t = ptrainer.Trainer(_tiny_config(tmp_path, ema_decay=0.5,
                                      accumulate_grad_batches=2),
                         _tiny_task(), device="cpu")
    state = t.init_state()
    rng = np.random.default_rng(0)
    ema = {k: v.clone() for k, v in state.extra["ema_params"].items()}
    for step in range(1, 5):
        params_before = {k: p.detach().clone()
                         for k, p in state.params.named_parameters()}
        state, aux = t._train_step(state, {
            "x": torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))})
        now = dict(state.params.named_parameters())
        if step % 2:
            for k in ema:
                assert torch.equal(now[k], params_before[k])   # no update yet
        else:
            ema = {k: 0.5 * ema[k] + 0.5 * now[k].detach() for k in ema}
        for k in ema:
            torch.testing.assert_close(state.extra["ema_params"][k], ema[k],
                                       rtol=0, atol=1e-7)
        assert float(aux["grad_norm"]) > 0
    assert ptrainer.Trainer.ema_params(state) is state.extra["ema_params"]
    t.close()


def test_resume_across_an_ema_toggle(tmp_path, capsys):
    """A checkpoint written without EMA resumes under ema_decay (the shadow
    seeded from the params), and one written with EMA resumes without it."""
    batches = [{"x": np.ones((2, 3), np.float32) * i} for i in range(1, 5)]
    plain = ptrainer.Trainer(_tiny_config(tmp_path), _tiny_task(), device="cpu")
    state = plain.fit(batches)
    plain.close()
    with_ema = ptrainer.Trainer(_tiny_config(tmp_path, ema_decay=0.9),
                                _tiny_task(), device="cpu", resume=True)
    restored = with_ema.init_state()
    assert restored.step == 4 and "seeding ema_params" in capsys.readouterr().out
    for k, p in state.params.named_parameters():
        assert torch.equal(restored.extra["ema_params"][k], p.detach())
    with_ema.fit(batches[:1], state=restored)  # writes a checkpoint with EMA
    with_ema.close()
    without = ptrainer.Trainer(_tiny_config(tmp_path), _tiny_task(),
                               device="cpu", resume=True)
    assert without.init_state().extra is None
    assert "dropping the shadow tree" in capsys.readouterr().out
    without.close()


def test_derive_steps_matches_jax():
    for trainer in ({"max_epochs": 3}, {"max_epochs": 2,
                                        "accumulate_grad_batches": 4},
                    {"max_epochs": 5, "limit_train_batches": 0.5,
                     "limit_val_batches": 0.25},
                    {"max_epochs": 2, "overfit_batches": 3}):
        base = {"trainer": trainer}
        want = jtrainer.derive_steps(jconfig.Config(base), 37, 11, 5)
        got = ptrainer.derive_steps(pconfig.Config(base), 37, 11, 5)
        assert got.to_dict() == want.to_dict()


def test_run_with_retry(capsys):
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("boom")

    ptrainer.run_with_retry(flaky, max_retries=5, backoff_s=0.0)
    assert len(calls) == 3
    assert capsys.readouterr().out.splitlines()[-1] == "done"
    with pytest.raises(RuntimeError, match="exhausted"):
        ptrainer.run_with_retry(lambda: 1 / 0, max_retries=2, backoff_s=0.0)


def test_validate_loss_only_and_unported_parts(tmp_path):
    cfg = _tiny_config(tmp_path)
    t = ptrainer.Trainer(cfg, _tiny_task(), device="cpu")
    state = t.init_state()
    val = [{"x": np.ones((2, 3), np.float32)}]
    with torch.no_grad():
        want = float(t.task.loss_fn(state.params, val[0], None, 0)[0])
    assert t.validate(state, val, step=0)["loss"] == pytest.approx(want)
    t.close()
    task = _tiny_task()
    field = torch.full((1, 2, 1, 16, 16), 0.5)
    task.eval_fn = lambda model, batch, rng: (field, field)
    t2 = ptrainer.Trainer(cfg, task, device="cpu")
    out = t2.validate(t2.init_state(), val, step=0)
    assert out["SSIM"] == pytest.approx(1.0) and out["CSI_0"] == pytest.approx(1.0)
    t2.close()
    # trainer.fsdp without a mesh is ignored, as in JAX (the mesh paths
    # are tests/test_torch_port_parallel.py's)
    t3 = ptrainer.Trainer(cfg.merge({"trainer": {"fsdp": True}}),
                          _tiny_task(), device="cpu")
    assert not t3.fsdp and t3.batch_sharding() is None
    t3.close()
    logger = RunLogger(str(tmp_path / "log"))
    logger.log_images(np.zeros((1, 2, 8, 8)), np.ones((1, 2, 1, 8, 8)),
                      "val panels", 0)
    assert (tmp_path / "log" / "media" / "val_panels_step0_b0.png").exists()
    logger.log_histograms({"w": np.arange(5.0)}, 3)
    logger.close()


# ------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_and_max_to_keep(tmp_path):
    task = _tiny_task()
    t = ptrainer.Trainer(_tiny_config(tmp_path), task, device="cpu")
    state = t.init_state()
    mgr = pckpt.CheckpointManager(str(tmp_path / "run"), max_to_keep=2,
                                  async_save=True)
    for step in (1, 2, 3):
        state.step = step
        mgr.save(step, state)
    mgr.wait_until_finished()
    assert mgr.all_steps() == [2, 3]
    saved = state.params.weight.detach().clone()
    with torch.no_grad():
        state.params.weight.add_(1.0)    # the snapshot was taken at save()
    fresh = t._init_state(123)
    got = mgr.restore(fresh)
    assert got.step == 3
    assert torch.equal(got.params.weight, saved)
    assert got.opt_state.keys() == state.opt_state.keys()
    t.close()


def test_find_latest_skips_a_corrupt_checkpoint(tmp_path, capsys):
    task = _tiny_task()
    cfg = _tiny_config(tmp_path)
    t = ptrainer.Trainer(cfg, task, device="cpu", run_id="r1")
    state = t.init_state()
    t.ckpt.save(1, state)
    state.step = 2
    t.ckpt.save(2, state)
    t.close()
    newest = os.path.join(t.run_dir, "checkpoints", "2", "state.pt")
    with open(newest, "wb") as f:
        f.write(b"not a checkpoint")
    os.utime(os.path.dirname(newest), (2e9, 2e9))
    template = t._init_state(0)
    restored, run_id, step = pckpt.find_latest_ckpt(
        str(tmp_path), "tiny", template)
    assert (run_id, step, restored.step) == ("r1", 1, 0)
    assert "corrupt" in capsys.readouterr().out
    # a template of another structure matches nothing
    other = template.replace(extra={"x": torch.zeros(2)})
    assert pckpt.find_latest_ckpt(str(tmp_path), "tiny", other) == (None,) * 3
    assert "TEMPLATE MISMATCH" in capsys.readouterr().out


# ------------------------------------------------------- latent forecasting
def test_latent_forecast_task_matches_jax(rng):
    """The Path-B objective on a frozen VAE (same weights on both sides) and
    DLinear: loss rel 1e-4 (fp32 VAE encoder), and the forecaster's
    gradients reach only the forecaster."""
    vae_kw = dict(in_channels=1, out_channels=1, block_out_channels=(32, 64),
                  layers_per_block=1, latent_channels=4, norm_num_groups=8)
    vae = AutoencoderKL(**vae_kw, device="cpu", seed=1)
    jvae = JAKL(**vae_kw)
    jvars = from_torch_state_dict(
        jvae, {k: v.numpy() for k, v in vae.state_dict().items()},
        example_shape=(1, 1, 32, 32))
    latent = (4, 16, 16)
    d = int(np.prod(latent))
    jfore = jfc.DLinear(seq_len=5, pred_len=4, kernel_size=3)
    jparams = jax.device_get(jfore.init(jax.random.key(0), jnp.zeros((1, 5, d))))
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.01 * rng.standard_normal(a.shape)
        .astype(np.float32), jparams)
    pfore = pfc.DLinear(5, 4, kernel_size=3, device="cpu")
    pfore.load_state_dict(pfc.dlinear_state_dict_from_flax(jparams))

    jtask = jtasks.latent_forecast_task(
        lambda f, r: jvae.apply(jvars, f, method=jvae.encode).mode(), jfore,
        5, 4, latent)
    ptask = ptasks.latent_forecast_task(
        lambda f, r: vae.encode(f).mode(), pfore, 5, 4, latent)
    batch = _vil_batches(1, 9)[0]
    want, _ = jtask.loss_fn(jparams, {"vil": jnp.asarray(batch["vil"])}, None, 0)
    model = ptask.init_params(0, torch.device("cpu"))
    assert model is not pfore
    loss, _ = ptask.loss_fn(model, {"vil": torch.from_numpy(batch["vil"])},
                            None, 0)
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-4)
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    assert all(p.grad is None for p in vae.parameters())


def test_pixel_loss_and_dequantize_match_jax(rng):
    a, b = (rng.standard_normal((2, 3, 4)).astype(np.float32) * 2
            for _ in range(2))
    for kind in ("l1", "mse", "huber"):
        want = float(jtasks.pixel_loss(kind)(jnp.asarray(a), jnp.asarray(b)))
        got = float(ptasks.pixel_loss(kind)(torch.from_numpy(a),
                                            torch.from_numpy(b)))
        assert got == pytest.approx(want, rel=1e-6)
    u8 = rng.integers(0, 256, (2, 5), dtype=np.uint8)
    np.testing.assert_array_equal(
        ptasks.dequantize(torch.from_numpy(u8)).numpy(),
        np.asarray(jtasks.dequantize(jnp.asarray(u8))))


# ------------------------------------------------------------------ config
def test_config_dotlist_matches_jax(tmp_path):
    base = {"optim": {"lr": 1e-3, "betas": [0.9, 0.95]}, "trainer": {"x": 1}}
    items = ["optim.lr=3e-4", "optim.betas=[0.8, 0.9]", "trainer.x=null",
             "trainer.x=true", "trainer.x=abc", "trainer.x=7"]
    for item in items:
        want = jconfig.Config(base).merged_dotlist([item]).to_dict()
        assert pconfig.Config(base).merged_dotlist([item]).to_dict() == want
    for bad in (["optim.nope=1"], ["nope.lr=1"], ["optim.lr"]):
        with pytest.raises(jconfig.ConfigError) as jerr:
            jconfig.Config(base).merged_dotlist(bad)
        with pytest.raises(pconfig.ConfigError) as perr:
            pconfig.Config(base).merged_dotlist(bad)
        assert str(perr.value) == str(jerr.value)
    path = str(tmp_path / "c.yaml")
    pconfig.Config(base).save(path)
    assert pconfig.Config.load(path) == jconfig.Config.load(path)
    assert pconfig.Config.load(EF_CONFIG) == jconfig.Config.load(EF_CONFIG)


# ------------------------------------------------------- devices, imports
def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrainer.Trainer(_tiny_config(tmp_path), _tiny_task())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(device_prefetch([{"x": np.zeros(2)}]))
    batch = next(device_prefetch([{"x": np.zeros(2)}], device="cpu"))
    assert batch["x"].is_cpu and not batch["x"].is_pinned()


# bench.py and __graft_entry__.py import the JAX package: a port script
# reaching either reaches JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "chex",
             "weatherforecastingtoolkit_tpu", "bench", "__graft_entry__")
ROOT_SCRIPTS = ("chip_smoke.py", "bf16_gate_draws.py", "graft_entry_torch.py",
                "kernel_timing.py")


def _port_files():
    files = sorted((REPO / "weatherforecastingtoolkit_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "experiments_gpu").rglob("*.py"))
    return files + [REPO / name for name in ROOT_SCRIPTS]


def test_port_imports_no_jax():
    """No import statement in the port, experiments_gpu/ or the root
    scripts of the port names JAX, flax, optax, the JAX package, bench.py
    or __graft_entry__.py, and importing every module of the port and of
    experiments_gpu/ in a fresh interpreter loads none of them."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in _port_files()[:-len(ROOT_SCRIPTS)]
               if p.name != "__init__.py"]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"hit = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not hit, hit\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_lazy_aliases_resolve():
    """Every top-level alias of the port names a real object (the JAX
    package's __init__ carries the same names)."""
    import weatherforecastingtoolkit_tpu as jax_pkg
    import weatherforecastingtoolkit_tpu_torch as port

    for name in port._LAZY:
        assert getattr(port, name) is not None
        assert name in dir(jax_pkg), name
