"""The port's evaluation, sweep, quality and demo scripts against the JAX
package's, on the CPU:
``experiments_gpu/{evaluate,quality_runs,sweep,demo_path_b}.py`` and the
synthetic cache tree they train from
(``data/synthetic.py::make_synthetic_sevir_cache``).

Checked: the cache tree serves, through the port's SEVIRDataModule, the
bits the JAX ``make_synthetic_sevir`` HDF5 tree serves through the JAX
data module (every batch of every split, two split schemes); evaluate.py's
model and persistence metric dicts and its deterministic ensemble CRPS
against the JAX evaluate.py's on the same tree and weights (rel 1e-4,
CSI/HSS abs 1e-3), and the forecaster restored from a run directory;
``quality_runs.report`` against the JAX ``report`` on the same predictions
(the same wins, each metric dict rel 1e-4); the Earthformer quality loss
(MSE + 0.02 (1 - SSIM) + 1e-3 prior) against JAX's on the same weights
(rel 1e-4); sweep.py's retry with ``--resume true``; and demo_path_b.py
with ``--device cpu`` at tests/test_demo.py's flags for each of its cases.
"""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.data.datamodule import (
    SEVIRDataModule as JDataModule)
from weatherforecastingtoolkit_tpu.data.synthetic import (
    make_synthetic_sevir as jax_make_synthetic_sevir)
from weatherforecastingtoolkit_tpu_torch.data.datamodule import (
    SEVIRDataModule)
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    make_synthetic_sevir_cache)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)

REPO = Path(__file__).resolve().parents[1]
CSI_HSS_ABS = 1e-3


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


def _close_metrics(got, want, rtol=1e-4):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        if "CSI" in k or "HSS" in k:
            assert got[k] == pytest.approx(v, abs=CSI_HSS_ABS), k
        else:
            assert got[k] == pytest.approx(v, rel=rtol, abs=1e-7), k


# ------------------------------------------------- part 0: the cache tree
@pytest.mark.parametrize("split", ["date", "val_date"])
def test_cache_tree_serves_the_hdf5_trees_bits(tmp_path, split):
    """10 events at 32² x 25: the default split (train/val by ratio, test
    after the split date) and the 3-way date split of quality_runs and the
    demo."""
    kw = (dict(train_test_split_date=(2019, 2, 1)) if split == "date" else
          dict(val_split_date=(2019, 2, 1), train_test_split_date=None))
    common = dict(seq_len=8, stride=4, batch_size=2, num_workers=0, **kw)
    jax_make_synthetic_sevir(str(tmp_path / "h5"), num_events=10, height=32,
                             width=32)
    jdm = JDataModule(sevir_dir=str(tmp_path / "h5"), **common)
    pdm = SEVIRDataModule(sevir_dir=str(tmp_path / "cache"), use_cache=True,
                          **common)
    make_synthetic_sevir_cache(str(tmp_path / "cache"), pdm.split_dates(),
                               num_events=10, height=32, width=32)
    assert (tmp_path / "h5" / "CATALOG.csv").read_bytes() == \
        (tmp_path / "cache" / "CATALOG.csv").read_bytes()
    pdm._build_cache_once = None   # the caches must be there already
    for dm in (jdm, pdm):
        dm.prepare_data()
        dm.setup()
    n = 0
    for loaders in ((jdm.train_loader(), pdm.train_loader()),
                    (jdm.val_loader(), pdm.val_loader()),
                    (jdm.test_loader(), pdm.test_loader())):
        assert len(loaders[0]) == len(loaders[1])
        for a, b in zip(*loaders):
            assert a.keys() == b.keys()
            assert all(np.array_equal(np.asarray(a[k]), b[k]) for k in a)
            n += 1
    assert n > 10


# ------------------------------------------------------------- evaluate.py
def _eval_argv(tmp, vae_path, extra=()):
    return ["--config", str(REPO / "experiments" / "latent_dlinear" /
                            "config.yaml"),
            "--max-batches", "4", "--ensemble", "2", "--ensemble-stds", "0,0.1",
            "dataset.img_size=32", "dataset.synthetic_events=8",
            "dataset.train_test_split_date=[2019,2,1]", "dataset.batch_size=2",
            "dataset.num_workers=1", "dataset.seq_len=8",
            "dataset.input_frames=5", "dataset.pred_frames=3",
            "ae_kl.block_out_channels=[8,16]", "ae_kl.latent_channels=4",
            "ae_kl.norm_num_groups=4", "dlinear.kernel_size=5",
            f"ae_kl.ckpt_path={vae_path}", f"experiment_path={tmp}", *extra]


def test_evaluate_matches_jax(tmp_path, capsys):
    """Both evaluate.py scripts on the same synthetic events (HDF5 tree / cache tree)
    and the same frozen VAE (a torch state dict through ae_kl.ckpt_path);
    DLinear's init is deterministic, and the port's comes from a run
    directory of its trainer. The ensemble's noise differs between the
    packages' generators: at std 0 the CRPS must agree."""
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import TrainState

    vae = AutoencoderKL(in_channels=1, out_channels=1,
                        block_out_channels=(8, 16), latent_channels=4,
                        norm_num_groups=4, device="cpu", seed=3)
    vae_path = str(tmp_path / "vae.pt")
    torch.save(vae.state_dict(), vae_path)
    run_dir = tmp_path / "run"
    dl = DLinear(5, 3, kernel_size=5, channels=4 * 16 * 16, device="cpu")
    CheckpointManager(str(run_dir)).save(7, TrainState(
        step=7, params=dl, opt_state={}, rng=torch.Generator()))

    jmod = _load(REPO / "experiments" / "evaluate.py", "_jax_evaluate")
    jmod.main(_eval_argv(tmp_path / "jax", vae_path))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pmod = _load(REPO / "experiments_gpu" / "evaluate.py", "_port_evaluate")
    got = pmod.main(["--device", "cpu", "--run-dir", str(run_dir)]
                    + _eval_argv(tmp_path / "port", vae_path))
    out = capsys.readouterr().out
    assert f"[eval] loaded forecaster from {run_dir}" in out
    _close_metrics(got["model"], want["model"])
    _close_metrics(got["persistence"], want["persistence"])
    ens, jens = got["ensemble"], want["ensemble"]
    assert ens["calibration"][0.0] == pytest.approx(
        jens["calibration"]["0.0"], rel=1e-4)
    assert ens["crps_deterministic"] == pytest.approx(
        jens["crps_deterministic"], rel=1e-4)
    assert json.loads(out.strip().splitlines()[-1])["model"] == got["model"]


def test_evaluate_restores_the_run_dirs_forecaster(tmp_path):
    """load_forecaster gives the weights of the newest checkpoint."""
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import TrainState

    pmod = _load(REPO / "experiments_gpu" / "evaluate.py", "_port_evaluate")
    mgr = CheckpointManager(str(tmp_path))
    for step in (3, 5):
        dl = DLinear(5, 3, kernel_size=5, channels=16, device="cpu")
        with torch.no_grad():
            for p in dl.parameters():
                p.add_(step)
        mgr.save(step, TrainState(step=step, params=dl, opt_state={},
                                  rng=torch.Generator()))
    fresh = pmod.load_forecaster(DLinear(5, 3, kernel_size=5, channels=16,
                                         device="cpu"), str(tmp_path))
    for a, b in zip(fresh.parameters(), dl.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        pmod.load_forecaster(fresh, str(tmp_path / "none"))


# --------------------------------------------------------- quality_runs.py
def _recorded(monkeypatch, module):
    """Wrap the module's calc_metrics to record every dict it returns."""
    seen = []
    inner = module.calc_metrics

    def record(pred, target):
        out = inner(pred, target)
        seen.append({k: float(v) for k, v in out.items()})
        return out

    monkeypatch.setattr(module, "calc_metrics", record)
    return seen


def test_quality_report_matches_jax(monkeypatch, capsys):
    """report() on three held-out batches and fixed predictions: the same
    wins and, call for call, the same metric dicts."""
    jq = _load(REPO / "experiments" / "quality_runs.py", "_jax_quality")
    pq = _load(REPO / "experiments_gpu" / "quality_runs.py", "_port_quality")
    rng = np.random.default_rng(4)
    t_in, t_out = 4, 2
    seqs = [rng.random((2, t_in + t_out, 1, 32, 32)).astype(np.float32)
            for _ in range(3)]
    preds = [np.clip(s[:, t_in - 1:t_in] + 0.1 * rng.standard_normal(
        (2, t_out, 1, 32, 32)), 0, 1).astype(np.float32) for s in seqs]

    def predictor(wrap):
        calls = iter(preds)
        return lambda frames_in: wrap(next(calls))

    jseen = _recorded(monkeypatch, jq)
    pseen = _recorded(monkeypatch, pq)
    jwins = jq.report("q", predictor(jnp.asarray), [jnp.asarray(s) for s in seqs],
                      t_in, t_out)
    pwins = pq.report("q", predictor(torch.from_numpy),
                      [torch.from_numpy(s) for s in seqs], t_in, t_out)
    assert pwins == jwins
    assert len(pseen) == len(jseen) == 6
    for got, want in zip(pseen, jseen):
        _close_metrics(got, want)
    out = capsys.readouterr().out
    assert out.count("beats persistence on") == 2


def test_earthformer_quality_loss_matches_jax():
    """The quality recipe's Earthformer (hierarchy 2, 8 global tokens) at
    32² on numpy-drawn weights carried across: the loss (rel 1e-4)."""
    from weatherforecastingtoolkit_tpu.models.earthformer import (
        Earthformer as JEarthformer)
    from weatherforecastingtoolkit_tpu.ops.pallas.stencil import (
        advection_diffusion_prior)
    from weatherforecastingtoolkit_tpu.ops.ssim import ssim as jssim
    from weatherforecastingtoolkit_tpu_torch.models.earthformer import (
        earthformer_state_dict_from_flax)

    pq = _load(REPO / "experiments_gpu" / "quality_runs.py", "_port_quality")
    t_in, t_out, hw = 4, 2, 32
    jm = JEarthformer(t_in=t_in, t_out=t_out, in_channels=1, patch=8, dim=128,
                      depth=4, num_heads=4, window=(4, 4), residual_out=True,
                      hierarchy=2, global_tokens=8)
    tree = jax.eval_shape(jm.init, jax.random.key(0),
                          jnp.zeros((1, t_in, 1, hw, hw)))
    rng = np.random.default_rng(0)

    def leaf(path, x):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(x.shape) / np.sqrt(np.prod(x.shape[:-1]))
        elif name in ("bias", "scale"):
            v = np.full(x.shape, float(name == "scale"))
        else:
            v = 0.02 * rng.standard_normal(x.shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, tree)
    x = rng.random((2, t_in + t_out, 1, hw, hw)).astype(np.float32)

    def jloss(p, x):
        fi, gt = x[:, :t_in], x[:, t_in:]
        pred = jm.apply(p, fi)
        flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
        s = jssim(flat(pred), flat(gt))
        prior = advection_diffusion_prior(
            pred, jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0.05))
        return jnp.mean((pred - gt) ** 2) + 0.02 * (1.0 - s) + 1e-3 * prior

    want = float(jax.jit(jloss)(params, jnp.asarray(x)))
    model = pq.quality_earthformer(t_in, t_out, hw, "cpu", hierarchy=2,
                                   global_tokens=8)
    model.load_state_dict(earthformer_state_dict_from_flax(params),
                          strict=True)
    xt = torch.from_numpy(x)
    got = pq.earthformer_loss(model, xt[:, :t_in], xt[:, t_in:],
                              torch.tensor([0.0, 0.0, 0.05]))
    assert float(got.detach()) == pytest.approx(want, rel=1e-4)
    got.backward()
    # the last block's global-token update reaches nothing, in JAX too
    # (ROADMAP Queue C): every other parameter gets a gradient
    no_grad = {n for n, p in model.named_parameters() if p.grad is None}
    assert len(no_grad) == 14 and all(
        n.startswith("coarse.1.g_") for n in no_grad), no_grad


# ---------------------------------------------------------------- sweep.py
STUB = """import json, os, sys
log = os.environ["SWEEP_LOG"]
calls = json.load(open(log)) if os.path.exists(log) else []
calls.append(sys.argv[1:])
json.dump(calls, open(log, "w"))
sys.exit(3 if len(calls) == 1 else 0)
"""


def test_sweep_retries_a_failed_run_with_resume(tmp_path, monkeypatch):
    """A run that exits non-zero is started again with --resume true; a
    run that keeps failing is reported once its retries are spent."""
    pmod = _load(REPO / "experiments_gpu" / "sweep.py", "_port_sweep")
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    log = tmp_path / "calls.json"
    monkeypatch.setenv("SWEEP_LOG", str(log))
    failed = pmod.main([str(stub), "--runs", "--device cpu a=1 b=2",
                        "--device cpu a=3"])
    assert failed == []
    assert json.loads(log.read_text()) == [
        ["--device", "cpu", "a=1", "b=2"],
        ["--device", "cpu", "a=1", "b=2", "--resume", "true"],
        ["--device", "cpu", "a=3"]]
    stub.write_text("import sys; sys.exit(1)\n")
    assert pmod.main([str(stub), "--runs", "x=1", "--max-retries", "2"]) == [0]


# ---------------------------------------------------------- demo_path_b.py
# tests/test_demo.py's flags and cases
TINY = [
    "--events", "8", "--img-size", "32", "--window-stride", "8",
    "--batch", "2", "--t-in", "4", "--t-out", "2",
    "--blocks", "8,16", "--latent-ch", "4",
    "--steps-ae", "2", "--steps-fc", "2", "--eval-every", "2",
]
CASES = {
    "ema_x_ensemble_e2e": ["--ema", "0.99", "--eval-ensemble", "2",
                           "--steps-e2e", "2"],
    "token_vit": ["--forecaster", "token_vit", "--fc-dim", "16",
                  "--fc-depth", "1"],
    "dec_ft_x_autoregressive": ["--steps-dec-ft", "1", "--steps-dec-ft2", "1",
                                "--eval-autoregressive"],
    "earthformer": ["--forecaster", "earthformer"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_demo_path_b_on_cpu(name, tmp_path, capsys):
    pmod = _load(REPO / "experiments_gpu" / "demo_path_b.py", "_port_demo")
    panel = tmp_path / "panel.png"
    wins = pmod.main(["--device", "cpu", *TINY, *CASES[name],
                      "--save-panel", str(panel)])
    out = capsys.readouterr().out
    assert 0 <= wins <= 5
    assert "persistence" in out and "PSNR_ref" in out, out[-2000:]
    assert "model beats persistence on" in out
    if name != "earthformer":
        assert panel.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert "[stage2]" in out and "[final]" in out
    if name == "ema_x_ensemble_e2e":
        assert "[ensemble]" in out and "[fc] selection: raw" in out
        assert "[e2e] step 2 selection(ema)" in out
    if name == "dec_ft_x_autoregressive":
        assert "[dec-ft]" in out and "[autoregressive]" in out
