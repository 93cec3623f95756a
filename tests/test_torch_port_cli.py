"""The port's training command line (experiments_gpu/common.py) on the CPU:
narrow latent_dlinear, latent_linear and Earthformer runs through `main`
(validation panels, resume, bf16 encoder, the LR range test), the default
device, the frozen VAE from a torch checkpoint against the JAX package's
`from_torch_state_dict`, and the validation panels' pixels against
matplotlib's colormaps, written where matplotlib is absent."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from matplotlib import colormaps
from matplotlib.colors import Normalize

from weatherforecastingtoolkit_tpu.data.colormap import vil_cmap
from weatherforecastingtoolkit_tpu.utils.config import Config as JConfig
from weatherforecastingtoolkit_tpu_torch.data.colormap import (reds_rgb,
                                                               vil_rgb)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
    AutoencoderKL)
from weatherforecastingtoolkit_tpu_torch.training.logging import RunLogger
from weatherforecastingtoolkit_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
EXPERIMENTS = ("latent_dlinear", "latent_linear", "earthformer", "alphapre",
               "token_vit", "ae_recon")

# tests/test_experiments.py's smoke overrides, with a validation split
COMMON = ["dataset.batch_size=2", "dataset.num_workers=1",
          "dataset.synthetic_events=6", "dataset.img_size=32",
          "dataset.val_ratio=0.5", "trainer.max_epochs=1",
          "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
          "trainer.run_test=false", "trainer.async_checkpoint=false",
          "logging.log_every_n_steps=1", "logging.val_every_n=0.2",
          "trainer.save_every_n_steps=10.0"]
LATENT = ["ae_kl.block_out_channels=[8,16]", "ae_kl.latent_channels=4",
          "ae_kl.norm_num_groups=4", "dataset.seq_len=8",
          "dataset.input_frames=5", "dataset.pred_frames=3"]
SPECIFIC = {
    "latent_dlinear": LATENT + ["dlinear.kernel_size=5"],
    "latent_linear": LATENT,
    "earthformer": ["model.t_in=5", "model.t_out=3", "model.patch=8",
                    "model.dim=16", "model.depth=2", "model.num_heads=2",
                    "model.window=[2,2]", "dataset.seq_len=8"],
}


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


def _script(name):
    return str(REPO / "experiments_gpu" / name / "train.py")


def _run(name, tmp, extra=(), resume=False):
    from experiments_gpu.common import main

    mod = _load(_script(name), f"port_{name}_train")
    argv = ["--device", "cpu"] + (["--resume", "true"] if resume else []) \
        + COMMON + SPECIFIC[name] + list(extra) + [f"experiment_path={tmp}"]
    main(mod.__file__, mod.build_task, argv=argv)


def _records(tmp, name):
    (run_dir,) = (Path(tmp) / "outputs" / name / "runs").iterdir()
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return run_dir, [json.loads(line) for line in lines]


CLI_CASES = [("latent_dlinear", []), ("latent_linear", []),
             ("latent_dlinear", ["trainer.mixed_precision=true",
                                 "dlinear.individual=true"]),
             ("earthformer", ["physics_prior.enabled=true",
                              "lr_range_test.enabled=true",
                              "lr_range_test.num_iter=3"])]


@pytest.mark.parametrize("name,extra", CLI_CASES,
                         ids=["latent_dlinear", "latent_linear",
                              "latent_dlinear-bf16", "earthformer-lrt"])
def test_cli_trains_on_cpu(tmp_path, capsys, name, extra):
    """Two steps through main: the data smoke prints, finite losses, a
    validation with its panels, the config and train.py in the run dir."""
    _run(name, tmp_path, extra)
    out = capsys.readouterr().out
    assert out.splitlines()[-1] == "done"
    assert "[data] train: " in out and "[data] val: " in out
    run_dir, recs = _records(tmp_path, name)
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    val = [r for r in recs if "val_loss" in r]
    assert val and np.isfinite(val[0]["val_SSIM"])
    assert list((run_dir / "media").glob("val_panels_step*_b0.png"))
    assert (run_dir / "train.py").read_text() == Path(_script(name)).read_text()
    assert (run_dir / "config.yaml").exists()
    if "lr_range_test.enabled=true" in extra:
        assert "[lr_range_test] swept 3 LRs" in out


def test_cli_resume_continues(tmp_path, capsys):
    """--resume true finds the first run's last checkpoint and continues
    its step count in the same run dir."""
    _run("earthformer", tmp_path)
    _run("earthformer", tmp_path, resume=True)
    out = capsys.readouterr().out
    assert "[trainer] resuming run" in out and "at step 2" in out
    _, recs = _records(tmp_path, "earthformer")
    steps = [r["step"] for r in recs if "train_loss" in r]
    assert steps == [1, 2, 3, 4]


def test_cli_default_device_is_cuda():
    """`python experiments_gpu/<name>/train.py` runs on cuda by default:
    without a GPU each of the six raises before it reads any data."""
    code = f"""
import runpy, sys
for name in {EXPERIMENTS!r}:
    script = {str(REPO)!r} + "/experiments_gpu/" + name + "/train.py"
    sys.argv = [script, "experiment_path=/nonexistent/never_written"]
    try:
        runpy.run_path(script, run_name="__main__")
    except RuntimeError as e:
        assert "no CUDA device" in str(e), (name, e)
        print("RAISED", name)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [w for n in EXPERIMENTS
                                  for w in ("RAISED", n)]
    assert not os.path.exists("/nonexistent/never_written")


def test_frozen_vae_from_torch_checkpoint(tmp_path):
    """build_frozen_vae from a CasCast-format torch .pt gives the JAX
    package's from_torch_state_dict latents (and decodes) on the same
    frames."""
    pcommon = _load(str(REPO / "experiments_gpu" / "latent_common.py"),
                    "port_latent_common")
    jcommon = _load(str(REPO / "experiments" / "latent_common.py"),
                    "jax_latent_common")
    src = AutoencoderKL(in_channels=1, out_channels=1,
                        block_out_channels=(8, 16), latent_channels=4,
                        norm_num_groups=4, device="cpu", seed=11)
    sd = {f"module.{k}": v for k, v in src.state_dict().items()}
    ckpt = str(tmp_path / "vae.pt")
    torch.save({"model": {"autoencoder_kl": sd}}, ckpt)
    dotlist = ["ae_kl.block_out_channels=[8,16]", "ae_kl.latent_channels=4",
               "ae_kl.norm_num_groups=4", "dataset.img_size=32",
               f"ae_kl.ckpt_path={ckpt}", "ae_kl.submodel=autoencoder_kl"]
    cfg_path = str(REPO / "experiments" / "latent_dlinear" / "config.yaml")
    pcfg = Config.load(cfg_path).merged_dotlist(dotlist)
    jcfg = JConfig.load(cfg_path).merged_dotlist(dotlist)
    penc, pmode, pdec, pshape = pcommon.build_frozen_vae(pcfg, device="cpu")
    jenc, jmode, jdec, jshape = jcommon.build_frozen_vae(jcfg)
    assert tuple(pshape) == tuple(jshape) == (4, 16, 16)
    frames = np.random.default_rng(0).random((3, 1, 32, 32), np.float32)
    with torch.no_grad():
        pz = pmode(torch.from_numpy(frames)).numpy()
        prec = pdec(torch.from_numpy(pz)).numpy()
    jz = np.asarray(jax.jit(jmode)(frames))
    np.testing.assert_allclose(pz, jz, atol=2e-4)
    np.testing.assert_allclose(prec, np.asarray(jax.jit(jdec)(jz)), atol=5e-4)
    with torch.no_grad():
        z = penc(torch.from_numpy(frames), torch.Generator().manual_seed(0))
    assert z.shape == (3, 4, 16, 16) and torch.isfinite(z).all()


def test_panel_pixels_match_matplotlib(tmp_path):
    """Every uint8 value's VIL and Reds pixel is matplotlib's
    cmap(norm(v), bytes=True), and log_images tiles them into the PNG."""
    cmap, norm, _, _ = vil_cmap()
    v = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(vil_rgb(v), cmap(norm(v), bytes=True)[:, :3])
    edge = np.array([-1.0, 254.5, 255.0, 300.0, np.nan])
    np.testing.assert_array_equal(
        vil_rgb(edge), cmap(norm(np.ma.masked_invalid(edge)), bytes=True)[:, :3])
    reds = colormaps["Reds"]
    np.testing.assert_array_equal(
        reds_rgb(v), reds(Normalize(vmin=0, vmax=255)(v), bytes=True)[:, :3])

    from PIL import Image

    rng = np.random.default_rng(1)
    target = rng.random((2, 3, 1, 8, 5)).astype(np.float32)
    pred = np.clip(target + rng.normal(0, 0.2, target.shape), 0, 1)
    log = RunLogger(str(tmp_path))
    log.log_images(pred, target, "val/panels", 7, batch_idxs=1)
    log.close()
    png = np.asarray(Image.open(tmp_path / "media" / "val_panels_step7_b0.png"))
    tgt = (np.clip(target[0, :, 0], 0, 1) * 255).astype(np.uint8)
    prd = (np.clip(pred[0, :, 0], 0, 1) * 255).astype(np.uint8)
    diff = np.abs(tgt.astype(float) - prd.astype(float)).astype(np.uint8)
    rows = [cmap(norm(tgt), bytes=True), cmap(norm(prd), bytes=True),
            reds(Normalize(vmin=0, vmax=255)(diff), bytes=True)]
    want = np.concatenate([np.concatenate(list(r[..., :3]), axis=1)
                           for r in rows], axis=0)
    assert png.shape == (24, 15, 3)
    np.testing.assert_array_equal(png, want)
    assert not (tmp_path / "media" / "val_panels_step7_b1.png").exists()


def test_fit_writes_panels_without_matplotlib(tmp_path):
    """In an interpreter where matplotlib cannot be imported, the CLI's
    Trainer.fit validates with its val_loader and writes the panel PNG."""
    argv = (["--device", "cpu"] + COMMON + SPECIFIC["latent_dlinear"]
            + [f"experiment_path={tmp_path}"])
    code = f"""
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, {str(REPO)!r})
import torch
torch.set_num_threads(2)
from experiments_gpu.common import main
import importlib.util
spec = importlib.util.spec_from_file_location(
    "t", {_script("latent_dlinear")!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
main(mod.__file__, mod.build_task, argv={argv!r})
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1] == "done"
    run_dir, _ = _records(tmp_path, "latent_dlinear")
    pngs = list((run_dir / "media").glob("val_panels_step*_b*.png"))
    assert pngs and all(p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
                        for p in pngs)
