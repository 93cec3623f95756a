"""The port's perf entry points (experiments_gpu/perf/) and token_vit's frozen
ViTAE from a run directory, on the CPU.

  * bench_helpers.build_pipeline against bench.build_jax_pipeline at narrow
    widths on the same variables (flax's init replaced by a numpy draw of
    its tree, carried across by the port's converters): outputs within
    5e-4, the pipelines' tolerance; calibrate_qscales against
    bench.calibrate_qscales;
  * the FLOP count of one conv and one matmul is 2*M*N*K;
  * int8_mixed's families and greedy mix give the JAX module's winning spec
    from the same SSIM table;
  * space_to_depth --check-only, and the packed channel order of
    tests/test_fast_vae.py:24 against the JAX script's functions;
  * every script's main with --device cpu at the narrowest shapes it
    allows, printing its table; full_res_serving records an out-of-memory
    error and raises any other;
  * token_vit restoring its ViTAE from an ae_recon run of the port (the
    restored encodings), and refusing a missing, empty or mismatched run.
"""

import ast
import contextlib
import importlib
import io
import sys
import zlib
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from experiments_gpu.perf import bench_helpers as bh  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.forecasters import (  # noqa: E402
    dlinear_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (  # noqa: E402
    state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.ops.quant import qscales_from_flax  # noqa: E402

NARROW_KW = dict(block_out_channels=(8, 16), latent_channels=4,
                 norm_num_groups=4)
HW = 16


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def numpy_init(monkeypatch):
    """flax's Module.init draws 'params' with numpy (the other collections
    zero), each leaf seeded by its path; the trees drawn, by class name."""
    orig = fnn.Module.init
    drawn = {}

    def draw(path, leaf):
        if path[0].key != "params":
            return np.zeros(leaf.shape, leaf.dtype)
        g = np.random.default_rng(zlib.crc32(
            jax.tree_util.keystr(path).encode()))
        name = path[-1].key
        if name == "kernel":
            v = g.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * g.standard_normal(leaf.shape)
        else:
            v = 0.05 * g.standard_normal(leaf.shape)
        return v.astype(np.float32)

    def init(self, rngs, *args, **kwargs):
        tree = jax.eval_shape(lambda r: orig(self, r, *args, **kwargs), rngs)
        out = jax.tree_util.tree_map_with_path(draw, tree)
        drawn[type(self).__name__] = out
        return out

    monkeypatch.setattr(fnn.Module, "init", init)
    return drawn


def _frames(b, hw=HW, seed=0):
    return np.random.default_rng(seed).random(
        (b, bh.T_IN, 1, hw, hw)).astype(np.float32)


def test_build_pipeline_and_calibration_match_bench(numpy_init):
    """The port's rollout of bench.py's recipe equals the JAX one on the
    same variables (fp32, 5e-4). The calibration's scales: the encoder's
    conv_in (whose input is the frames) bit for bit, every other within
    2e-6 of its largest entry, tests/test_torch_port_quant.py's rule: the
    two packages' fp32 convs and GroupNorms sum in other orders, and by
    the decoder that moves a scale by more than rel 1e-6 (1.47e-6
    measured here)."""
    import bench

    frames = _frames(2)
    jpipe, jfc = bench.build_jax_pipeline("float32", vae_kwargs=NARROW_KW)
    want = np.asarray(jpipe(jfc, frames))
    vae_state = state_dict_from_flax(numpy_init["AutoencoderKL"]["params"])
    pipe, fc = bh.build_pipeline("float32", vae_kwargs=NARROW_KW, hw=HW,
                                 device="cpu", vae_state=vae_state)
    fc.load_state_dict(dlinear_state_dict_from_flax(jfc), strict=True)
    got = pipe(fc, torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, bh.T_OUT, 1, HW, HW)
    np.testing.assert_allclose(got, want, atol=5e-4)

    jq = qscales_from_flax(jax.device_get(bench.calibrate_qscales(
        frames, vae_kwargs=NARROW_KW)))
    q = bh.calibrate_qscales(torch.from_numpy(frames), NARROW_KW,
                             vae_state=vae_state)
    assert set(q) == set(jq) and len(q) > 0
    assert torch.equal(q["encoder/conv_in"], jq["encoder/conv_in"])
    for path, v in q.items():
        np.testing.assert_allclose(v.numpy(), jq[path].numpy(), rtol=0,
                                   atol=2e-6 * float(jq[path].max()),
                                   err_msg=path)


def test_flop_counter_conv_and_matmul():
    """count_cost's FLOPs are 2*M*N*K for a conv (M output positions, N
    output channels, K = Cin*kh*kw) and a matmul; its bytes count every
    input and output once."""
    x = torch.randn(2, 3, 9, 9)
    w = torch.randn(5, 3, 3, 3)
    flops, nbytes = bh.count_cost(
        lambda: torch.nn.functional.conv2d(x, w, padding=1))
    assert flops == 2 * (2 * 9 * 9) * 5 * (3 * 3 * 3)
    assert nbytes == 4 * (x.numel() + w.numel() + 2 * 5 * 9 * 9)
    a, b = torch.randn(7, 11), torch.randn(11, 13)
    flops, nbytes = bh.count_cost(lambda: a @ b)
    assert flops == 2 * 7 * 13 * 11
    assert nbytes == 4 * (7 * 11 + 11 * 13 + 7 * 13)


# the SSIM of a spec: one minus the damages of its int8 families
DAMAGE = {"encoder/conv_in": 0.001, "encoder/mid_block": 0.002,
          "encoder/conv_out": 0.0045, "decoder/conv_in": 0.006}


def _table_ssim(spec):
    fams = [p[:-1] for p, m in spec if m == "int8_static"]
    return 1.0 - sum(DAMAGE.get(f, 0.01) for f in fams)


def test_int8_mixed_selection_matches_jax(monkeypatch):
    """The JAX sweep's main (a stub bench, its SSIM read from the table)
    and the port's families / leave_one_in / greedy_mix on the same table
    print the same winning spec."""
    import weatherforecastingtoolkit_tpu.data.synthetic as jsyn
    import weatherforecastingtoolkit_tpu.ops.ssim as jssim
    import weatherforecastingtoolkit_tpu.utils.backend as jbackend
    from experiments_gpu.perf import int8_mixed as port

    sys.path.insert(0, str(REPO / "experiments" / "perf"))
    try:
        jmod = importlib.import_module("int8_mixed")
    finally:
        sys.path.remove(str(REPO / "experiments" / "perf"))
    specs = []

    class StubBench:
        HW, T_IN, T_OUT, BATCH, FAST_BATCH = 4, 2, 2, 2, 2
        VAE_CHANNELS = (4, 8)
        FAST_VAE_KW = {"block_out_channels": (4, 8)}

        def calibrate_qscales(self, frames, vae_kwargs=None):
            return {}

        def build_jax_pipeline(self, dtype, conv_mode="native",
                               vae_kwargs=None, qscales=None):
            return conv_mode, None

        def _time_pipeline(self, pipe, fc, frames, n_rep=10):
            specs.append(pipe)
            return 0.1, None, np.full((1, 1, 4, 4), len(specs) - 1.0)

    def ssim(ref, out):
        mode = specs[int(np.asarray(out).ravel()[0])]
        return 1.0 if mode == "native" else _table_ssim(mode)

    monkeypatch.setattr(jmod, "bench", StubBench())
    monkeypatch.setattr(jmod, "FAMILIES", jmod.families(2))
    monkeypatch.setattr(jbackend, "wait_for_backend", lambda *a, **k: [])
    monkeypatch.setattr(jsyn, "synthetic_vil_events",
                        lambda b, h, w, t, seed=0: np.zeros((b, h, w, t)))
    monkeypatch.setattr(jssim, "ssim", ssim)
    monkeypatch.setattr(sys, "argv", ["int8_mixed.py"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jmod.main()
        fams = port.families(2)
        assert fams == jmod.families(2)
        damage = port.leave_one_in(fams, lambda spec, n: _table_ssim(spec))
        chosen, s = port.greedy_mix(damage, lambda spec, n: _table_ssim(spec))
    line = next(ln for ln in buf.getvalue().splitlines()
                if ln.startswith("INT8_MIXED_SPEC = "))
    want = ast.literal_eval(line.split(" = ", 1)[1])
    assert port.spec_of(chosen) == want
    assert chosen == ["encoder/conv_in", "encoder/mid_block"]
    assert s == pytest.approx(0.997)


def test_space_to_depth_check_and_packed_order(capsys):
    """--check-only asserts the rewrite's equivalence; the packing is
    tests/test_fast_vae.py:24's channel order and the JAX script's, and the
    packed kernels are the JAX script's."""
    from experiments_gpu.perf import space_to_depth as s2d

    s2d.main(["--check-only", "--device", "cpu"])
    assert "equivalence OK" in capsys.readouterr().out
    sys.path.insert(0, str(REPO / "experiments" / "perf"))
    try:
        js2d = importlib.import_module("space_to_depth")
    finally:
        sys.path.remove(str(REPO / "experiments" / "perf"))
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 8, 8)).astype(np.float32)          # NCHW
    packed = s2d.space_to_depth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(packed[:, 3:6], x[:, :, ::2, 1::2])
    want = np.asarray(js2d.space_to_depth(x.transpose(0, 2, 3, 1)))
    np.testing.assert_array_equal(packed.transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(
        s2d.depth_to_space(torch.from_numpy(packed)).numpy(), x)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    for ab, (kp, ph, pw) in s2d.packed_kernels(w).items():
        jkp, jph, jpw = js2d.packed_kernels(w)[ab]
        np.testing.assert_array_equal(kp, np.asarray(jkp))
        assert (ph, pw) == (jph, jpw)


SCRIPTS = {
    "full_res_384": ["--steps", "1", "dataset.img_size=32",
                     "model.block_out_channels=[8,16]",
                     "model.norm_num_groups=4", "dataset.seq_len=2",
                     "dataset.stride=47", "dataset.synthetic_events=6",
                     "dataset.num_workers=0", "lpips.disc_num_layers=1",
                     "lpips.disc_ndf=8"],
    "full_res_serving": ["--narrow", "--batches", "1", "--fast-batches", "1"],
    "remat_train": ["--narrow", "--batches", "1", "--steps", "1"],
    "ckpt_stall": ["--small"],
    "batch_sweep": ["--narrow", "--batches", "1"],
    "fast_vae_probe": ["--narrow", "--batch", "1"],
    "fast_vae_sweep": ["--narrow", "1"],
    "int8_fast_vae": ["--narrow", "--batch", "2"],
    "int8_mixed": ["--narrow", "--fast", "--batch", "1", "--families", "2"],
    "int8_qat": ["--narrow", "--steps", "1", "--qat-steps", "1",
                 "--events", "10"],
    "b1_latency_profile": ["--narrow", "--reps", "1"],
    "space_to_depth": ["--n", "1", "--hw", "8", "--c", "4", "--reps", "1",
                       "--dtype", "float32"],
}
# a line of each script's table
PRINTS = {
    "full_res_384": "steady state: median",
    "full_res_serving": "fast (s2d stem)    B=1   bf16:",
    "remat_train": "remat=on  B=1x4:",
    "ckpt_stall": "SUMMARY stall_sync=",
    "batch_sweep": "largest gate-passing batch:",
    "fast_vae_probe": "fast (s2d stem): first call",
    "fast_vae_sweep": "| 1 | int8_static |",
    "int8_fast_vae": "| int8_static |",
    "int8_mixed": "  mix+",
    "int8_qat": "int8_static(W_qat): int8-vs-fp32 SSIM",
    "b1_latency_profile": "fast: decode",
    "space_to_depth": "s2d verdict:",
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_script_main_on_cpu(name, tmp_path, capsys):
    mod = importlib.import_module(f"experiments_gpu.perf.{name}")
    argv = ["--device", "cpu"] + SCRIPTS[name]
    if name == "full_res_384":
        argv += ["--out", str(tmp_path)]
    if name == "b1_latency_profile":
        argv += ["--trace", str(tmp_path / "trace")]
    mod.main(argv)
    out = capsys.readouterr().out
    assert PRINTS[name] in out, out
    if name == "full_res_384":
        assert list(tmp_path.glob("outputs/vae_sevir384/runs/*/media/*.png"))
    if name == "b1_latency_profile":
        assert (tmp_path / "trace" / "trace.json").exists()


def test_scripts_raise_without_a_gpu():
    from experiments_gpu.perf import batch_sweep

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_sweep.main(["--narrow", "--batches", "1"])


def test_full_res_serving_records_oom_and_raises_the_rest(monkeypatch,
                                                          capsys):
    from experiments_gpu.perf import full_res_serving as frs

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 20.00 GiB")

    monkeypatch.setattr(frs, "build_pipeline", oom)
    res = frs.main(["--device", "cpu", "--narrow", "--batches", "1",
                    "--fast-batches", "1"])
    assert all("out of memory" in r["oom"] for r in res.values())
    assert "DOES NOT FIT" in capsys.readouterr().out

    def broken(*a, **k):
        raise ValueError("not an out-of-memory error")

    monkeypatch.setattr(frs, "build_pipeline", broken)
    with pytest.raises(ValueError, match="not an out-of-memory"):
        frs.main(["--device", "cpu", "--narrow", "--batches", "1",
                  "--fast-batches", "1"])


# -- token_vit's frozen ViTAE from a port ae_recon run

VIT = dict(img_size=32, patch=8, d_token=16, d_latent=32, depth_enc=1,
           depth_dec=1, heads=2)


def _ae_recon_run(tmp_path):
    """A two-step ae_recon command-line run of the port with model.name
    vit_ae at VIT's widths; returns its run directory."""
    from experiments_gpu.common import main
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    cfg = Config.load(str(REPO / "experiments" / "ae_recon" / "config.yaml"))
    cfg.model = dict(name="vit_ae", **VIT)
    config = tmp_path / "ae_recon.yaml"
    cfg.save(str(config))
    script = REPO / "experiments_gpu" / "ae_recon" / "train.py"
    mod_spec = importlib.util.spec_from_file_location("_perf_ae_recon",
                                                      script)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    main(str(script), mod.build_task, argv=[
        "--device", "cpu", "--config", str(config),
        f"experiment_path={tmp_path / 'ae'}", "dataset.batch_size=2",
        "dataset.num_workers=0", "dataset.synthetic_events=6",
        "dataset.img_size=32", "dataset.val_ratio=0.5",
        "trainer.max_epochs=1", "trainer.limit_train_batches=2",
        "trainer.limit_val_batches=1", "trainer.async_checkpoint=false",
        "trainer.save_every_n_steps=0.5", "logging.val_every_n=10.0"])
    (run_dir,) = (tmp_path / "ae" / "outputs" / "ae_recon" / "runs").iterdir()
    return run_dir


def _token_vit_cfg(run_dir, **vit):
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    cfg = Config.load(str(REPO / "experiments" / "token_vit" / "config.yaml"))
    cfg.vit_ae.update(dict(VIT, ckpt_run_dir=str(run_dir), **vit))
    return cfg


def test_token_vit_restores_vit_ae_from_a_run(tmp_path, capsys):
    """token_vit's make_vit loads the newest checkpoint's params of a port
    ae_recon run (its encodings equal the saved ViTAE's, not the random
    init's), prints the JAX script's line, and its task trains a step;
    a missing run, a run without checkpoints and a run of other widths
    raise."""
    from weatherforecastingtoolkit_tpu_torch.models.vit_ae import ViTAE
    from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
        CheckpointManager)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    run_dir = _ae_recon_run(tmp_path)
    tv = importlib.import_module("experiments_gpu.token_vit.train")
    cfg = _token_vit_cfg(run_dir)
    vit = tv.make_vit(cfg, device="cpu")
    assert (f"[token_vit] loaded frozen ViT AE from {run_dir}"
            in capsys.readouterr().out)
    mgr = CheckpointManager(str(run_dir))
    saved = mgr.load(mgr.latest_step())["params"]
    want = ViTAE(**VIT, dropout=0.0, device="cpu", seed=123)
    want.load_state_dict(saved, strict=True)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (3, 1, 32, 32)).astype(np.float32))
    with torch.no_grad():
        got = vit.encode_tokens(x)
        assert torch.equal(got, want.eval().encode_tokens(x))
        fresh = ViTAE(**VIT, dropout=0.0, device="cpu", seed=7)
        assert not torch.allclose(got, fresh.eval().encode_tokens(x))
    assert not any(p.requires_grad for p in vit.parameters())

    cfg.experiment_path = str(tmp_path / "tv")
    cfg.trainer.total_train_steps = 1
    task = tv.build_task(cfg, device="cpu", vit=vit)
    tr = Trainer(cfg, task, device="cpu")
    state = tr.init_state()
    seq = cfg.dataset.input_frames + cfg.dataset.pred_frames
    batch = {"vil": torch.from_numpy(np.random.default_rng(1).random(
        (2, seq, 1, 32, 32)).astype(np.float32))}
    state, aux = tr._train_step(state, batch)
    assert np.isfinite(float(aux["loss"]))
    tr.close()

    with pytest.raises(FileNotFoundError):
        tv.make_vit(_token_vit_cfg(tmp_path / "no_such_run"), device="cpu")
    empty = tmp_path / "empty_run"
    (empty / "checkpoints").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="No checkpoints"):
        tv.make_vit(_token_vit_cfg(empty), device="cpu")
    with pytest.raises(ValueError, match="template"):
        tv.make_vit(_token_vit_cfg(run_dir, d_token=24), device="cpu")
