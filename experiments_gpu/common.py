"""Shared experiment scaffolding of the PyTorch/CUDA port: CLI, config, data,
trainer wiring (counterpart of experiments/common.py).

Replicates the reference experiment skeleton (reference
experiments/ae_v2/train.py:264-347): YAML config + validated dotlist
overrides, --resume auto-checkpoint discovery, dataloader smoke prints,
derived total-step math, and the final "done" success marker the retry
supervisor keys on (reference run.sh:17-45 — here `--retry` runs the
supervision in-process).

Every experiment module under experiments_gpu/<name>/ defines
`build_task(cfg, dm, device) -> Task` (and optionally
`init_state(trainer, task)`) and calls `main(__file__, build_task)`. The
config is experiments/<name>/config.yaml, the JAX experiment's own, unless
--config names another. Runs go to `cuda` unless `--device cpu` is given;
without a GPU and without `--device cpu` the CLI raises before it reads any
data.

    python experiments_gpu/earthformer/train.py dataset.sevir_dir=/data/sevirlr
    python experiments_gpu/latent_dlinear/train.py --device cpu \\
        dataset.img_size=32 ae_kl.block_out_channels=[8,16]

A SEVIR tree with the packed cache built (`dataset.use_cache=true`) is read
with numpy alone; without `dataset.sevir_dir`, a synthetic tree (catalog and
packed caches, `data/synthetic.py::make_synthetic_sevir_cache`) is written
under `experiment_path` and read from its caches, also without h5py.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Callable, Optional

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from weatherforecastingtoolkit_tpu_torch.data.datamodule import (  # noqa: E402
    SEVIRDataModule)
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_sevir_cache)
from weatherforecastingtoolkit_tpu_torch.training.trainer import (  # noqa: E402
    Trainer, derive_steps, run_with_retry)
from weatherforecastingtoolkit_tpu_torch.utils.config import Config  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import (  # noqa: E402
    resolve_device)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--resume", type=lambda s: s.lower() in ("1", "true", "yes"),
                   default=False)
    p.add_argument("--retry", action="store_true",
                   help="supervise: rerun with resume until 'done'")
    p.add_argument("--config", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args, unknown = p.parse_known_args(argv)
    return args, unknown


def load_config(exp_file: str, args, dotlist) -> Config:
    """--config, else experiments/<name>/config.yaml for the script
    experiments_gpu/<name>/train.py; the dotlist is validated against it."""
    name = os.path.basename(os.path.dirname(os.path.abspath(exp_file)))
    config_path = args.config or os.path.join(REPO, "experiments", name,
                                              "config.yaml")
    cfg = Config.load(config_path)
    return cfg.merged_dotlist(list(dotlist))  # validates keys (check_yaml)


def build_datamodule(cfg: Config) -> SEVIRDataModule:
    """The config's SEVIRDataModule, set up. Without a SEVIR tree at
    ``dataset.sevir_dir``, a synthetic tree (catalog and packed caches, no
    HDF5) is written under ``experiment_path`` and read from its caches."""
    ds = cfg.dataset
    sevir_dir = ds.get("sevir_dir")
    synthetic = not sevir_dir or not os.path.exists(str(sevir_dir))
    if synthetic:
        # hermetic fallback: a synthetic SEVIR tree (tests/CI/demo)
        sevir_dir = os.path.join(cfg.get("experiment_path", "."),
                                 "synthetic_sevir")
    split = ds.get("train_test_split_date", (2019, 6, 1))
    dm = SEVIRDataModule(
        dataset_name=ds.get("name", "sevirlr"), sevir_dir=str(sevir_dir),
        seq_len=ds.seq_len, stride=ds.stride, layout="NTCHW",
        batch_size=ds.batch_size, num_workers=ds.get("num_workers", 4),
        seed=cfg.get("seed", 0), val_ratio=ds.get("val_ratio", 0.1),
        aug_mode=str(ds.get("aug_mode", "0")),
        use_cache=synthetic or bool(ds.get("use_cache", False)),
        train_test_split_date=tuple(split) if split is not None else None,
    )
    if synthetic and not os.path.exists(os.path.join(sevir_dir, "CATALOG.csv")):
        print(f"[data] no SEVIR dataset; generating synthetic at {sevir_dir}")
        make_synthetic_sevir_cache(
            sevir_dir, dm.split_dates(),
            num_events=ds.get("synthetic_events", 16),
            height=ds.get("img_size", 128), width=ds.get("img_size", 128),
            raw_seq_len=ds.get("raw_seq_len", 25))
    dm.prepare_data()
    dm.setup()
    return dm


def lr_range_sweep(cfg: Config, task, train_loader, device: torch.device,
                   output_dir: str):
    """Pre-fit LR range test (reference pipeline/helpers.py:34-61 saves
    lr_range_test.png) on a fresh copy of the task's parameters. The sweep
    steps with the optimizer family the experiment trains with (the port's
    AdamW with the config's betas and decay, its learning rate set before
    each step) so the explosion point transfers to the real run."""
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import (
        device_prefetch)
    from weatherforecastingtoolkit_tpu_torch.training.optim import (
        AdamW, lr_range_test)

    lrt = cfg.lr_range_test
    op = cfg.get("optim", {})
    seed = int(cfg.get("seed", 0))
    model = task.init_params(seed, device)
    params = list(model.parameters())
    lr_now = {"lr": float(lrt.get("start_lr", 1e-7))}
    tx = AdamW(lambda count: lr_now["lr"],
               weight_decay=float(op.get("weight_decay", 0.01)),
               beta1=float(op.get("beta1", 0.9)),
               beta2=float(op.get("beta2", 0.999)))
    opt_state = tx.init(params)
    rng = torch.Generator(device=device).manual_seed(1)
    it = iter(device_prefetch(train_loader, device=device))

    def loss_at_lr(lr):
        nonlocal it
        try:
            batch = next(it)
        except StopIteration:
            it = iter(device_prefetch(train_loader, device=device))
            batch = next(it)
        for p in params:
            p.grad = None
        loss, _ = task.loss_fn(model, batch, rng, 0)
        loss.backward()
        lr_now["lr"] = float(lr)
        tx.update(params, [p.grad if p.grad is not None
                           else torch.zeros_like(p) for p in params],
                  opt_state)
        return float(loss.detach())

    return lr_range_test(
        loss_at_lr, start_lr=float(lrt.get("start_lr", 1e-7)),
        end_lr=float(lrt.get("max_lr", 1.0)),
        num_iter=int(lrt.get("num_iter", 100)), output_dir=output_dir)


def main(exp_file: str, build_task: Callable,
         init_state_fn: Optional[Callable] = None, argv=None) -> None:
    args, dotlist = parse_args(argv)
    device = resolve_device(args.device)

    def run_once(resume: bool):
        cfg = load_config(exp_file, args, dotlist)
        dm = build_datamodule(cfg)
        train_loader = dm.train_loader()
        val_loader = dm.val_loader()
        test_loader = dm.test_loader()
        # dataloader smoke: batch counts + one batch's shape per split
        # (reference ae_v2/train.py:300-304 does exactly this before fit)
        for name, loader in (("train", train_loader), ("val", val_loader),
                             ("test", test_loader)):
            shape = None
            if len(loader):
                first = next(iter(loader))
                shape = {k: tuple(v.shape) for k, v in first.items()}
            print(f"[data] {name}: {len(loader)} batches, first {shape}")
        cfg = derive_steps(cfg, len(train_loader), len(val_loader),
                           len(test_loader))
        # fractional disc_start -> step count (reference ae_s2/train.py:282)
        if "lpips" in cfg and "disc_start" in cfg.lpips:
            if cfg.lpips.disc_start <= 1.0:
                cfg.lpips.disc_start = int(cfg.lpips.disc_start *
                                           cfg.trainer.total_train_steps)

        task = build_task(cfg, dm, device=device)
        if cfg.trainer.get("mixed_precision", False) and \
                task.custom_train_step is None:
            # generic bf16-compute wrapper for plain-loss tasks; GAN-style
            # tasks (custom_train_step) handle the flag where they are made
            # (make_vae_gan_task(mixed_precision=...))
            from weatherforecastingtoolkit_tpu_torch.ops.amp import mixed_loss
            task.loss_fn = mixed_loss(task.loss_fn)
        trainer = Trainer(cfg, task, resume=resume, device=device)
        lrt = cfg.get("lr_range_test", None)
        if lrt is not None and lrt.get("enabled", False):
            lrs, _ = lr_range_sweep(cfg, task, train_loader, device,
                                    trainer.run_dir)
            print(f"[lr_range_test] swept {len(lrs)} LRs, plot saved to "
                  f"{trainer.run_dir}/lr_range_test.png; rule of thumb: "
                  f"~1/10 of the explosion point (last lr "
                  f"{lrs[-1]:.2e})")
        # per-run code artifact (reference uploads train.py to W&B per run,
        # ae_v2/train.py:325-327) — a copy in the run dir serves the same
        # reproducibility purpose without the service dependency
        try:
            shutil.copy2(exp_file, os.path.join(trainer.run_dir, "train.py"))
        except OSError:
            pass
        state = (init_state_fn(trainer, task) if init_state_fn
                 else trainer.init_state())
        state = trainer.fit(train_loader, val_loader, state=state)
        if cfg.trainer.get("run_test", False):
            trainer.test(state, test_loader)
        trainer.close()

    if args.retry:
        attempts = {"n": 0}

        def attempt():
            # first attempt honors --resume; crash-retries always resume
            resume = args.resume if attempts["n"] == 0 else True
            attempts["n"] += 1
            run_once(resume)

        run_with_retry(attempt)
    else:
        run_once(args.resume)
        print("done")
