"""Full-resolution 384^2 VAE-GAN on the card: memory fit, step time and a
reconstruction panel (counterpart of experiments/perf/full_res_384.py).

The reference's main VAE geometry (384^2 -> 4x48x48) trains on one card
with remat: ``experiments/vae_sevir384/config.yaml`` read verbatim (B=1 x
25 frames, remat on, bf16 mixed precision, the feature-matching term) on a
synthetic full-resolution SEVIR tree, through the port's VAE-GAN task and
``Trainer``. Its C=64 and C=128 GroupNorms at 384^2 take the GroupNorm
kernel's two-pass path; the script counts those launches apart. Prints:

  * the card's memory in use after init and the peak at steady state
    (``training/profiling.py::device_memory_stats``,
    ``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``);
  * the median step time (CUDA events) and frames/s at the config batch;
  * GroupNorm kernel launches a step, and how many took the two-pass path;
  * a reconstruction panel PNG in the run directory.

    python experiments_gpu/perf/full_res_384.py [--steps 200] [--batch 1]
    python experiments_gpu/perf/full_res_384.py --device cpu --steps 2 \\
        dataset.img_size=32 model.block_out_channels=[8,16] \\
        model.norm_num_groups=4 dataset.seq_len=2 dataset.raw_seq_len=4

The JAX script's backend retry and persistent compile cache are TPU
services with no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    describe_device, sync, timed)


def gb(x):
    return x / (1024 ** 3)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--out", default="outputs_root/vae_sevir384_perf")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("overrides", nargs="*",
                   help="extra key=val config overrides (CPU trials)")
    args = p.parse_args(argv)

    from experiments_gpu.ae_gan.train import build_task
    from experiments_gpu.common import build_datamodule, load_config
    from weatherforecastingtoolkit_tpu_torch.data.prefetch import to_device
    from weatherforecastingtoolkit_tpu_torch.ops.cuda import groupnorm
    from weatherforecastingtoolkit_tpu_torch.training.logging import (
        RunLogger)
    from weatherforecastingtoolkit_tpu_torch.training.profiling import (
        device_memory_stats)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import (
        Trainer, derive_steps)
    from weatherforecastingtoolkit_tpu_torch.utils.device import (
        resolve_device)

    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    print(f"device: {describe_device(device)}", flush=True)
    cfg_path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "experiments", "vae_sevir384",
        "config.yaml")

    class _A:
        config = cfg_path

    cfg = load_config(cfg_path, _A, [
        f"dataset.batch_size={args.batch}",
        f"experiment_path={args.out}",
        "trainer.save_every_n_steps=10.0",  # no checkpoint stalls in timing
        "logging.val_every_n=10.0",
        "logging.log_every_n_steps=25",
    ] + list(args.overrides))
    dm = build_datamodule(cfg)
    train_loader = dm.train_loader()
    cfg = derive_steps(cfg, len(train_loader), 1, 1)
    cfg.trainer.total_train_steps = args.steps
    if cfg.lpips.disc_start <= 1.0:
        # a fractional disc_start is a fraction of the steps (the command
        # line's rule), computed against --steps
        cfg.lpips.disc_start = int(cfg.lpips.disc_start * args.steps)

    task = build_task(cfg, dm, device=device)
    trainer = Trainer(cfg, task, device=device)
    state = trainer.init_state()
    if cuda:
        m0 = device_memory_stats(device)
        free, total = torch.cuda.mem_get_info(device)
        print(f"memory after init: {gb(m0['allocated_bytes.all.current']):.2f}"
              f" GiB in use, {gb(free):.2f} GiB free of {gb(total):.2f} GiB",
              flush=True)

    def batches():
        while True:
            for b in train_loader:
                yield to_device(b, device)

    it = batches()
    first = next(it)
    bt = tuple(first["vil"].shape[:2])
    hw = first["vil"].shape[-1]
    print(f"batch: {bt[0]} x {bt[1]} frames of {hw}^2 "
          f"({bt[0] * bt[1]} frames/step)", flush=True)

    def step():
        nonlocal state, aux, b
        b = next(it)
        state, aux = trainer._train_step(state, b)
        return aux

    b = first
    t0 = time.perf_counter()
    state, aux = trainer._train_step(state, first)
    sync(device)
    first_s = time.perf_counter() - t0
    print(f"first step (kernel builds, cuDNN's algorithm search): "
          f"{first_s:.1f}s", flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gn0, two0 = groupnorm.launches, groupnorm.two_pass_launches
    med, _, aux = timed(step, device, n_rep=args.steps)
    # the timed steps' and the warm-up's launches (timed runs one first)
    gn = (groupnorm.launches - gn0) / (args.steps + 1)
    two = (groupnorm.two_pass_launches - two0) / (args.steps + 1)
    frames = bt[0] * bt[1]
    print(f"steady state: median {med * 1000:.1f} ms/step -> "
          f"{frames / med:.2f} frames/s at {hw}^2 (train, GAN step)",
          flush=True)
    print(f"GroupNorm kernel launches a step: {gn:g} ({two:g} on the "
          f"two-pass path)", flush=True)
    if cuda:
        print(f"memory peak: {gb(torch.cuda.max_memory_allocated(device)):.2f}"
              f" GiB", flush=True)
    for k in ("rec_loss", "fm_loss", "disc_loss", "kl_loss"):
        if k in aux:
            print(f"final {k}: {float(aux[k]):.5f}", flush=True)

    # recon panel: the task's eval view (encode -> decode of the last batch)
    recon, target = task.eval_fn(state.params, b, state.rng)
    logger = RunLogger(trainer.run_dir)
    logger.log_images(np.clip(recon.float().cpu().numpy(), 0, 1),
                      target.float().cpu().numpy(), "recon384", args.steps)
    print(f"panel written under {trainer.run_dir}", flush=True)
    trainer.close()
    return {"ms": med * 1e3, "gn_launches": gn, "two_pass_launches": two,
            "run_dir": trainer.run_dir}


if __name__ == "__main__":
    main()
