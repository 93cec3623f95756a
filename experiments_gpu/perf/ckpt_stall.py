"""The training stall a checkpoint save costs on the card: sync against async
(counterpart of experiments/perf/ckpt_stall.py).

The state is the bench GAN's (PosAwareAE 80.8M parameters + the PatchGAN
discriminator, both with Adam moments: about 1 GB in fp32), saved through
the port's ``training/checkpoint.py::CheckpointManager``. Prints:

  * sync save stall: ``CheckpointManager(async_save=False).save()`` wall time
    (the copy to the host and the write);
  * async save stall: ``save()``'s return time (the copy to the host only);
  * write drain time, and the steps overlapped: how many GAN train steps
    complete while the async write drains (the work a sync save would have
    blocked).

    python experiments_gpu/perf/ckpt_stall.py [--small]

``--small`` is the CPU check: a narrow model on the same code path. The
checkpoints go to a temporary directory, removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from experiments_gpu.perf.bench_helpers import (  # noqa: E402
    describe_device, sync, timed)
from experiments_gpu.perf.remat_train import AE, DISC, gan_state, gan_task  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (  # noqa: E402
    CheckpointManager)
from weatherforecastingtoolkit_tpu_torch.training.optim import adamw  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

SMALL_AE = dict(enc_channels=(8, 16), dec_channels=(16, 8, 8), num_blocks=1,
                latent_hw=8, latent_channels=4, latent_dim=64)
DRAIN_LIMIT_S = 120


def state_bytes(state) -> int:
    """Bytes of the state's tensors: parameters, moments, discriminator."""
    seen, total = set(), 0

    def walk(obj):
        nonlocal total
        if isinstance(obj, torch.nn.Module):
            obj = list(obj.state_dict().values())
        if isinstance(obj, torch.Tensor):
            if id(obj) not in seen:
                seen.add(id(obj))
                total += obj.numel() * obj.element_size()
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)

    for part in (state.params, state.opt_state, state.extra):
        walk(part)
    return total


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true",
                   help="CPU smoke: tiny model, same code path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    print("devices:", describe_device(device), flush=True)
    hw, b, t = (32, 2, 2) if args.small else (128, 4, 4)
    task = gan_task(False, SMALL_AE if args.small else AE,
                    (1, 8, 1) if args.small else DISC, mixed=False)
    tx = adamw(1e-4, weight_decay=1e-4, grad_clip=1.0)
    state = gan_state(task, tx, device)
    print(f"state: {state_bytes(state) / 1e9:.2f} GB", flush=True)
    batch = {"vil": torch.from_numpy(np.random.default_rng(0).random(
        (b, t, 1, hw, hw), np.float32)).to(device)}

    def step():
        nonlocal state
        state, aux = task.custom_train_step(state, batch, tx)
        return float(aux["loss"])

    t_step, first_s, _ = timed(step, device, n_rep=5)
    print(f"first step {first_s:.1f}s; train step: {t_step * 1000:.1f} ms",
          flush=True)

    tmp = tempfile.mkdtemp(prefix="ckpt_stall_")
    try:
        # -- sync save
        sync_mgr = CheckpointManager(os.path.join(tmp, "sync"),
                                     async_save=False)
        sync(device)
        t0 = time.perf_counter()
        sync_mgr.save(1, state)
        t_sync = time.perf_counter() - t0
        print(f"sync save stall: {t_sync:.2f}s "
              f"({t_sync / t_step:.1f} train steps blocked)", flush=True)
        sync_mgr.close()

        # -- async save
        async_mgr = CheckpointManager(os.path.join(tmp, "async"),
                                      async_save=True)
        sync(device)
        t0 = time.perf_counter()
        async_mgr.save(1, state)
        t_async = time.perf_counter() - t0
        print(f"async save stall: {t_async:.2f}s (snapshot only)", flush=True)
        # how many steps run while the write drains?
        overlapped = 0
        t0 = time.perf_counter()
        while True:
            step()
            overlapped += 1
            if not async_mgr.is_saving_in_progress():
                break
            if time.perf_counter() - t0 > DRAIN_LIMIT_S:
                break
        t_drain = time.perf_counter() - t0
        print(f"write drained in {t_drain:.2f}s; {overlapped} train steps "
              f"overlapped the write", flush=True)
        async_mgr.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"SUMMARY stall_sync={t_sync:.2f}s stall_async={t_async:.2f}s "
          f"step={t_step * 1000:.0f}ms overlapped={overlapped}", flush=True)
    return dict(sync_s=t_sync, async_s=t_async, drain_s=t_drain,
                overlapped=overlapped, step_ms=t_step * 1e3)


if __name__ == "__main__":
    main()
