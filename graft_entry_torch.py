"""Entry points of the PyTorch/CUDA port: the single-card program and the
multi-process dryruns (counterpart of __graft_entry__.py); imports the
port only.

entry() -> (pipeline, (fc_params, frames)): bench.py's fp32 Path-B program
(the reference-shape VAE (64, 128, 256, 512, 512) with a 64x8x8 latent and
DLinear(13 -> 12, kernel 25), random weights from seed 0; 64 sequences of
13 frames of 128^2) on the card.

dryrun_multichip(n, device=None): n processes in one group (on the card by
default, one GPU a process over NCCL; gloo with device="cpu") run a (dp, mp)
train step of a small PosAwareAE with its bottleneck dense pair
tensor-parallel (to_latent column-parallel, from_latent row-parallel), the
GAN two-optimizer step on 'dp', an FSDP step and the member-parallel
ensemble with one member a rank.

dryrun_multihost(2): runs tests/test_torch_port_multihost.py (two
processes, each fed its own event shard, against one process).

    python graft_entry_torch.py [N] [--device cpu]
        # dryrun_multichip(N) (default 2; on the card unless --device cpu)
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

T_IN, T_OUT, HW, BATCH = 13, 12, 128, 64   # bench.py's shapes
REFERENCE_VAE = dict(in_channels=1, out_channels=1,
                     block_out_channels=(64, 128, 256, 512, 512),
                     layers_per_block=1, latent_channels=64,
                     norm_num_groups=32)


def entry():
    import torch

    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)

    vae = AutoencoderKL(**REFERENCE_VAE, seed=0)
    fc = DLinear(T_IN, T_OUT, kernel_size=25)
    pipeline = make_forecast_pipeline(
        encode_apply=lambda f: vae.encode(f).mode(),
        decode_apply=vae.decode, forecaster_apply=lambda m, z: m(z),
        input_frames=T_IN, pred_frames=T_OUT)
    frames = torch.zeros((BATCH, T_IN, 1, HW, HW), device="cuda")
    return pipeline, (fc, frames)


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run ``_dryrun`` in ``n_devices`` processes: on the card (the default;
    one GPU a process, since NCCL refuses two ranks on one GPU; raises
    without enough GPUs) or, with ``device="cpu"``, over gloo on the CPU.
    Raises when a process fails or outlives 600 s."""
    import torch

    from weatherforecastingtoolkit_tpu_torch.utils.device import (
        resolve_device)

    device = resolve_device(device).type
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) on the card needs "
                         f"{n_devices} GPUs, found "
                         f"{torch.cuda.device_count()}")
    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="wx_dryrun_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(r),
             str(n_devices), str(port), device, tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO) for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                p.kill()
    for p, log in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun_multichip({n_devices}) failed:\n"
                               f"{log[-4000:]}")
    print(logs[0].strip())


def _dryrun(rank: int, n: int, port: int, device: str, tmp: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    from weatherforecastingtoolkit_tpu_torch.models.conv_ae import PosAwareAE
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (
        NLayerDiscriminator)
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        batch_generator, make_ensemble_pipeline)
    from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import (
        shard_fraction)
    from weatherforecastingtoolkit_tpu_torch.parallel.mesh import (
        init_distributed, local, make_mesh, shard_batch)
    from weatherforecastingtoolkit_tpu_torch.parallel.serving import (
        make_member_parallel_ensemble)
    from weatherforecastingtoolkit_tpu_torch.training.gan import (
        make_vae_gan_task)
    from weatherforecastingtoolkit_tpu_torch.training.optim import adam
    from weatherforecastingtoolkit_tpu_torch.training.tasks import (
        reconstruction_task)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer
    from weatherforecastingtoolkit_tpu_torch.utils.config import Config

    init_distributed(f"localhost:{port}", n, rank, device=device)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    mp = 2 if n % 2 == 0 and n > 1 else 1
    mesh = make_mesh(("dp", "mp"), shape=(n // mp, mp), device_type=dev.type)
    ae = dict(enc_channels=(16, 32), dec_channels=(32, 16, 8), num_blocks=1,
              latent_hw=8, latent_channels=8, latent_dim=64)

    def cfg(name, fsdp=False):
        return Config({
            "experiment_name": name, "experiment_path": tmp, "seed": 0,
            "optim": {"lr": 1e-3, "schedule": "constant"},
            "trainer": {"max_epochs": 1, "total_train_steps": 1,
                        "save_every_n_steps": 10.0, "fsdp": fsdp},
            "logging": {"log_every_n_steps": 1, "val_every_n": 10.0}})

    def say(msg):
        if rank == 0:
            print(f"dryrun_multichip({n}): {msg}", flush=True)

    def changed(before, params):
        return any(not torch.equal(b, local(p).detach())
                   for b, p in zip(before, params))

    # -- (dp, mp): batch over 'dp', the bottleneck dense pair over 'mp'
    model = PosAwareAE(**ae, device=dev)
    trainer = Trainer(cfg("dryrun"), reconstruction_task(model, loss="l1"),
                      mesh=mesh, device=dev)
    state = trainer.init_state()
    parallelize_module(state.params, mesh["mp"],
                       {"to_latent": ColwiseParallel(),
                        "from_latent": RowwiseParallel()})
    state.opt_state = trainer.tx.init(list(state.params.parameters()))
    dp_size = n // mp
    batch = {"vil": shard_batch(torch.from_numpy(
        np.random.default_rng(0).random((dp_size * 2, 2, 1, 32, 32),
                                        np.float32)), mesh).to(dev)}
    params = list(state.params.parameters())
    before = [local(p).detach().clone() for p in params]
    state, aux = trainer._train_step(state, batch)
    loss = float(aux["loss"])
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert changed(before, params), "the step changed no parameter"
    trainer.close()
    say(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} train step OK, "
        f"loss={loss:.4f}")

    # -- the two-optimizer adversarial step on 'dp'
    dp_mesh = make_mesh(("dp",), device_type=dev.type)
    gan = make_vae_gan_task(
        name="dryrun_gan",
        generator_apply=lambda g, f, r: (g(f)[0], None),
        gen_init=lambda s, d: PosAwareAE(**ae, device=d, seed=s),
        disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: NLayerDiscriminator(1, 8, 1, device=d, seed=s),
        disc_tx=adam(1e-4, b1=0.5, b2=0.9), last_layer_path="dec_out.weight",
        disc_start=0)
    gtr = Trainer(cfg("dryrun_gan"), gan, mesh=dp_mesh, device=dev)
    gstate = gtr.init_state()
    dbatch = {"vil": shard_batch(torch.from_numpy(
        np.random.default_rng(1).random((n * 2, 2, 1, 32, 32), np.float32)),
        dp_mesh).to(dev)}
    disc = list(gstate.extra["disc_params"].parameters())
    d_before = [p.detach().clone() for p in disc]
    gstate, gaux = gtr._train_step(gstate, dbatch)
    for k in ("loss", "g_loss", "disc_loss", "d_weight"):
        assert np.isfinite(float(gaux[k])), f"non-finite {k}"
    assert changed(d_before, disc), "discriminator did not update"
    gtr.close()
    say(f"GAN two-optimizer step OK, loss={float(gaux['loss']):.4f} "
        f"d_loss={float(gaux['disc_loss']):.4f}")

    # -- fully sharded on 'dp'
    ftr = Trainer(cfg("dryrun_fsdp", fsdp=True),
                  reconstruction_task(PosAwareAE(**ae, device="cpu")),
                  mesh=dp_mesh, device=dev)
    fstate = ftr.init_state()
    frac = shard_fraction(fstate.params)
    assert (frac < 0.9) if n > 1 else frac == 1.0, \
        f"FSDP shard fraction {frac:.2f} over {n} ranks"
    fparams = list(fstate.params.parameters())
    f_before = [p.detach().clone() for p in fparams]
    fstate, faux = ftr._train_step(fstate, dbatch)
    assert np.isfinite(float(faux["loss"]))
    assert changed(f_before, fparams), "the FSDP step changed nothing"
    ftr.close()
    say(f"FSDP step OK (rank 0 holds {frac:.0%} of the parameter bytes)")

    # -- the member-parallel ensemble: one member a rank
    t_in, t_out, hw = 4, 3, 8
    fc = DLinear(t_in, t_out, kernel_size=3, device=dev)
    kw = dict(encode_apply=lambda f: f.reshape(f.shape[0], -1),
              decode_apply=lambda z: z.reshape(z.shape[0], 1, hw, hw),
              forecaster_apply=lambda m, z: m(z), input_frames=t_in,
              pred_frames=t_out, device=dev)
    ens = make_member_parallel_ensemble(mesh=dp_mesh, n_members=n, **kw)
    x = torch.zeros((2, t_in, 1, hw, hw), device=dev)
    out = ens(fc, x, 0, 0.1)
    assert tuple(out.shape) == (2, n, t_out, 1, hw, hw)
    mine = make_ensemble_pipeline(n_members=1, **kw)(
        fc, x, batch_generator(0, rank, dev), 0.1)
    assert ens.members_per_rank == 1 and torch.equal(
        out[:, rank:rank + 1], mine), "ensemble member axis not distributed"
    say(f"member-parallel ensemble OK ({n} members, one a rank)")
    dist.destroy_process_group()


def dryrun_multihost(n_processes: int = 2) -> None:
    """Two real processes, each auto-sharding the SEVIR loader, join one DP
    and one FSDP step; the results must equal one process on the
    concatenated data (tests/test_torch_port_multihost.py)."""
    assert n_processes == 2, "the canonical dryrun is 2 processes"
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests", "test_torch_port_multihost.py")],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    tail = (rc.stdout + rc.stderr)[-2000:]
    assert rc.returncode == 0, f"multi-host dryrun failed:\n{tail}"
    print(f"dryrun_multihost({n_processes}): 2-process DP and FSDP steps "
          "match one process (gloo, auto-sharded loaders)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        import torch

        torch.set_num_threads(2)
        rank, n, port = (int(a) for a in sys.argv[2:5])
        _dryrun(rank, n, port, sys.argv[5], sys.argv[6])
    else:
        import argparse

        ap = argparse.ArgumentParser(description="dryrun_multichip(N)")
        ap.add_argument("n", nargs="?", type=int, default=2)
        ap.add_argument("--device", default=None,
                        help="cpu for gloo on the CPU (default: the card)")
        args = ap.parse_args()
        dryrun_multichip(args.n, device=args.device)
