"""Worker process of the port's multi-process tests on the CPU (gloo).

    python tests/torch_port_dist_worker.py CASE RANK WORLD PORT DIR

CASE "parallel" (tests/test_torch_port_parallel.py) runs, in one process
group, the data-parallel, fully-sharded (also with remat and bf16) and
tensor-parallel steps, the trainer on an auto-sharded SEVIR tree with the
sharded resume, a sharded resume across an ema_decay toggle, a resume
that one rank cannot read, dp serving and the member-parallel ensemble; CASE "multihost"
(tests/test_torch_port_multihost.py) runs a DP and an FSDP step, each rank
fed its own event shard by SEVIRDataModule. Inputs come from DIR (written
by the test), and rank r writes its results to DIR/CASE_r.pt; rank 0 also
writes the one-process references it computes after the group's work.
Imports no JAX.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from weatherforecastingtoolkit_tpu_torch.utils.config import Config  # noqa: E402

CPU = torch.device("cpu")
SMALL_AE = dict(enc_channels=(8, 16), dec_channels=(16, 8, 8), num_blocks=1,
                latent_hw=8, latent_channels=4, latent_dim=32)
# wide enough that the FSDP rule shards leaves (>= 4096 elements)
GAN_VAE = dict(in_channels=1, out_channels=1, block_out_channels=(32, 64),
               layers_per_block=1, latent_channels=4, norm_num_groups=8)
GAN_STEPS = 2


def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_group(case, root, world=2, timeout=300):
    """Run ``case`` on ``world`` ranks (a free port; each process killed
    after ``timeout`` s); returns ({rank: its results}, [rank logs])."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         str(port), root],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"{case} worker failed:\n{log[-4000:]}"
    return {r: torch.load(os.path.join(root, f"{case}_{r}.pt"),
                          weights_only=False) for r in range(world)}, logs


def config(root, name, fsdp=False, steps=2, **optim):
    return Config({
        "experiment_name": name, "experiment_path": root, "seed": 0,
        "optim": {"lr": 1e-3, "schedule": "constant", **optim},
        "trainer": {"max_epochs": 1, "total_train_steps": steps,
                    "save_every_n_steps": 1.0, "fsdp": fsdp,
                    "async_checkpoint": False},
        "logging": {"log_every_n_steps": 1, "val_every_n": 10.0},
    })


def np_tree(tensors):
    """{name: tensor} -> {name: numpy}; a shard gathered to the full
    tensor, a DTensor to its full tensor (both collective)."""
    from torch.distributed.tensor import DTensor

    from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import unsharded

    out = {}
    for k, t in tensors.items():
        with torch.no_grad():
            t = unsharded(t)
        if isinstance(t, DTensor):
            t = t.full_tensor()
        out[k] = t.detach().numpy().copy()
    return out


def gan_task(remat=False, mixed_precision=False):
    from weatherforecastingtoolkit_tpu_torch.models.losses.gan import (
        NLayerDiscriminator)
    from weatherforecastingtoolkit_tpu_torch.models.vae.autoencoder_kl import (
        AutoencoderKL)
    from weatherforecastingtoolkit_tpu_torch.training.gan import (
        make_vae_gan_task)
    from weatherforecastingtoolkit_tpu_torch.training.optim import adam

    def generator_apply(vae, frames, rng):
        recon, post = vae(frames, sample_posterior=True, generator=rng,
                          return_posterior=True)
        return recon, post.kl()

    return make_vae_gan_task(
        name="gan", generator_apply=generator_apply,
        gen_init=lambda s, d: AutoencoderKL(**GAN_VAE, remat=remat, device=d,
                                            seed=s),
        disc_apply=lambda d, f: d(f),
        disc_init=lambda s, d: NLayerDiscriminator(1, 16, 2, device=d,
                                                   seed=s),
        disc_tx=adam(1e-4, b1=0.5, b2=0.9),
        last_layer_path="decoder.conv_out.weight", kl_weight=1e-6,
        disc_weight=0.5, disc_start=0, mixed_precision=mixed_precision)


def gan_run(root, name, batch, mesh=None, fsdp=False, **task_kw):
    """GAN_STEPS Trainer steps of ``gan_task(**task_kw)``: (aux per step,
    params before and after, discriminator before and after, shard
    fraction of the params)."""
    from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import (
        shard_fraction)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    cfg = config(root, name, fsdp=fsdp, steps=GAN_STEPS, lr=1e-4,
                 weight_decay=1e-4, grad_clip=1.0)
    tr = Trainer(cfg, gan_task(**task_kw), mesh=mesh, device=CPU)
    state = tr.init_state()
    disc = state.extra["disc_params"]
    out = {"p0": np_tree(dict(state.params.named_parameters())),
           "d0": np_tree(dict(disc.named_parameters())),
           "fraction": shard_fraction(state.params), "aux": []}
    for _ in range(GAN_STEPS):
        state, aux = tr._train_step(state, batch)
        out["aux"].append({k: float(v) for k, v in aux.items()})
    out["p1"] = np_tree(dict(state.params.named_parameters()))
    out["d1"] = np_tree(dict(disc.named_parameters()))
    tr.close()
    return out


def recon_run(root, name, model, mesh=None):
    """A Trainer of reconstruction_task(model) and its initial state."""
    from weatherforecastingtoolkit_tpu_torch.training.tasks import (
        reconstruction_task)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    tr = Trainer(config(root, name), reconstruction_task(model), mesh=mesh,
                 device=CPU)
    state = tr.init_state()
    return tr, state


def recon_step(tr, state, batch):
    """One step: loss, grad_norm, the gradients it applied (averaged over
    'dp'), the params before and after."""
    before = np_tree(dict(state.params.named_parameters()))
    state, aux = tr._train_step(state, batch)
    params = dict(state.params.named_parameters())
    out = {"loss": float(aux["loss"]), "grad_norm": float(aux["grad_norm"]),
           "grads": np_tree({k: p.grad for k, p in params.items()}),
           "before": before, "params": np_tree(params)}
    tr.close()
    return out


def ema_toggle(root, mesh, name, before, after, batch):
    """Two FSDP steps with ``trainer.ema_decay=before``, each saved; then a
    resume with ``ema_decay=after``: the step it resumed, whether its
    params and moments equal the saved ones, and per EMA leaf whether it is
    a shard of its parameter's shape holding the resumed value (seeded
    from the params) or the saved EMA's."""
    from weatherforecastingtoolkit_tpu_torch.models.conv_ae import PosAwareAE
    from weatherforecastingtoolkit_tpu_torch.training.tasks import (
        reconstruction_task)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    def trainer(ema, resume=False):
        cfg = config(root, name, fsdp=True)
        if ema is not None:
            cfg.trainer.ema_decay = ema
        model = PosAwareAE(**dict(SMALL_AE, latent_dim=512), device=CPU)
        return Trainer(cfg, reconstruction_task(model), mesh=mesh,
                       device=CPU, resume=resume)

    tr = trainer(before)
    st = tr.init_state()
    for _ in range(2):
        st, _ = tr._train_step(st, batch)
        tr.ckpt.save(int(st.step), st)
    tr.close()
    tr = trainer(after, resume=True)
    s2 = tr.init_state()
    params = dict(s2.params.named_parameters())
    out = {"resumed": tr._resume_state is not None, "step": int(s2.step),
           "equal": all(torch.equal(a, b) for a, b in zip(
               st.params.parameters(), s2.params.parameters())),
           "moments_equal": all(torch.equal(a, b) for a, b in zip(
               st.opt_state["mu"] + st.opt_state["nu"],
               s2.opt_state["mu"] + s2.opt_state["nu"])),
           "extra": None if s2.extra is None else sorted(s2.extra)}
    if s2.extra is not None:
        saved = st.extra["ema_params"] if st.extra is not None else None
        out["ema"] = {
            k: (getattr(t, "_fsdp", None) == getattr(params[k], "_fsdp", None),
                torch.equal(t, params[k] if saved is None else saved[k]))
            for k, t in s2.extra["ema_params"].items()}
        out["ema_sharded"] = sum(hasattr(t, "_fsdp")
                                 for t in s2.extra["ema_params"].values())
    tr.close()
    return out


def parallel(rank, world, port, root):
    import torch.distributed as dist
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    from weatherforecastingtoolkit_tpu_torch.data.datamodule import (
        SEVIRDataModule)
    from weatherforecastingtoolkit_tpu_torch.models.conv_ae import PosAwareAE
    from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear
    from weatherforecastingtoolkit_tpu_torch.models.losses.gan import ActNorm
    from weatherforecastingtoolkit_tpu_torch.models.rollout import (
        batch_generator, make_ensemble_pipeline, make_forecast_pipeline)
    from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import (
        fsdp_sharding, init_sharded, shard_fraction, unsharded)
    from weatherforecastingtoolkit_tpu_torch.parallel.mesh import (
        data_parallel, dp_sharding, init_distributed, make_mesh,
        mp_dense_spec, replicated, shard_batch)
    from weatherforecastingtoolkit_tpu_torch.parallel.serving import (
        make_dp_serving_fn, make_member_parallel_ensemble)
    from weatherforecastingtoolkit_tpu_torch.training.tasks import (
        reconstruction_task)
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    out, ref = {}, {}
    # without a process group: a mesh of one
    one = make_mesh(("dp",), device_type="cpu")
    out["mesh_of_one"] = (dist.get_world_size(), tuple(one.shape))
    dist.destroy_process_group()

    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(("dp",), device_type="cpu")
    try:
        make_mesh(("dp",), shape=(world + 1,), device_type="cpu")
        out["mesh_error"] = None
    except ValueError as e:
        out["mesh_error"] = str(e)

    # -- DP reconstruction step on the JAX weights
    inputs = torch.load(os.path.join(root, "inputs.pt"), weights_only=False)
    recon_batch = torch.from_numpy(inputs["recon_batch"])
    model = PosAwareAE(**SMALL_AE, device=CPU)
    model.load_state_dict(inputs["recon_state"])
    tr, state = recon_run(root, "recon_dp", model, mesh)
    out["recon"] = recon_step(tr, state, {"vil": shard_batch(recon_batch,
                                                             mesh)})

    # -- the GAN step, DP and FSDP, on each rank's rows
    gan_batch = {"vil": shard_batch(torch.from_numpy(inputs["gan_batch"]),
                                    mesh)}
    out["gan_dp"] = gan_run(root, "gan_dp", gan_batch, mesh)
    out["gan_fsdp"] = gan_run(root, "gan_fsdp", gan_batch, mesh, fsdp=True)
    # remat under FSDP with bf16 mixed precision, against the same step
    # without FSDP
    for key, fsdp in (("gan_dp_remat_bf16", False),
                      ("gan_fsdp_remat_bf16", True)):
        out[key] = gan_run(root, key, gan_batch, mesh, fsdp=fsdp, remat=True,
                           mixed_precision=True)

    # -- init_sharded: each rank's shards of the plain init, nothing whole
    def init_fn(seed, device):
        return PosAwareAE(**dict(SMALL_AE, latent_dim=512), device=device,
                          seed=seed)

    sharded = init_sharded(init_fn, 3, mesh, device=CPU)
    equal = True
    for p, q in zip(sharded.parameters(), init_fn(3, CPU).parameters()):
        if hasattr(p, "_fsdp"):   # this rank's rows; gathered, the whole
            equal &= torch.equal(p, q.chunk(world, p._fsdp.dim)[rank])
            with torch.no_grad():
                equal &= torch.equal(unsharded(p), q)
        else:
            equal &= torch.equal(p, q)
    out["init_sharded"] = (shard_fraction(sharded), equal)

    # -- ActNorm's statistics over the global batch
    with data_parallel(mesh):
        out["actnorm"] = [t.numpy() for t in ActNorm.stats_from(shard_batch(
            torch.from_numpy(inputs["actnorm_x"]), mesh))]

    # -- Trainer.fit on the auto-sharded tree: DP, then FSDP and its resume
    dm = SEVIRDataModule(dataset_name="sevirlr", sevir_dir=inputs["tree"],
                         seq_len=13, stride=12, layout="NTCHW", batch_size=2,
                         num_workers=0, train_test_split_date=(2019, 3, 1),
                         val_ratio=0.2)
    dm.prepare_data()
    dm.setup()
    out["shards"] = (dm.num_shard, dm.rank)
    fit_model = PosAwareAE(**SMALL_AE, device=CPU)
    tr = Trainer(config(root, "fit_dp"), reconstruction_task(fit_model),
                 mesh=mesh, device=CPU)
    st = tr.fit(dm.train_loader())
    out["fit_dp"] = (int(st.step), np_tree(dict(st.params.named_parameters())))
    tr.close()
    big = PosAwareAE(**dict(SMALL_AE, latent_dim=512), device=CPU)
    cfg = config(root, "fit_fsdp", fsdp=True)
    tr = Trainer(cfg, reconstruction_task(big), mesh=mesh, device=CPU)
    st = tr.init_state()
    fraction = shard_fraction(st.params)
    st = tr.fit(dm.train_loader(), state=st)
    tr.close()
    tr2 = Trainer(cfg, reconstruction_task(big), mesh=mesh, device=CPU,
                  resume=True)
    resumed = tr2._resume_state is not None
    s2 = tr2.init_state()
    out["fit_fsdp"] = {
        "fraction": fraction, "resumed": resumed,
        "steps": (int(st.step), int(s2.step)),
        "resumed_fraction": shard_fraction(s2.params),
        "equal": all(torch.equal(a, b) and a.shape == b.shape for a, b in zip(
            st.params.parameters(), s2.params.parameters())),
        "moments_equal": all(torch.equal(a, b) for a, b in zip(
            st.opt_state["mu"] + st.opt_state["nu"],
            s2.opt_state["mu"] + s2.opt_state["nu"]))}
    tr2.close()

    # -- resume of a sharded run across an ema_decay toggle, both ways: two
    # steps saved, the newest restored into shards, the EMA sharded
    out["ema_toggle"] = {}
    for before, after in ((0.9, None), (None, 0.9)):
        out["ema_toggle"][(before, after)] = ema_toggle(
            root, mesh, f"ema_{before}_{after}", before, after,
            {"vil": shard_batch(recon_batch, mesh)})

    # -- resume agreed by every rank: rank 1 cannot read the newest step,
    # so both ranks resume the one before it
    from weatherforecastingtoolkit_tpu_torch.training import checkpoint
    agree_model = PosAwareAE(**SMALL_AE, device=CPU)
    tr = Trainer(config(root, "agree"), reconstruction_task(agree_model),
                 mesh=mesh, device=CPU)
    st = tr.init_state()
    for step in (1, 2):
        st.step = step
        tr.ckpt.save(step, st)
    tr.close()
    load = checkpoint.CheckpointManager.load
    if rank == 1:
        def unreadable_newest(self, step):
            if step == 2:
                raise OSError("step 2 is unreadable on this rank")
            return load(self, step)
        checkpoint.CheckpointManager.load = unreadable_newest
    tr = Trainer(config(root, "agree"), reconstruction_task(agree_model),
                 mesh=mesh, device=CPU, resume=True)
    checkpoint.CheckpointManager.load = load
    out["resume_agreed"] = (int(tr.init_state().step), tr.run_id)
    tr.close()

    # -- dp serving of an uneven batch
    hw, t_in, t_out = 8, 5, 3
    fc = DLinear(t_in, t_out, kernel_size=3, device=CPU)
    fc.load_state_dict(inputs["dlinear_state"])
    codec = dict(encode_apply=lambda f: f.reshape(f.shape[0], -1),
                 decode_apply=lambda z: z.reshape(z.shape[0], 1, hw, hw),
                 forecaster_apply=lambda m, z: m(z), device=CPU)
    pipe = make_forecast_pipeline(input_frames=t_in, pred_frames=t_out,
                                  **codec)
    out["served"] = make_dp_serving_fn(pipe, mesh, params=fc)(
        inputs["serve_frames"])

    # -- the member-parallel ensemble: 4 members, 2 a rank
    ens_kw = dict(codec, input_frames=4, pred_frames=t_out)
    efc = DLinear(4, t_out, kernel_size=3, device=CPU)
    x = torch.from_numpy(inputs["ensemble_frames"])
    ens = make_member_parallel_ensemble(mesh=mesh, n_members=4, **ens_kw)
    out["ensemble"] = (ens(efc, x, 5, 0.1).numpy(), ens.members_per_rank)
    try:
        make_member_parallel_ensemble(mesh=mesh, n_members=3, **ens_kw)
        out["ensemble_error"] = None
    except ValueError as e:
        out["ensemble_error"] = str(e)
    if rank == 0:
        local = make_ensemble_pipeline(n_members=2, **ens_kw)
        ref["ensemble"] = torch.cat(
            [local(efc, x, batch_generator(5, r, CPU), 0.1)
             for r in range(world)], dim=1).numpy()

    # -- (dp, mp) = (1, 2): the bottleneck dense pair tensor-parallel
    mesh2 = make_mesh(("dp", "mp"), shape=(1, world), device_type="cpu")
    tp_model = PosAwareAE(**dict(SMALL_AE, latent_dim=64), device=CPU)
    tr, state = recon_run(root, "tp", tp_model, mesh2)
    parallelize_module(state.params, mesh2["mp"],
                       {"to_latent": ColwiseParallel(),
                        "from_latent": RowwiseParallel()})
    state.opt_state = tr.tx.init(list(state.params.parameters()))
    out["placements"] = {
        "dp_sharding": dp_sharding(mesh2), "replicated": replicated(mesh2),
        "mp_dense_spec": mp_dense_spec(mesh2),
        "colwise": list(state.params.to_latent.weight.placements),
        "rowwise": list(state.params.from_latent.weight.placements),
        "fsdp_big": fsdp_sharding(torch.empty(8, 4096), mesh),
        "fsdp_small": fsdp_sharding(torch.empty(64), mesh)}
    out["tp"] = recon_step(tr, state, {"vil": recon_batch})
    dist.destroy_process_group()

    # -- one-process references (rank 0, no group)
    if rank == 0:
        tr, state = recon_run(root, "recon_one", model)
        ref["recon"] = recon_step(tr, state, {"vil": recon_batch})
        full = {"vil": torch.from_numpy(inputs["gan_batch"])}
        ref["gan"] = gan_run(root, "gan_one", full)
        ref["actnorm"] = [t.numpy() for t in ActNorm.stats_from(
            torch.from_numpy(inputs["actnorm_x"]))]
        tr, state = recon_run(root, "tp_one", tp_model)
        ref["tp"] = recon_step(tr, state, {"vil": recon_batch})
    torch.save({"out": out, "ref": ref},
               os.path.join(root, f"parallel_{rank}.pt"))


class TinyNet(torch.nn.Module):
    """tests/multihost_model.py's TinyNet: conv 3x3 (8) - relu - conv 3x3
    (1) over each frame, SAME padding."""

    def __init__(self):
        super().__init__()
        g = np.random.default_rng(0)
        self.c1 = torch.nn.Conv2d(1, 8, 3, padding=1)
        self.c2 = torch.nn.Conv2d(8, 1, 3, padding=1)
        with torch.no_grad():
            for c in (self.c1, self.c2):
                c.weight.copy_(torch.from_numpy(
                    g.standard_normal(c.weight.shape).astype(np.float32)
                    / np.sqrt(c.weight[0].numel())))
                c.bias.zero_()

    def forward(self, x):
        b, t = x.shape[:2]
        h = x.reshape((b * t,) + x.shape[2:])
        h = self.c2(torch.relu(self.c1(h)))
        return h.reshape(x.shape)


def tiny_step(model, batch, fsdp_mesh=None):
    """One Adam(1e-3) step of the MSE autoencoding loss; (loss, params)."""
    from weatherforecastingtoolkit_tpu_torch.parallel.mesh import (
        all_reduce_mean_, data_parallel, reduce_gradients)
    from weatherforecastingtoolkit_tpu_torch.training.optim import adam

    tx = adam(1e-3)
    params = list(model.parameters())
    opt = tx.init(params)
    with data_parallel(fsdp_mesh):
        loss = torch.mean((model(batch) - batch) ** 2)
        grads = list(torch.autograd.grad(loss, params))
        reduce_gradients(grads, params)
        tx.update(params, grads, opt)
        loss = loss.detach()
        all_reduce_mean_([loss])
    return float(loss)


def multihost(rank, world, port, root):
    import torch.distributed as dist

    from weatherforecastingtoolkit_tpu_torch.data.datamodule import (
        SEVIRDataModule)
    from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import (
        shard_module)
    from weatherforecastingtoolkit_tpu_torch.parallel.mesh import (
        init_distributed, make_mesh)
    from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
        CheckpointManager)

    init_distributed(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(("dp",), device_type="cpu")
    dm = SEVIRDataModule(dataset_name="sevirlr", sevir_dir=root + "/sevir",
                         seq_len=4, stride=25, layout="NTCHW", batch_size=4,
                         num_workers=0, shuffle_train=False, val_ratio=0.0,
                         train_test_split_date=None)
    dm.prepare_data()
    dm.setup(stage="fit")
    local = next(iter(dm.train_loader()))["vil"]
    local = torch.as_tensor(np.asarray(local, np.float32))
    out = {"shards": (dm.num_shard, dm.rank), "rows": int(local.shape[0])}

    dp = TinyNet()
    out["dp_loss"] = tiny_step(dp, local, mesh)
    out["dp"] = {k: p.detach().numpy().copy()
                 for k, p in dp.named_parameters()}

    fs = shard_module(TinyNet(), mesh, min_shard_elems=1, device=CPU)
    out["fsdp_loss"] = tiny_step(fs, local, mesh)
    out["fsdp"] = {k: (p.detach().numpy().copy(),
                       p._fsdp.dim if hasattr(p, "_fsdp") else -1)
                   for k, p in fs.named_parameters()}
    # every rank writes its shards; restored into a fresh sharded template
    mgr = CheckpointManager(root + "/ckpt", mesh=mesh)
    mgr.save(1, {"params": fs})
    template = shard_module(TinyNet(), mesh, min_shard_elems=1, device=CPU)
    mgr.restore({"params": template}, 1)
    out["ckpt_equal"] = all(torch.equal(a, b) for a, b in zip(
        fs.parameters(), template.parameters()))
    dist.destroy_process_group()
    torch.save(out, os.path.join(root, f"multihost_{rank}.pt"))


if __name__ == "__main__":
    torch.set_num_threads(1)
    case, rank, world, port, root = sys.argv[1:6]
    {"parallel": parallel, "multihost": multihost}[case](
        int(rank), int(world), int(port), root)
