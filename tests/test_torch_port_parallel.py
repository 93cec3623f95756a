"""The port's distributed layer on the CPU (gloo), against the JAX package
and the port's own one-process steps.

Two worker processes (tests/torch_port_dist_worker.py, case "parallel")
form one process group and run every multi-process check once; rank 0
then computes the one-process references. The module-scoped fixture runs
them (a join timeout and a free port) and each test reads its part:
  * a two-rank DP step of a small PosAwareAE reconstruction_task on the
    JAX weights against jax.grad of the JAX task on the concatenated batch;
  * two DP and two FSDP steps of make_vae_gan_task against the port's
    one-rank steps on the concatenated batch (aux rel 1e-4, update rel-L2
    1e-3), the FSDP state sharded; with remat and bf16, FSDP against DP;
  * a sharded resume across an ema_decay toggle, both ways;
  * Trainer(mesh=...).fit on an auto-sharded SEVIR tree, DP and FSDP
    (shard_fraction < 0.6 at latent_dim 512, as JAX test_trainer_fsdp_flag),
    and the FSDP resume restored into shards with equal values;
  * a resume whose newest checkpoint one rank cannot read: every rank
    takes the one before it;
  * dp serving of an uneven batch against the JAX pipeline;
  * the member-parallel ensemble against the unsharded port ensemble on the
    same per-shard generators, and its ValueError;
  * a (dp, mp) = (1, 2) tensor-parallel step against the one-process step;
  * init_sharded and ActNorm's statistics over the global batch.
In this process: chip_smoke.py's TwoHalves (two threads) against the two
ranks' DP GAN steps, fsdp_spec against JAX's, export_pipeline/load_pipeline at
two batch sizes, and graft_entry_torch.dryrun_multichip(2, device="cpu").
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from weatherforecastingtoolkit_tpu.models import conv_ae as jae
from weatherforecastingtoolkit_tpu.models.forecasters import DLinear as JDLinear
from weatherforecastingtoolkit_tpu.models.rollout import (
    make_forecast_pipeline as jpipeline)
from weatherforecastingtoolkit_tpu.parallel.fsdp import fsdp_spec as jspec
from weatherforecastingtoolkit_tpu.training import tasks as jtasks
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (
    make_synthetic_sevir)
from weatherforecastingtoolkit_tpu_torch.models import conv_ae as pae
from weatherforecastingtoolkit_tpu_torch.models.forecasters import (
    DLinear, dlinear_state_dict_from_flax)
from weatherforecastingtoolkit_tpu_torch.models.losses.gan import ActNorm
from weatherforecastingtoolkit_tpu_torch.models.rollout import (
    make_forecast_pipeline)
from weatherforecastingtoolkit_tpu_torch.parallel.fsdp import fsdp_spec
from weatherforecastingtoolkit_tpu_torch.parallel.serving import (
    export_pipeline, load_pipeline)

from torch_port_dist_worker import run_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_AE = dict(enc_channels=(8, 16), dec_channels=(16, 8, 8), num_blocks=1,
                latent_hw=8, latent_channels=4, latent_dim=32)
HW = 32


def jax_params(module, shape, seed):
    """Variables in flax's tree drawn with numpy (flax's own init compiles
    slowly on the CPU): kernels normal / sqrt(fan_in), pos_emb normal,
    biases zero, norm scales one."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(module.init, jax.random.key(0), jnp.zeros(shape))

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.standard_normal(leaf.shape) / np.sqrt(
                np.prod(leaf.shape[:-1]))
        elif name == "pos_emb":
            v = rng.standard_normal(leaf.shape)
        else:
            v = np.full(leaf.shape, float(name == "scale"))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two workers' results and the inputs they were given."""
    root = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(0)
    j = jae.PosAwareAE(**SMALL_AE)
    jp = jax_params(j, (1, 1, HW, HW), seed=0)
    t_in, t_out, hw = 5, 3, 8
    jfc = JDLinear(seq_len=t_in, pred_len=t_out, kernel_size=3)
    fc_vars = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.3,
        jax.eval_shape(jfc.init, jax.random.key(0),
                       jnp.zeros((1, t_in, hw * hw))))
    make_synthetic_sevir(os.path.join(root, "sevir"), num_events=8,
                         height=32, width=32, raw_seq_len=25)
    inputs = {
        "recon_state": pae.pos_aware_ae_state_dict_from_flax(jp),
        "recon_batch": rng.random((4, 2, 1, HW, HW), np.float32),
        "gan_batch": rng.random((4, 2, 1, 16, 16), np.float32),
        "actnorm_x": rng.standard_normal((6, 5, 4, 3)).astype(np.float32),
        "tree": os.path.join(root, "sevir"),
        "dlinear_state": dlinear_state_dict_from_flax(fc_vars),
        "serve_frames": rng.random((13, t_in, 1, hw, hw), np.float32),
        "ensemble_frames": rng.random((2, 4, 1, hw, hw), np.float32),
    }
    torch.save(inputs, os.path.join(root, "inputs.pt"))
    results, logs = run_group("parallel", root)
    return {"inputs": inputs, "jax": (j, jp, jfc, fc_vars),
            "out": [results[r]["out"] for r in range(2)],
            "ref": results[0]["ref"], "logs": logs}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_mesh_of_one_and_shape_error(group):
    out = group["out"][0]
    assert out["mesh_of_one"] == (1, (1,))
    assert "!= 2 processes" in out["mesh_error"]


def test_dp_recon_step_matches_jax(group):
    """The two-rank step's loss (the ranks' mean) within rel 1e-5 of the
    JAX task's on the concatenated batch, the gradient it applied (averaged
    over 'dp', the same on both ranks) within 1e-5 in rel-L2 and every leaf
    within 1e-4 of its largest magnitude (the one-process parity bound),
    and its update within rel-L2 1e-3 of the port's one-process step's."""
    j, jp, _, _ = group["jax"]
    batch = group["inputs"]["recon_batch"]
    task = jtasks.reconstruction_task(j, loss="l1")
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        task.loss_fn, has_aux=True), static_argnums=3)(
            jp, {"vil": jnp.asarray(batch)}, jax.random.key(0), 0)
    jg = pae.pos_aware_ae_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    a, b = (o["recon"] for o in group["out"])
    np.testing.assert_allclose(a["loss"], float(jloss), rtol=1e-5)
    names = list(jg)
    flat = np.concatenate([a["grads"][n].ravel() for n in names])
    want = np.concatenate([jg[n].numpy().ravel() for n in names])
    assert rel_l2(flat, want) < 1e-5
    for n in names:
        w = jg[n].numpy()
        np.testing.assert_allclose(a["grads"][n], w,
                                   atol=1e-4 * np.abs(w).max() + 1e-12)
        np.testing.assert_array_equal(a["grads"][n], b["grads"][n])
        np.testing.assert_array_equal(a["params"][n], b["params"][n])
    ref = group["ref"]["recon"]
    np.testing.assert_allclose(a["loss"], ref["loss"], rtol=1e-6)
    np.testing.assert_allclose(a["grad_norm"], ref["grad_norm"], rtol=1e-5)
    upd = np.concatenate([(a["params"][n] - a["before"][n]).ravel()
                          for n in names])
    want = np.concatenate([(ref["params"][n] - ref["before"][n]).ravel()
                           for n in names])
    assert rel_l2(upd, want) < 1e-3


def _check_gan(run, ref):
    """Aux scalars within rel 1e-4 on each step, the generator's and the
    discriminator's updates within rel-L2 1e-3."""
    for got, want in zip(run["aux"], ref["aux"]):
        for k in ("loss", "rec_loss", "g_loss", "disc_loss", "d_weight",
                  "grad_norm", "nll_loss", "kl_loss", "logits_real",
                  "logits_fake"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=k)
    for before, after in (("p0", "p1"), ("d0", "d1")):
        names = list(ref[after])
        assert names == list(run[after])
        for n in names:
            np.testing.assert_array_equal(run[before][n], ref[before][n])
        upd = np.concatenate([(run[after][n] - run[before][n]).ravel()
                              for n in names])
        want = np.concatenate([(ref[after][n] - ref[before][n]).ravel()
                               for n in names])
        assert np.linalg.norm(want) > 0
        assert rel_l2(upd, want) < 1e-3, (before, rel_l2(upd, want))


def test_dp_gan_steps_match_one_rank(group):
    a, b = (o["gan_dp"] for o in group["out"])
    _check_gan(a, group["ref"]["gan"])
    for n in a["p1"]:
        np.testing.assert_array_equal(a["p1"][n], b["p1"][n])
    assert a["fraction"] == 1.0


def test_fsdp_gan_steps_match_one_rank(group):
    a, b = (o["gan_fsdp"] for o in group["out"])
    _check_gan(a, group["ref"]["gan"])
    assert a["fraction"] < 0.6, a["fraction"]
    for n in a["p1"]:
        np.testing.assert_array_equal(a["p1"][n], b["p1"][n])


def test_fsdp_remat_bf16_gan_steps_match_dp(group):
    """Remat (each VAE block recomputed in the backward) under trainer.fsdp
    with bf16 mixed precision: the recompute runs on the bf16 copies of the
    gathered parameters the forward saw, so the two steps equal the same
    remat bf16 steps without FSDP (aux rel 1e-4, update rel-L2 1e-3)."""
    a, b = (o["gan_fsdp_remat_bf16"] for o in group["out"])
    _check_gan(a, group["out"][0]["gan_dp_remat_bf16"])
    assert a["fraction"] < 0.6, a["fraction"]
    for n in a["p1"]:
        np.testing.assert_array_equal(a["p1"][n], b["p1"][n])


def test_fsdp_resume_across_ema_toggle(group):
    """A sharded run saved at steps 1 and 2 with trainer.ema_decay on
    resumes with it off, and the reverse: each time the newest step (2,
    not an older one, not a fresh start) into shards with the saved params
    and moments; turned on, the EMA is seeded from the restored params and
    sharded as they are."""
    for o in group["out"]:
        off = o["ema_toggle"][(0.9, None)]
        on = o["ema_toggle"][(None, 0.9)]
        for r in (off, on):
            assert r["resumed"] and r["step"] == 2, r
            assert r["equal"] and r["moments_equal"], r
        assert off["extra"] is None
        assert on["extra"] == ["ema_params"]
        assert on["ema_sharded"] > 0
        for k, (same_sharding, seeded) in on["ema"].items():
            assert same_sharding and seeded, k


def test_two_halves_in_one_process_equal_two_ranks(group, tmp_path):
    """chip_smoke.py's TwoHalves (phase 31's reference on the card): the
    two ranks' DP GAN steps, stepped as two threads of one process on the
    two halves of the batch, give the two gloo processes' parameters and
    aux bit for bit."""
    sys.path.insert(0, REPO)
    import chip_smoke
    import torch_port_dist_worker as worker
    from weatherforecastingtoolkit_tpu_torch.training.trainer import Trainer

    batch = group["inputs"]["gan_batch"]
    half = len(batch) // 2
    runs = []
    for r in range(2):
        cfg = worker.config(str(tmp_path), f"halves{r}",
                            steps=worker.GAN_STEPS, lr=1e-4,
                            weight_decay=1e-4, grad_clip=1.0)
        tr = Trainer(cfg, worker.gan_task(), device="cpu")
        runs.append((tr, tr.init_state(), {"vil": torch.from_numpy(
            batch[r * half:(r + 1) * half])}))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # as the workers: the CPU sums in their order
    try:
        chip_smoke.TwoHalves().run(runs, worker.GAN_STEPS)
    finally:
        torch.set_num_threads(threads)
    want = group["out"][0]["gan_dp"]
    for r, (tr, state, _) in enumerate(runs):
        tr.close()
        got = {"p1": worker.np_tree(dict(state.params.named_parameters())),
               "d1": worker.np_tree(dict(
                   state.extra["disc_params"].named_parameters()))}
        for key in ("p1", "d1"):
            for n, v in want[key].items():
                np.testing.assert_array_equal(got[key][n], v, err_msg=n)


def test_init_sharded_holds_the_plain_init_in_shards(group):
    """init_sharded: every rank holds its rows of each large leaf of the
    plain init (gathered, the whole leaf), about half the bytes."""
    for o in group["out"]:
        fraction, equal = o["init_sharded"]
        assert equal and fraction < 0.6, fraction


def test_actnorm_statistics_of_the_global_batch(group):
    for got, want in zip(group["out"][1]["actnorm"], group["ref"]["actnorm"]):
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_trainer_fit_auto_sharded_and_fsdp_resume(group):
    a, b = group["out"]
    assert a["shards"] == (2, 0) and b["shards"] == (2, 1)
    assert a["fit_dp"][0] == 2
    for n, v in a["fit_dp"][1].items():
        np.testing.assert_array_equal(v, b["fit_dp"][1][n])
    for o in (a, b):
        f = o["fit_fsdp"]
        assert f["fraction"] < 0.6, f["fraction"]
        assert f["resumed"] and f["steps"] == (2, 2)
        assert f["resumed_fraction"] == f["fraction"]
        assert f["equal"] and f["moments_equal"]


def test_resume_is_agreed_by_every_rank(group):
    """Rank 1 cannot read the newest checkpoint (step 2): both ranks skip
    it and resume step 1 of the same run."""
    a, b = (o["resume_agreed"] for o in group["out"])
    assert a == b and a[0] == 1, (a, b)


def test_dp_serving_matches_jax(group):
    """13 sequences over two ranks (padded to 14 and stripped) against
    the JAX pipeline on the whole batch."""
    _, _, jfc, fc_vars = group["jax"]
    hw, t_in, t_out = 8, 5, 3
    pipe = jpipeline(
        encode_apply=lambda f: f.reshape(f.shape[0], -1),
        decode_apply=lambda z: z.reshape(z.shape[0], 1, hw, hw),
        forecaster_apply=lambda p, z: jfc.apply(p, z),
        input_frames=t_in, pred_frames=t_out)
    want = np.asarray(jax.jit(pipe)(fc_vars, jnp.asarray(
        group["inputs"]["serve_frames"])))
    for o in group["out"]:
        assert o["served"].shape == want.shape == (13, t_out, 1, hw, hw)
        np.testing.assert_allclose(o["served"], want, atol=1e-5)


def test_member_parallel_ensemble_matches_unsharded(group):
    for o in group["out"]:
        got, per_rank = o["ensemble"]
        assert per_rank == 2 and got.shape == (2, 4, 3, 1, 8, 8)
        np.testing.assert_array_equal(got, group["ref"]["ensemble"])
        assert "divisible" in o["ensemble_error"]
    # the shards drew different noise
    got = group["out"][0]["ensemble"][0]
    assert not np.allclose(got[:, :2], got[:, 2:])


def test_tensor_parallel_step_matches_one_process(group):
    """(dp, mp) = (1, 2), to_latent column-parallel and from_latent
    row-parallel: loss and gradient norm within rel 1e-5 of the
    one-process step, the whole gradient within rel-L2 1e-5 and every leaf
    within 1e-4 of its largest magnitude (the row-parallel layer sums in
    another order), the update within rel-L2 1e-3, the same on both
    ranks."""
    a, ref = group["out"][0]["tp"], group["ref"]["tp"]
    np.testing.assert_allclose(a["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(a["grad_norm"], ref["grad_norm"], rtol=1e-5)
    names = list(ref["grads"])
    assert rel_l2(np.concatenate([a["grads"][n].ravel() for n in names]),
                  np.concatenate([ref["grads"][n].ravel() for n in names])
                  ) < 1e-5
    for n, w in ref["grads"].items():
        np.testing.assert_allclose(a["grads"][n], w,
                                   atol=1e-4 * np.abs(w).max() + 1e-12)
        np.testing.assert_array_equal(a["before"][n], ref["before"][n])
        np.testing.assert_array_equal(a["params"][n],
                                      group["out"][1]["tp"]["params"][n])
    upd = np.concatenate([(a["params"][n] - a["before"][n]).ravel()
                          for n in names])
    want = np.concatenate([(ref["params"][n] - ref["before"][n]).ravel()
                           for n in names])
    assert rel_l2(upd, want) < 1e-3


def test_placements(group):
    """On the (dp, mp) = (1, 2) mesh: the batch over 'dp', everything else
    replicated; mp_dense_spec (JAX's P(None, 'mp') on flax's (in, out)
    kernel) is Shard(0) of torch's (out, in) weight, as ColwiseParallel
    shards to_latent, and RowwiseParallel's partner Shard(1); a large FSDP
    leaf is sharded on its largest dim, a small one replicated."""
    from torch.distributed.tensor import Replicate, Shard

    pl = group["out"][0]["placements"]
    assert pl["dp_sharding"] == [Shard(0), Replicate()]
    assert pl["replicated"] == [Replicate(), Replicate()]
    assert pl["mp_dense_spec"] == [Replicate(), Shard(0)]
    assert pl["colwise"] == [Shard(0)] and pl["rowwise"] == [Shard(1)]
    assert pl["fsdp_big"] == [Shard(1)] and pl["fsdp_small"] == [Replicate()]


@pytest.mark.parametrize("flax_shape,axis", [
    ((3, 3, 64, 128), 8), ((4096, 4096), 8), ((3, 3, 9, 9), 8),
    ((64,), 8), ((), 8), ((2048, 4096), 2), ((4, 4, 1, 64), 2),
    ((1, 8, 8, 64), 2), ((3, 3, 48, 24), 4)])
def test_fsdp_spec_matches_jax(flax_shape, axis):
    """The port's rule on the torch layout (conv (cout, cin, kh, kw) from
    flax (kh, kw, cin, cout), dense (out, in) from (in, out)) shards the
    same axis as JAX's on the flax layout."""
    to_torch = {4: (3, 2, 0, 1), 2: (1, 0)}.get(len(flax_shape))
    if flax_shape == (1, 8, 8, 64):   # pos_emb keeps flax's shape
        to_torch = (0, 1, 2, 3)
    min_elems = 1 if flax_shape == (3, 3, 9, 9) else 4096
    want = tuple(jspec(flax_shape, axis, min_shard_elems=min_elems))
    shape = (tuple(flax_shape[d] for d in to_torch) if to_torch
             else flax_shape)
    got = fsdp_spec(shape, axis, min_shard_elems=min_elems)
    if not want:
        assert got == ()
    else:
        assert to_torch[got.index("dp")] == want.index("dp")


def test_export_pipeline_roundtrip(tmp_path, rng):
    """torch.export of the rollout with a symbolic batch: the loaded
    program gives the eager pipeline's values at the batch it was exported
    with and at another."""
    t_in, t_out, hw = 5, 3, 8
    fc = DLinear(t_in, t_out, kernel_size=3, device="cpu")
    pipe = make_forecast_pipeline(
        encode_apply=lambda f: f.reshape(f.shape[0], -1),
        decode_apply=lambda z: z.reshape(z.shape[0], 1, hw, hw),
        forecaster_apply=lambda m, z: m(z), input_frames=t_in,
        pred_frames=t_out, device="cpu")
    path = str(tmp_path / "rollout.pt2")
    frames = torch.from_numpy(rng.random((4, t_in, 1, hw, hw), np.float32))
    export_pipeline(pipe, fc, frames, path)
    call = load_pipeline(path)
    for b in (4, 7):
        x = torch.from_numpy(rng.random((b, t_in, 1, hw, hw), np.float32))
        got = call(x)
        assert tuple(got.shape) == (b, t_out, 1, hw, hw)
        np.testing.assert_allclose(got.numpy(), pipe(fc, x).numpy(),
                                   atol=1e-6)


def test_dryrun_multichip_two_processes():
    sys.path.insert(0, REPO)
    import graft_entry_torch

    graft_entry_torch.dryrun_multichip(2, device="cpu")
