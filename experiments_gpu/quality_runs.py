"""Convergence evidence for the beyond-reference models on the PyTorch/CUDA
port (counterpart of experiments/quality_runs.py): Earthformer, the
token-sequence ViT forecaster and AlphaPre actually LEARN (>=1k
optimization steps on synthetic advecting-blob VIL, scored vs the
persistence baseline on date-held-out events).

  earthformer: direct pixel nowcasting (B,T_in,1,H,W) -> (B,T_out,1,H,W),
               MSE + 0.02 (1 - SSIM) + 1e-3 advection-diffusion prior, whose
               forward is the Hopper stencil kernel on the card (one launch
               a step)
  token_vit:   stage 1 trains a ViT AE (token latents) to reconstruct,
               stage 2 freezes it and trains the factorized time/space
               attention forecaster on token sequences
  alphapre:    AlphaPre's four-term spectral loss + 0.06 (1 - SSIM)

    python experiments_gpu/quality_runs.py [--model all] [--steps 1500] \\
        [--device cpu]

The data is a synthetic SEVIR tree of catalog and packed caches
(``make_synthetic_sevir_cache``), read without h5py or pandas.
"""

from __future__ import annotations

import argparse
import datetime
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from weatherforecastingtoolkit_tpu_torch.data.datamodule import SEVIRDataModule  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.data.prefetch import (  # noqa: E402
    BatchLoader, device_prefetch, to_device)
from weatherforecastingtoolkit_tpu_torch.data.synthetic import (  # noqa: E402
    make_synthetic_sevir_cache)
from weatherforecastingtoolkit_tpu_torch.metrics import calc_metrics  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.ops.ssim import ssim  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.training.optim import (  # noqa: E402
    adamw, count_params, cosine_warmup_schedule)
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

HEADLINE = ["SSIM", "PSNR", "CRPS", "paper_CSI_M_POOL1", "paper_HSS_POOL1"]
HIGHER = {"SSIM", "PSNR", "paper_CSI_M_POOL1", "paper_HSS_POOL1"}


def make_data(root, events, img_size, t_in, t_out, batch, device, stride=4):
    """A synthetic tree of `events` weekly events under root, split by date:
    the last ~20% of events are held out. Returns the data module and the
    held-out batches on `device`."""
    day0 = datetime.datetime(2019, 1, 1)
    val_boundary = day0 + datetime.timedelta(
        days=7 * (int(round(events * 0.8)) - 1))
    dm = SEVIRDataModule(dataset_name="sevirlr", sevir_dir=root,
                         seq_len=t_in + t_out, stride=stride, layout="NTCHW",
                         batch_size=batch, num_workers=4,
                         val_split_date=(val_boundary.year, val_boundary.month,
                                         val_boundary.day),
                         train_test_split_date=None, use_cache=True)
    make_synthetic_sevir_cache(root, dm.split_dates("fit"), num_events=events,
                               height=img_size, width=img_size, raw_seq_len=25)
    dm.prepare_data()
    dm.setup(stage="fit")
    eval_batches = [to_device(b["vil"], device) for b in
                    BatchLoader(dm.sevir_val, batch, num_workers=2)]
    print(f"[data] {dm.num_train_samples} train windows, "
          f"{len(eval_batches)} held-out eval batches (event-level split)")
    return dm, eval_batches


def loop(loader, device):
    while True:
        for b in device_prefetch(loader, device=device):
            yield b


def flat(a):
    return a.reshape((-1,) + tuple(a.shape[2:]))


def warmup_cosine(start, peak, end, steps, warm=None):
    """optax.warmup_cosine_decay_schedule(start, peak, warm, steps + warm +
    1, end), warm = max(1, steps // 10) unless given: the JAX runs'
    schedules."""
    warm = max(1, steps // 10) if warm is None else warm
    return cosine_warmup_schedule(start, peak, end, steps + warm + 1, warm)


def grads_of(loss, params, **kw):
    """d loss / d params, zeros where a parameter does not reach the loss
    (jax.grad's zeros)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True, **kw)
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


def sgd_step(model, tx, opt_state, loss_fn):
    """One optimizer step of loss_fn() on the model's parameters; returns
    the loss (a device tensor)."""
    params = list(model.parameters())
    loss = loss_fn()
    tx.update(params, grads_of(loss, params), opt_state)
    return loss.detach()


def train_steps(tag, step_fn, it, steps, log_every=100):
    """step_fn(batch) -> loss, `steps` times; the loss is read on the host
    every `log_every` steps."""
    t0 = time.time()
    loss = None
    for step in range(steps):
        loss = step_fn(step, next(it))
        if step % log_every == 0:
            print(f"[{tag}] step {step} loss {float(loss):.5f}", flush=True)
    print(f"[{tag}] {steps} steps in {time.time()-t0:.0f}s, "
          f"final loss {float(loss):.5f}")


def report(tag, predict_fn, eval_batches, t_in, t_out):
    """predict_fn(frames_in) -> (B, t_out, C, H, W); prints model vs
    persistence on the held-out events; returns #wins."""
    sums_m, sums_p = {}, {}
    for seq in eval_batches:
        frames_in = seq[:, :t_in]
        target = seq[:, t_in:t_in + t_out]
        with torch.no_grad():
            pred = predict_fn(frames_in)
        persist = frames_in[:, -1:].repeat_interleave(t_out, dim=1)
        for store, out in ((sums_m, pred), (sums_p, persist)):
            for k, v in calc_metrics(out, target).items():
                store[k] = store.get(k, 0.0) + float(v)
    n = len(eval_batches)
    model_m = {k: v / n for k, v in sums_m.items()}
    persist_m = {k: v / n for k, v in sums_p.items()}
    wins = 0
    print(f"\n[{tag}] {'metric':<22}{'model':>10}{'persistence':>13}{'better?':>9}")
    for k in HEADLINE:
        better = ((model_m[k] > persist_m[k]) if k in HIGHER
                  else (model_m[k] < persist_m[k]))
        wins += int(better)
        print(f"[{tag}] {k:<22}{model_m[k]:>10.4f}{persist_m[k]:>13.4f}"
              f"{str(better):>9}")
    print(f"[{tag}] beats persistence on {wins}/{len(HEADLINE)} headline "
          f"metrics", flush=True)
    return wins


def earthformer_loss(model, frames_in, frames_gt, coeffs):
    """MSE + 0.02 (1 - SSIM) + 1e-3 advection-diffusion prior, the quality
    recipe (shared with demo_path_b's Earthformer branch). The SSIM term is
    the one headline metric MSE alone loses to persistence on (structural
    similarity rewards keeping texture that MSE prefers to blur away).
    coeffs: (u, v, kappa) as a device tensor."""
    from weatherforecastingtoolkit_tpu_torch.ops.stencil import (
        advection_diffusion_prior)

    pred = model(frames_in)
    mse = torch.mean((pred - frames_gt) ** 2)
    s = ssim(flat(pred), flat(frames_gt))
    u, v, kappa = coeffs
    prior = advection_diffusion_prior(pred, u, v, kappa)
    return mse + 0.02 * (1.0 - s) + 1e-3 * prior


def quality_earthformer(t_in, t_out, img_size, device, hierarchy=1,
                        global_tokens=0):
    """The quality runs' Earthformer (patch 8, dim 128, depth 4, 4 heads,
    window 4x4, persistence-residual head)."""
    from weatherforecastingtoolkit_tpu_torch.models.earthformer import (
        Earthformer)

    return Earthformer(t_in=t_in, t_out=t_out, in_channels=1, patch=8,
                       dim=128, depth=4, num_heads=4, window=(4, 4),
                       residual_out=True, hierarchy=hierarchy,
                       global_tokens=global_tokens, img_size=img_size,
                       device=device, seed=0)


def run_earthformer(args, root, device):
    t_in, t_out = args.t_in, args.t_out
    dm, eval_batches = make_data(root, args.events, args.img_size, t_in, t_out,
                                 args.batch, device)
    model = quality_earthformer(t_in, t_out, args.img_size, device,
                                args.ef_hierarchy, args.ef_global_tokens)
    print(f"[earthformer] {count_params(model)/1e6:.2f}M params")
    tx = adamw(warmup_cosine(1e-5, 5e-4, 1e-6, args.steps),
               weight_decay=0.01, grad_clip=1.0)
    opt = tx.init(list(model.parameters()))
    coeffs = torch.tensor([0.0, 0.0, 0.05], device=device)

    def step_fn(step, batch):
        x = batch["vil"]
        return sgd_step(model, tx, opt, lambda: earthformer_loss(
            model, x[:, :t_in], x[:, t_in:t_in + t_out], coeffs))

    train_steps("earthformer", step_fn, loop(dm.train_loader(), device),
                args.steps)
    model.eval()
    return report("earthformer", model, eval_batches, t_in, t_out)


def run_alphapre(args, root, device):
    from weatherforecastingtoolkit_tpu_torch.models.alphapre import AlphaPre

    t_in, t_out = args.t_in, args.t_out
    dm, eval_batches = make_data(root, args.events, args.img_size, t_in, t_out,
                                 args.batch, device)
    model = AlphaPre(pre_seq_length=t_in, aft_seq_length=t_out,
                     input_shape=(args.img_size, args.img_size), input_dim=1,
                     hidden_dim=32, n_layers=2, spec_num=10,
                     aweight_stop_steps=args.steps, device=device, seed=0)
    print(f"[alphapre] {count_params(model)/1e6:.2f}M params")
    tx = adamw(warmup_cosine(1e-5, 5e-4, 1e-6, args.steps),
               weight_decay=0.01, grad_clip=1.0)
    opt = tx.init(list(model.parameters()))

    def loss_fn(frames_in, frames_gt, step):
        pred, loss = model.predict(frames_in, frames_gt, compute_loss=True,
                                   step=step)
        # + the same differentiable-SSIM term as the earthformer run:
        # the 4-term spectral loss alone blurs (loses SSIM only)
        s = ssim(flat(pred), flat(frames_gt))
        return loss["total_loss"] + 0.06 * (1.0 - s)

    def step_fn(step, batch):
        x = batch["vil"]
        return sgd_step(model, tx, opt, lambda: loss_fn(
            x[:, :t_in], x[:, t_in:t_in + t_out], step))

    train_steps("alphapre", step_fn, loop(dm.train_loader(), device),
                args.steps)
    return report("alphapre", lambda fi: model.predict(fi)[0], eval_batches,
                  t_in, t_out)


def run_token_vit(args, root, device):
    from weatherforecastingtoolkit_tpu_torch.models.token_forecaster import (
        TokenSequenceForecaster)
    from weatherforecastingtoolkit_tpu_torch.models.vit_ae import ViTAE

    t_in, t_out = args.t_in, args.t_out
    dm, eval_batches = make_data(root, args.events, args.img_size, t_in, t_out,
                                 args.batch, device)
    vit = ViTAE(img_size=args.img_size, patch=8, d_token=256, d_latent=1024,
                depth_enc=4, depth_dec=4, heads=8, dropout=0.0,
                device=device, seed=0)
    n_tok = vit.n_patches
    hw = args.img_size

    # ---- stage 1: train the TOKEN roundtrip (encode_tokens -> decode_tokens).
    # The forecaster operates on the [n_tok, d] token-sequence latent
    # (reference README.md:96-109), so that is the pathway that must
    # reconstruct — NOT the collapsed 2048-d vector bottleneck.
    ae_tx = adamw(warmup_cosine(1e-5, 3e-4, 1e-6, args.steps_ae),
                  weight_decay=1e-4)
    ae_opt = ae_tx.init(list(vit.parameters()))

    def ae_loss(frames):
        recon = vit.decode_tokens(vit.encode_tokens(frames))
        return torch.mean(torch.abs(recon - frames))

    it = loop(dm.train_loader(), device)
    train_steps("vit_ae", lambda step, batch: sgd_step(
        vit, ae_tx, ae_opt, lambda: ae_loss(flat(batch["vil"]))),
        it, args.steps_ae)
    vit.requires_grad_(False)

    # ---- stage 2: freeze it; train the token-sequence forecaster
    fc = TokenSequenceForecaster(t_in=t_in, t_out=t_out, d_token=256,
                                 num_heads=8, depth=2, device=device, seed=1)

    def encode_seq(x):
        b, t = x.shape[:2]
        with torch.no_grad():
            tokens = vit.encode_tokens(x.reshape((b * t,) + x.shape[2:]))
        return tokens.reshape(b, t, n_tok, 256)

    fc_tx = adamw(warmup_cosine(1e-5, 5e-4, 1e-6, args.steps),
                  weight_decay=0.0)
    fc_opt = fc_tx.init(list(fc.parameters()))

    def fc_step(step, batch):
        z = encode_seq(batch["vil"])
        return sgd_step(fc, fc_tx, fc_opt, lambda: torch.mean(
            (fc(z[:, :t_in]) - z[:, t_in:]) ** 2))

    train_steps("token_fc", fc_step, it, args.steps)

    def predict(frames_in):
        b = frames_in.shape[0]
        pred_tok = fc(encode_seq(frames_in))
        frames = vit.decode_tokens(pred_tok.reshape((b * t_out, n_tok, 256)))
        return frames.reshape((b, t_out) + frames.shape[1:])

    # diagnostics: the AE roundtrip ceiling on the held-out targets
    # (decode_tokens(encode_tokens(target)))
    s_sum = 0.0
    for seq in eval_batches:
        target = flat(seq[:, t_in:t_in + t_out])
        with torch.no_grad():
            rt = vit.decode_tokens(vit.encode_tokens(target))
        s_sum += float(ssim(rt.reshape(-1, 1, hw, hw),
                            target.reshape(-1, 1, hw, hw)))
    print(f"[token_vit] token-roundtrip ceiling SSIM on held-out targets: "
          f"{s_sum / len(eval_batches):.4f}")

    return report("token_vit", predict, eval_batches, t_in, t_out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="all",
                   choices=["all", "earthformer", "token_vit", "alphapre"])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--steps-ae", type=int, default=4000,
                   help="token_vit stage-1 ViT AE steps")
    p.add_argument("--events", type=int, default=64)
    p.add_argument("--img-size", type=int, default=64)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--t-in", type=int, default=8)
    p.add_argument("--t-out", type=int, default=5)
    p.add_argument("--ef-hierarchy", type=int, default=2,
                   help="earthformer: 2 = hierarchical encoder-decoder "
                        "(patch-merge coarse stage), 1 = flat (round-2 config)")
    p.add_argument("--ef-global-tokens", type=int, default=8,
                   help="earthformer: G global vectors threading every "
                        "cuboid block (0 = off, round-2 config)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    wins = {}
    for name, run in (("earthformer", run_earthformer),
                      ("token_vit", run_token_vit),
                      ("alphapre", run_alphapre)):
        if args.model in ("all", name):
            root = tempfile.mkdtemp(prefix="wx_quality_")
            try:
                wins[name] = run(args, root, device)
            finally:
                shutil.rmtree(root, ignore_errors=True)
    print(f"\nsummary: {wins}")
    return wins


if __name__ == "__main__":
    main()
