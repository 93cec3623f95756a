"""Standalone forecast evaluation on the PyTorch/CUDA port: model vs
persistence, full metric dict (counterpart of experiments/evaluate.py).

The `trainer.test` analog plus the reference's persistence comparison
(reference README.md:80-92 — "beats the persistence baseline" is the headline
result this reproduces). Evaluates the latent_dlinear-style rollout from a
run directory of the port's trainer (or a fresh init) on the test split and
prints both metric dicts; the frozen VAE's GroupNorms run the Hopper
GroupNorm+SiLU kernel on the card.

    python experiments_gpu/evaluate.py \\
        --config experiments/latent_dlinear/config.yaml \\
        [--run-dir outputs_root/.../run-*/] [--ensemble N] [--device cpu] \\
        [dotlist overrides...]

Randomness comes from explicit ``torch.Generator``s: the ensemble's
calibration draws batch i's members from ``batch_generator(42, i)`` and the
CRPS report from ``batch_generator(7, i)`` (JAX: ``key(42)`` and
``fold_in(key(7), i)``), so the two packages' ensembles differ in their
draws, not in their recipe.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from experiments_gpu.common import build_datamodule  # noqa: E402
from experiments_gpu.latent_common import build_frozen_vae  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.forecasters import DLinear  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.models.rollout import (  # noqa: E402
    evaluate_vs_persistence, make_eval_fn, make_forecast_pipeline)
from weatherforecastingtoolkit_tpu_torch.utils.config import Config  # noqa: E402
from weatherforecastingtoolkit_tpu_torch.utils.device import resolve_device  # noqa: E402

HEADLINE = ["SSIM", "PSNR", "PSNR_ref", "CRPS", "paper_CSI_M_POOL1",
            "paper_HSS_POOL1"]


def load_forecaster(forecaster, run_dir: str):
    """The forecaster's weights from the newest checkpoint of a run
    directory of the port's trainer (``TrainState.params``)."""
    from weatherforecastingtoolkit_tpu_torch.training.checkpoint import (
        CheckpointManager)

    mgr = CheckpointManager(run_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {mgr.ckpt_dir}")
    forecaster.load_state_dict(mgr.load(step)["params"], strict=True)
    return forecaster


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--run-dir", default=None,
                   help="run dir with checkpoints to load the forecaster from")
    p.add_argument("--max-batches", type=int, default=16)
    p.add_argument("--ensemble", type=int, default=0, metavar="N",
                   help="N>0: also evaluate an N-member latent-noise "
                        "ensemble — calibrate noise_std on the first half "
                        "of the eval batches, report CRPS vs deterministic "
                        "on the second half")
    p.add_argument("--ensemble-stds", default="0,0.01,0.02,0.05,0.1,0.2,0.5,1",
                   help="comma-separated noise_std calibration grid")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args, dotlist = p.parse_known_args(argv)
    device = resolve_device(args.device)

    cfg = Config.load(args.config).merged_dotlist(list(dotlist))
    dm = build_datamodule(cfg)
    encode_apply, encode_mode, decode_apply, latent_shape = build_frozen_vae(
        cfg, device)
    d = int(np.prod(latent_shape))
    t_in, t_out = cfg.dataset.input_frames, cfg.dataset.pred_frames
    def fresh():
        return DLinear(seq_len=t_in, pred_len=t_out,
                       kernel_size=cfg.dlinear.kernel_size,
                       individual=cfg.dlinear.get("individual", False),
                       channels=d, device=device)

    forecaster = fresh()
    if args.run_dir:
        try:
            load_forecaster(forecaster, args.run_dir)
            print(f"[eval] loaded forecaster from {args.run_dir}")
        except Exception as e:  # noqa: BLE001 — as experiments/evaluate.py: report, go on
            print(f"[eval] checkpoint load failed ({e}); using fresh init")
            forecaster = fresh()

    pipeline = make_forecast_pipeline(
        encode_apply=encode_mode,  # deterministic for eval
        decode_apply=decode_apply,
        forecaster_apply=lambda fc, z: fc(z),
        input_frames=t_in, pred_frames=t_out, device=device)
    eval_fn = make_eval_fn(pipeline, t_in, t_out, device=device)

    batches = []
    for i, batch in enumerate(dm.test_loader()):
        if i >= args.max_batches:
            break
        batches.append(batch["vil"])
    if not batches:
        raise SystemExit("no test batches")

    model_m, persist_m = evaluate_vs_persistence(eval_fn, forecaster, batches)
    print(f"{'metric':<22}{'model':>12}{'persistence':>14}")
    for k in HEADLINE:
        print(f"{k:<22}{model_m[k]:>12.4f}{persist_m[k]:>14.4f}")

    ens_report = {}
    if args.ensemble > 0:
        from weatherforecastingtoolkit_tpu_torch.metrics import crps as _crps
        from weatherforecastingtoolkit_tpu_torch.models.rollout import (
            batch_generator, calibrate_noise_std, make_ensemble_eval_fn,
            make_ensemble_pipeline)

        ens = make_ensemble_pipeline(
            encode_apply=encode_mode, decode_apply=decode_apply,
            forecaster_apply=lambda fc, z: fc(z),
            input_frames=t_in, pred_frames=t_out, n_members=args.ensemble,
            device=device)
        ens_eval = make_ensemble_eval_fn(ens, t_in, t_out, device=device)
        cal = batches[: max(1, len(batches) // 2)]
        rep = batches[max(1, len(batches) // 2):] or cal
        best, table = calibrate_noise_std(
            ens_eval, forecaster, cal,
            stds=tuple(float(s) for s in args.ensemble_stds.split(",")),
            seed=42, device=device)
        ens_report = {"noise_std": best, "calibration": table}
        for tag, s in (("crps_deterministic", 0.0), ("crps_ensemble", best)):
            tot = 0.0
            for i, seq in enumerate(rep):
                pred, tgt, _ = ens_eval(forecaster, seq,
                                        batch_generator(7, i, device), s)
                tot += _crps(pred, tgt)
            ens_report[tag] = tot / len(rep)
        print(f"[ensemble] N={args.ensemble} noise_std={best:g}: CRPS "
              f"{ens_report['crps_deterministic']:.5f} -> "
              f"{ens_report['crps_ensemble']:.5f}")

    out = {"model": model_m, "persistence": persist_m,
           **({"ensemble": ens_report} if ens_report else {})}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
