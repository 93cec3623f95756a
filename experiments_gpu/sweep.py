"""Sweeps on the PyTorch/CUDA port: run one of the port's train
scripts over an array of dotlist overrides (counterpart of
experiments/sweep.py).

The bash-free analog of the reference's `declare -a RUNS` sweep arrays
(reference experiments/v1_experiments/pretrained_ae_conv_disc/run.sh:50-61):

    python experiments_gpu/sweep.py experiments_gpu/ae_recon/train.py \\
        --runs "optim.lr=1e-3" "optim.lr=3e-4 model.latent_dim=1024"

Each run is supervised (crash -> resume retry) like run.sh's loop: a run
whose process exits non-zero is started again with ``--resume true``. A
run's item may hold the script's flags too (``"--device cpu optim.lr=1e-3"``).
Returns the indices of the runs that failed every attempt.
"""

from __future__ import annotations

import argparse
import shlex
import subprocess
import sys


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("train_script")
    p.add_argument("--runs", nargs="+", required=True,
                   help="each item: space-separated dotlist overrides")
    p.add_argument("--max-retries", type=int, default=20)
    args = p.parse_args(argv)

    failed = []
    for i, run in enumerate(args.runs):
        overrides = shlex.split(run)
        cmd = [sys.executable, args.train_script, *overrides]
        print(f"[sweep] run {i}: {' '.join(overrides)}", flush=True)
        for attempt in range(args.max_retries):
            resume = ["--resume", "true"] if attempt else []
            result = subprocess.run(cmd + resume)
            if result.returncode == 0:
                break
            print(f"[sweep] run {i} attempt {attempt} exited "
                  f"{result.returncode}; retrying with resume", flush=True)
        else:
            print(f"[sweep] run {i} FAILED after {args.max_retries} attempts",
                  flush=True)
            failed.append(i)
    return failed


if __name__ == "__main__":
    main()
