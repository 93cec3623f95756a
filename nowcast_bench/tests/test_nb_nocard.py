"""Without a card, run.py exits non-zero and prints no result: it does not
fall back to the CPU."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "nowcast_bench/run.py", "--workload",
                        "akl_ref.batch64", "--seed", str(2 ** 31 + 11),
                        "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


def test_unknown_workload_is_refused():
    p = subprocess.run([sys.executable, "nowcast_bench/run.py", "--workload", "nope",
                        "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
