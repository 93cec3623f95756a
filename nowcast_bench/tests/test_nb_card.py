"""On the card (``pytest -m cuda nowcast_bench/tests``), at each cell's own
size and limits, a short window: every cell comes out correct; the control
(the port's int8 path) and each fault the cell can have (``faults.KINDS``)
come out not correct. Skipped without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CELLS = {w["name"]: w for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
sys.path.insert(0, str(ROOT))
from nowcast_bench import control, faults, harness  # noqa: E402

FAULTY = [(c, f) for c in sorted(CELLS) for f in faults.FAULTS
          if harness.load_json("traffic", CELLS[c]["traffic"])["kind"] in faults.KINDS[f]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _fails(cell, build, seed):
    limits = harness.load_json("configs", CELLS[cell]["config"])["limits"]
    for _, r in control.readings(CELLS[cell], [seed], 2.0, build):
        assert not r["correct"], r["checks"]
        assert any(c["value"] > limits[k] for k, c in r["checks"].items()), r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_is_correct_on_the_card(card, cell):
    p = subprocess.run([sys.executable, "nowcast_bench/run.py", "--workload", cell,
                        "--seed", str(2 ** 31 + 101), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct_at_the_cells_size(card, cell):
    _fails(cell, control.builder(control=True), 2 ** 31 + 102)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULTY)
def test_fault_is_not_correct_at_the_cells_size(card, cell, fault):
    _fails(cell, control.builder(fault=fault), 2 ** 31 + 103)
