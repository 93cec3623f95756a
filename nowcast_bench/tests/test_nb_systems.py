"""System modules found by name (``system.py``, ``systems/``).

* Path B through ``systems/pathb_akl.py`` draws the weights, counts the
  work and works out the reference's answers bit for bit as the harness did
  before it was split into system modules (checksums recorded from that
  harness on the CPU), and refuses a forecaster it does not serve.
* The generic core names no model and reads no configuration key of one.
* A second system, a toy in ``tests/toy/`` copied into a temporary
  directory with its configuration, mixes and cells, runs end to end
  through ``harness.run_cell`` on the CPU: correct, while its control and
  every fault are not.
"""

import hashlib
import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from nowcast_bench import control, faults, harness, system, traffic_gen
from nowcast_bench.tests.nb_narrow import draw, narrow

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
TOY = Path(__file__).resolve().parent / "toy"
CPU = torch.device("cpu")
SEEDS = (2 ** 31 + 21, 5)

# sha256 (first 16 hex digits) of the VAE's and DLinear's drawn tensors in
# their spec's order, on the CPU
WEIGHTS = {
    ("akl_ref", "narrow", SEEDS[0]): ("c27a3006c11b3ed3", "b91bf0b9110dbf5a"),
    ("akl_ref", "narrow", SEEDS[1]): ("9c9a5ba52c48aeea", "771a1cab1e6c3613"),
    ("akl_ref", "full", SEEDS[0]): ("1458218caea8d67f", "b91bf0b9110dbf5a"),
    ("akl_ref", "full", SEEDS[1]): ("878e129c12e3fbe6", "771a1cab1e6c3613"),
    ("akl_fast", "narrow", SEEDS[0]): ("9d8bdff940f29dc2", "b91bf0b9110dbf5a"),
    ("akl_fast", "narrow", SEEDS[1]): ("76c54225cb644846", "771a1cab1e6c3613"),
    ("akl_fast", "full", SEEDS[0]): ("c696b40d938f17e7", "b91bf0b9110dbf5a"),
    ("akl_fast", "full", SEEDS[1]): ("265c2dbb1a2ecc00", "771a1cab1e6c3613"),
}
# (batch, new frames a sequence): FLOPs, sha256 of repr(gn_calls), GroupNorm calls
COSTS = {
    ("akl_ref", 64, 13): (41725905076224, "c11ec25e3a3feb18", 42),
    ("akl_ref", 162, 1): (83628095569920, "1f4ef1a6b1d9a293", 42),
    ("akl_ref", 256, 13): (166903620304896, "b52a8f067ca8329b", 42),
    ("akl_ref", 1, 0): (504910774272, "1d7080df5f8195b7", 42),
    ("akl_ref", 1, 1): (516222812160, "995bba4fd0488953", 42),
    ("akl_fast", 64, 13): (8930742763520, "7aa1ec297a80dd6a", 30),
    ("akl_fast", 162, 1): (16462109343744, "d429d01ab833a85d", 30),
    ("akl_fast", 256, 13): (35722971054080, "1a743ebce3a02d71", 30),
    ("akl_fast", 1, 0): (98457550848, "4fa5d45f3f9b1e2d", 30),
    ("akl_fast", 1, 1): (101617958912, "feb7c10e1b440580", 30),
}
# the reference's forecast and latent window over 3 narrow sequences (seed
# 2**31 + 23), one CPU thread
ANSWERS = {"akl_ref": ("cfa7a153c939fbce", "edc3793ed5e60cff"),
           "akl_fast": ("b37309a9afcfe7a8", "fe83cae5625a7bf4")}

GENERIC = ["harness.py", "system.py", "weights.py", "check.py", "loops.py",
           "control.py", "faults.py"] + [f"metrics/{p.name}" for p in (HERE / "metrics").glob("*.py")]
KEYS = {"system", "name", "frame_hw", "input_frames", "pred_frames", "limits"}


def _sha(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _cfg(name: str, width: str) -> dict:
    return narrow(name) if width == "narrow" else harness.load_json("configs", name)


@pytest.mark.parametrize("name,width,seed", sorted(WEIGHTS))
def test_weights_keep_their_bits(name, width, seed):
    w = draw(_cfg(name, width), seed)
    assert list(w) == ["vae", "forecaster"]
    assert (_sha(w["vae"].values()), _sha(w["forecaster"].values())) == WEIGHTS[name, width, seed]


@pytest.mark.parametrize("name,batch,frames", sorted(COSTS))
def test_call_cost_keeps_its_counts(name, batch, frames):
    cfg = harness.load_json("configs", name)
    c = system.module(cfg).call_cost(cfg, batch, frames)
    gn = hashlib.sha256(repr(c.gn_calls).encode()).hexdigest()[:16]
    assert (c.flops, gn, len(c.gn_calls)) == COSTS[name, batch, frames]


@pytest.mark.parametrize("name", sorted(ANSWERS))
def test_reference_keeps_its_answers(name):
    cfg = narrow(name)
    w = draw(cfg, 2 ** 31 + 23)
    frames = torch.from_numpy(traffic_gen.vil_events(3, 32, 32, 13, 2 ** 31 + 23, CPU))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)           # the order of CPU sums follows the threads
    try:
        answer, state = system.module(cfg).reference(w, cfg, frames, 5)
    finally:
        torch.set_num_threads(threads)
    assert answer.shape == (3, 12, 1, 32, 32) and state.shape == (3, 13, 64)
    assert (_sha([answer]), _sha([state])) == ANSWERS[name]


def test_pathb_refuses_another_forecaster():
    cfg = narrow("akl_fast")
    cfg["forecaster"]["kind"] = "cuboid"
    mod = system.module(cfg)
    for call in (lambda: mod.weight_groups(cfg), lambda: mod.call_cost(cfg, 1, 13),
                 lambda: mod.build(cfg, "batch", {}, CPU)):
        with pytest.raises(ValueError, match="'dlinear' only.*'cuboid'"):
            call()


def test_unknown_system_names_those_there_are():
    with pytest.raises(ValueError, match=r"'nope'.*systems: \[.*'pathb_akl'.*\]"):
        system.module({"name": "x", "system": "nope"})


@pytest.mark.parametrize("path", GENERIC)
def test_generic_core_names_no_model(path):
    src = (HERE / path).read_text()
    assert not re.findall(r"AutoencoderKL|DLinear|conv_mode", src)
    read = set(re.findall(r"cfg\[\s*[\"'](\w+)[\"']", src))
    read |= set(re.findall(r"cfg\.get\(\s*[\"'](\w+)[\"']", src))
    assert read <= KEYS, read - KEYS


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """The toy's files alone in a temporary directory, the system lookup
    pointed there."""
    d = tmp_path / "bench"
    shutil.copytree(TOY, d, ignore=shutil.ignore_patterns("__pycache__"))
    for p in d.rglob("*.*"):
        rel = p.relative_to(d)
        assert not (HERE / rel).exists(), rel            # new files, none of the benchmark's
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert all(harness.load_json("configs", c["name"])["system"] != "toy_pixel"
               for c in bench["configs"])
    monkeypatch.setattr(system, "DIR", d / "systems")
    assert system.names() == ["toy_pixel"]
    return d


def _json(d: Path, kind: str, name: str) -> dict:
    return json.loads((d / kind / f"{name}.json").read_text())


@pytest.mark.parametrize("traffic", ["toy_batch", "toy_tick"])
def test_second_system_runs_from_new_files_alone(toy, traffic):
    cells = json.loads((toy / "cells.json").read_text())
    cell = next(w for w in cells["workloads"] if w["traffic"] == traffic)
    cfg = _json(toy, "configs", cell["config"])
    mix = _json(toy, "traffic", traffic)
    metrics = harness.cell_metrics(cells, cell["name"])

    def run(build=None, seed=2 ** 31 + 31, m=()):
        return harness.run_cell(cfg, mix, list(m), seed, 0.3, False, "cpu",
                                time.perf_counter(), build=build)

    r = run(m=metrics["end_to_end"])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {m["name"] for m in metrics["end_to_end"]}
    assert r["attempted"] > 0
    for seed in (2 ** 31 + 32, 2 ** 31 + 33):
        bad = run(control.builder(control=True), seed)
        assert not bad["correct"], bad["checks"]
    for fault, kinds in faults.KINDS.items():
        if mix["kind"] in kinds:
            bad = run(faults.FAULTS[fault])
            assert not bad["correct"], (fault, bad["checks"])
