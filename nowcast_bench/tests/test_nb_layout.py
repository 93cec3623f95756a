"""Configurations, mixes and metric readers are found by name, and
BENCHMARK.json keeps to the layout the harness reads."""

import json
import re
from pathlib import Path

import pytest

from nowcast_bench import harness, loops, system

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_config_and_mix(cell):
    w = {w["name"]: w for w in BENCH["workloads"]}[cell]
    cfg = harness.load_json("configs", w["config"])
    mix = harness.load_json("traffic", w["traffic"])
    entry = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert entry["file"] == f"nowcast_bench/configs/{w['config']}.json"
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    assert cfg["system"] in system.names()
    assert mix["kind"] in ("batch", "tick") and w["chips"] == 1
    assert all(cfg["limits"][k] is not None for k in
               (["frame_err"] + (["window_err"] if mix["kind"] == "tick" else [])))
    m = harness.cell_metrics(BENCH, cell)
    names = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and m["per_layer"]


@pytest.mark.parametrize("metric", METRICS)
def test_every_metric_has_a_reader_that_reads_nothing_from_an_empty_run(metric):
    read = harness.reader(metric)
    run = harness.Run(cfg={"pred_frames": 12},
                      mix={"batch": 1}, kind="none", setup_s=1.0,
                      window=loops.Window(), cost=None, peaks=None,
                      peak_window_bytes=0)
    assert read(run) in (None, 1.0)      # only setup_s reads a bare run


def test_names_units_and_references():
    assert BENCH["paths"] == ["nowcast_bench"]
    assert BENCH["command"] == ["python3", "nowcast_bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    ends = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in ends
        assert set(m["workloads"]) <= set(ends[m["moves"]].get("workloads", CELLS))
    names = CELLS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_metric_has_no_reader():
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.batch")


@pytest.mark.parametrize("kind,metric,want", [
    ("batch", "frames_per_s", 10 * 4 * 12 / 2.5),
    ("tick", "tick_p95_ms", 47.55),
])
def test_the_rate_takes_every_call_over_the_window_and_the_tail_every_tick(kind, metric, want):
    w = loops.Window(calls=10, seconds=2.5, tick_s=[k / 1e3 for k in range(1, 51)])
    run = harness.Run(cfg={"pred_frames": 12}, mix={"batch": 4, "tiles": 162},
                      kind=kind, setup_s=1.0, window=w, cost=None, peaks=None,
                      peak_window_bytes=0)
    assert harness.reader(metric)(run) == pytest.approx(want)
    other = harness.Run(**{**run.__dict__, "kind": "tick" if kind == "batch" else "batch"})
    assert harness.reader(metric)(other) is None
