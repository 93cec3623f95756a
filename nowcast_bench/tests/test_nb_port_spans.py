"""The port's spans laid over the device trace (``port_spans.py`` and the
readers of ``input_ms``, ``input_gbps`` and the five ``*_wait_ms``), on
made-up device events and a made-up span log; a port without the span log
reads nothing. On the card (marked ``cuda``), a short traced run of each
cell reads every one of them beside ``encode_ms`` and ``decode_ms``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from nowcast_bench import harness, loops, port_spans, trace
from nowcast_bench.tests.test_nb_trace import Ev
from weatherforecastingtoolkit_tpu_torch.training import profiling
from weatherforecastingtoolkit_tpu_torch.training.profiling import Span

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
STEMS = ("input_ms", "input_gbps", "input_wait_ms", "encode_wait_ms",
         "forecast_wait_ms", "decode_wait_ms", "caller_wait_ms")
WAITS = {"input": 26, "encode": 38, "forecast": 120, "decode": 60, "caller": 200}


def _trace():
    # one call: copy + dequantise, a kernel between the spans, encode,
    # forecast, decode, then the caller's copy of the answer
    return trace.reduce([
        Ev("nb.window", 0, 1000),
        Ev("a1", 100, 120, cuda=True), Ev("a2", 140, 152, cuda=True),
        Ev("wftk.input", 100, 152, cuda=True, span=True),
        Ev("x", 158, 162, cuda=True),
        Ev("b", 200, 300, cuda=True), Ev("c", 420, 440, cuda=True),
        Ev("d", 500, 700, cuda=True), Ev("e", 900, 910, cuda=True),
    ])


def _log():
    return [
        Span("wftk.input", 60, 150, {"bytes": 5000}),
        Span("wftk.encode", 170, 350, {}),
        Span("wftk.forecast", 350, 450, {}),
        Span("wftk.decode", 450, 780, {}),
        Span("wftk.pipeline", 50, 790, {}),
        Span("wftk.input", 5000, 5100, {"bytes": 999}),             # after the window
    ]


def _run(t=None, calls=2):
    w = loops.Window(calls=calls, seconds=1.0)
    return harness.Run(cfg={}, mix={}, kind="batch", setup_s=1.0, window=w,
                       cost=None, peaks=None, peak_window_bytes=0,
                       trace=_trace() if t is None else t)


def test_each_gap_goes_to_the_innermost_port_span_at_its_middle():
    t = _trace()
    # gaps: 120-140 (mid 130, in wftk.input), 152-158 (mid 155, the call
    # span with no child open), 162-200 (encode), 300-420 (mid 360,
    # forecast), 440-500 (decode), 700-900 (mid 800, no port span open)
    assert port_spans.gaps(t.ops) == [(120, 140), (152, 158), (162, 200),
                                      (300, 420), (440, 500), (700, 900)]
    got = port_spans.waits(t, port_spans.in_window(t, _log()))
    assert got == pytest.approx({k: v / 1e9 for k, v in WAITS.items()}, rel=1e-12)


def test_the_waits_sum_to_the_idle_time_between_first_and_last_operation():
    t = _trace()
    first, last = t.ops[0][1], max(e for _, _, e in t.ops)
    idle = (last - first) / 1e9 - t.busy_s
    assert sum(port_spans.waits(t, _log()).values()) == pytest.approx(idle, rel=1e-12)
    # the window's leading and trailing stretches are the only idle left out
    assert t.window_s - t.busy_s - idle == pytest.approx((first + 1000 - last) / 1e9)


def test_readers_per_call(monkeypatch):
    monkeypatch.setattr(port_spans, "log", _log)
    run = _run()
    for layer, ns in WAITS.items():
        got = harness.reader(f"{layer}_wait_ms.batch")(run)
        assert got == pytest.approx(1e3 * ns / 1e9 / 2, rel=1e-12)
    # wftk.input's device time: a1 and a2 (32 ns), over 2 calls
    assert harness.reader("input_ms.batch")(run) == pytest.approx(1e3 * 32e-9 / 2)
    # the window's bytes (not the stray span's) over the same device seconds
    assert harness.reader("input_gbps.tick")(run) == pytest.approx(5000 / 32e-9 / 1e9)


@pytest.mark.parametrize("stem", STEMS)
def test_a_port_without_the_span_log_reads_nothing(monkeypatch, stem):
    monkeypatch.delattr(profiling, "spans")
    assert port_spans.log() is None
    empty = trace.reduce([Ev("nb.window", 0, 1000), Ev("k", 10, 20, cuda=True)])
    assert harness.reader(f"{stem}.batch")(_run(empty)) is None


@pytest.mark.parametrize("stem", STEMS)
def test_a_run_without_a_trace_or_calls_reads_nothing(monkeypatch, stem):
    monkeypatch.setattr(port_spans, "log", _log)
    run = _run(calls=0)
    assert harness.reader(f"{stem}.tick")(run) is None
    run.trace = None
    assert harness.reader(f"{stem}.tick")(run) is None


def test_benchmark_lists_the_fourteen_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for stem in STEMS:
        for suffix, moves in (("batch", "frames_per_s"), ("tick", "tick_p95_ms")):
            m = entries[f"{stem}.{suffix}"]
            assert m["moves"] == moves
            assert m["workloads"] == entries[f"encode_ms.{suffix}"]["workloads"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(w["name"] for w in BENCH["workloads"]))
def test_traced_run_reads_the_port_spans(card, cell):
    p = subprocess.run([sys.executable, "nowcast_bench/run.py", "--workload", cell,
                        "--seed", str(2 ** 31 + 107), "--seconds", "3", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    suffix = "tick" if "tick" in cell else "batch"
    m = r["metrics"]
    for stem in STEMS + ("encode_ms", "decode_ms"):
        assert m.get(f"{stem}.{suffix}", {}).get("value") is not None, (stem, sorted(m))
    waited = sum(m[f"{s}.{suffix}"]["value"] for s in STEMS if s.endswith("_wait_ms"))
    idle = r["device"]["window_s"] - r["device"]["busy_s"]
    assert 0 < waited * r["attempted"] / 1e3 <= idle + 1e-6
