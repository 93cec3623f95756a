"""One run of one cell: set-up, the measured window, the metrics, the
check. Everything that belongs to one configuration, mix or metric is
found by name:

  configs/<config>.json    the configuration as it is run
  systems/<system>.py      what the configuration's ``"system"`` runs: its
                           weights, program, control, reference and counts
                           (the contract is in ``systems/__init__.py``)
  traffic/<mix>.json       the mix's parameters (kind "batch" or "tick")
  metrics/<metric>.py      the metric's reader, ``read(run) -> float |
                           None``; a metric named ``<stem>.<suffix>`` with
                           no file of its own is read by ``<stem>.py``

With ``trace`` 0 the run reports the cell's end-to-end metrics; with 1 its
per-layer metrics, read from the device trace and the benchmark's own
spans, among them ``nb.<name>`` around each stage callable the system
module passes to ``wrap``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import sys

import torch

from . import check, costs, loops, system, traffic_gen, weights

HERE = Path(__file__).resolve().parent


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def reader(name: str) -> Callable:
    """The ``read`` function of metric ``name``."""
    d = HERE / "metrics"
    path = d / f"{name}.py"
    if not path.exists():
        path = d / f"{name.split('.', 1)[0]}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} in {d}")
    spec = importlib.util.spec_from_file_location(f"nowcast_bench.metrics.{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a reader reads."""
    cfg: dict
    mix: dict
    kind: str
    setup_s: float
    window: loops.Window
    cost: costs.CallCost                  # one call's counted work
    peaks: Optional[Dict[str, float]]     # the card's published peaks
    peak_window_bytes: int                # allocated peak inside the window
    trace: Optional[object] = None        # trace.DeviceTrace


def _spanned(span: Callable) -> Callable:
    """A ``wrap`` for a system's ``build`` that opens the span ``nb.<name>``
    around each call of the callable ``name``."""
    def wrap(name: str, fn: Callable) -> Callable:
        def spanned(x):
            with span(f"nb.{name}"):
                return fn(x)
        return spanned
    return wrap


def cell_metrics(bench: dict, cell: str) -> Dict[str, List[dict]]:
    """The cell's end-to-end and per-layer metric entries."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return {k: [m for m in bench[k] if mine(m)] for k in ("end_to_end", "per_layer")}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(cfg: dict, mix: dict, metrics: List[dict], seed: int,
             seconds: float, trace: bool, device, t_start: float,
             build: Optional[Callable] = None) -> dict:
    """One run; returns the result line's object. ``metrics`` are the
    entries to report (the end-to-end ones with ``trace`` off, the
    per-layer ones with it on). ``build`` replaces ``system.build``
    (the control and the faults break the timed path through it)."""
    mod = system.module(cfg)
    build = build or system.build
    device = torch.device(device)
    clock = loops.Clock(device)
    kind = mix["kind"]
    state = None
    cuda = device.type == "cuda"
    phases = [("imports", time.perf_counter())]

    def phase(name):
        if cuda:
            torch.cuda.synchronize()
        phases.append((name, time.perf_counter()))

    traced = trace and cuda
    if traced:
        from . import trace as tr
    w = weights.make(mod, cfg, seed, device)
    phase("weights")
    sut = build(cfg, kind, w, device, wrap=_spanned(tr.span) if traced else None)
    phase("build")
    if kind == "batch":
        inputs = traffic_gen.batch_pool(mix, cfg, seed, device)
        phase("traffic")
        loops.warm_batch(sut, inputs, clock)
        cost = mod.call_cost(cfg, mix["batch"], cfg["input_frames"])
    else:
        inputs = traffic_gen.tick_streams(mix, cfg, seed, device)
        phase("traffic")
        state = loops.TickState(sut, inputs, cfg, clock)
        loops.warm_tick(sut, state, inputs, cfg, mix, clock)
        cost = mod.call_cost(cfg, mix["tiles"], 1)
    phase("warm-up")
    if traced:
        tr.warm()
        phase("profiler")
    clock.sync()
    setup_s = time.perf_counter() - t_start
    log("setup: " + ", ".join(f"{n} {t - p:.3f} s" for (_, p), (n, t) in
                              zip([("start", t_start)] + phases, phases))
        + (f"; nvcc {mod.nvcc_seconds():.3f} s of the warm-up"
           if cuda and hasattr(mod, "nvcc_seconds") else ""))
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    def window(span=None):
        if kind == "batch":
            return loops.run_batch(sut, inputs, seconds, seed, clock, span)
        return loops.run_tick(sut, state, inputs, cfg, mix, seconds, seed,
                              clock, span)

    device_trace = None
    if traced:
        with tr.session() as holder:
            win = window(tr.span)
        device_trace = holder[0]
        log(f"trace reduced in {time.perf_counter() - t_start - setup_s - win.seconds:.3f} s")
    else:
        win = window()
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    kind_name = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(cfg, mix, kind, setup_s, win, cost,
              costs.device_peaks(kind_name) if cuda else None, peak_window,
              device_trace)
    out_metrics = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    samples = win.samples
    sut = state = run = None          # the program's state goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = check.readings(cfg, kind, samples, inputs, mix, mod.reference, w, device)
    log(f"reference check {time.perf_counter() - t_ref:.3f} s over {len(samples)} answers")
    correct, checks = check.judge(nums, cfg["limits"])
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind_name,
           "count": 1, "memory_peak_bytes": int(max(peak_setup, peak_window))}
    result = {"correct": correct, "attempted": win.calls, "failed": 0,
              "metrics": out_metrics, "device": dev}
    if device_trace is not None:
        dev["busy_s"] = device_trace.busy_s
        dev["window_s"] = device_trace.window_s
        result["breakdown"] = device_trace.breakdown()
    result["checks"] = checks
    return result
