"""The port's spans (``training/profiling.py::span``, ``spans``) in its
rollout, on the CPU: off with no profiler open, on and on the profiler's
clock while a session is open, nested as the rollout's layers are, one
call span a call; ``StepTimer``'s phases as spans; an exported pipeline
holds no profiler op. One test (marked ``cuda``) does the same on the card,
where ``wftk.input`` counts the bytes taken from host memory; it imports no
JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_port_tracing.py
"""

import statistics

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from weatherforecastingtoolkit_tpu_torch.models import forecasters as pfc
from weatherforecastingtoolkit_tpu_torch.models import rollout as pro
from weatherforecastingtoolkit_tpu_torch.parallel.serving import export_pipeline
from weatherforecastingtoolkit_tpu_torch.training import profiling

T_IN, T_OUT, HW, B = 4, 3, 16, 2
LAYERS = {"wftk.input", "wftk.encode", "wftk.forecast", "wftk.decode"}


def _encode(x):
    return F.avg_pool2d(x, 4)                              # (N, 1, 4, 4)


def _decode(z):
    return F.interpolate(z, scale_factor=4.0)


def _parts(device="cpu"):
    fc = pfc.DLinear(T_IN, T_OUT, kernel_size=3, channels=16, device=device)
    kw = dict(encode_apply=_encode, decode_apply=_decode,
              forecaster_apply=lambda m, z: m(z), input_frames=T_IN,
              pred_frames=T_OUT, device=device)
    return fc, kw


def _frames(t=T_IN):
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, (B, t, 1, HW, HW), dtype=np.uint8)


def _since(n):
    """The spans logged after the log's first ``n``, in the order they
    opened (outer first on a tie)."""
    return sorted(profiling.spans()[n:], key=lambda s: (s.start_ns, -s.end_ns))


def _inside(outer, s):
    return outer is not s and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns


def _children(spans, top):
    """The spans directly inside ``top``: inside it and inside no other
    span inside it."""
    within = [s for s in spans if _inside(top, s)]
    return [s for s in within if not any(_inside(o, s) for o in within)]


def _tops(spans):
    return [s for s in spans if not any(_inside(o, s) for o in spans)]


def test_spans_are_off_with_no_profiler_open(monkeypatch):
    entered = []
    monkeypatch.setattr(profiling, "record_function",
                        lambda name: entered.append(name))
    monkeypatch.setattr(pro, "_host_bytes",                # counted only when on
                        lambda *a: entered.append("bytes"))
    fc, kw = _parts()
    pipeline = pro.make_forecast_pipeline(**kw)
    init, step = pro.make_streaming_forecaster(latent_shape=(1, 4, 4), **kw)
    n = len(profiling.spans())
    with profiling.span("wftk.any", bytes=1) as on:
        assert on is None
    out = pipeline(fc, _frames())
    window = init(_frames())
    step(fc, window, _frames(1)[:, 0])
    assert out.shape == (B, T_OUT, 1, HW, HW)
    assert entered == [] and len(profiling.spans()) == n


def test_pipeline_and_step_spans_nest_under_a_profiler():
    fc, kw = _parts()
    pipeline = pro.make_forecast_pipeline(**kw)
    init, step = pro.make_streaming_forecaster(latent_shape=(1, 4, 4), **kw)
    window = init(_frames())                               # off: logs nothing
    n = len(profiling.spans())
    with profile(activities=[ProfilerActivity.CPU]):
        pipeline(fc, _frames())
        pipeline(fc, _frames())
        step(fc, window, _frames(1)[:, 0])
    new = _since(n)
    calls = _tops(new)
    assert [s.name for s in calls] == ["wftk.pipeline", "wftk.pipeline", "wftk.step"]
    for a, b in zip(calls, calls[1:]):                     # two calls, two spans
        assert a.end_ns < b.start_ns
    assert len(new) == 3 + 3 * len(LAYERS) + 1             # no span outside a call
    for top, layers in zip(calls, (LAYERS, LAYERS, LAYERS | {"wftk.window"})):
        kids = _children(new, top)                         # each a child of its call
        assert sorted(s.name for s in kids) == sorted(layers)
        assert [s for s in new if _inside(top, s)] == kids
        by_name = {s.name: s for s in kids}
        assert by_name["wftk.input"].counts == {"bytes": 0}   # frames stay on the host
        order = ["wftk.input", "wftk.encode", "wftk.forecast", "wftk.decode"]
        starts = [by_name[n].start_ns for n in order]
        assert starts == sorted(starts)


def _host_events(prof):
    """The profiler's host events by name: [(start, end)] in ns."""
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            events.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return events


def _assert_on_the_profilers_clock(logged, events, typical=False):
    """The log stamps a span after its ``record_function`` event opens and
    before it closes: each logged interval lies inside its event, to 100
    µs. With ``typical``, the stamps' median distance from the event's
    edges is under 100 µs too; a thread descheduled between the two stamps
    of one span widens that distance, so it is checked on a quiet host
    only."""
    starts, ends = [], []
    for s in logged:
        around = [(s0, e0) for s0, e0 in events[s.name]
                  if s0 - 100_000 <= s.start_ns <= s.end_ns <= e0 + 100_000]
        assert around, (s, events[s.name])
        s0, e0 = max(around)                              # the innermost
        starts.append(abs(s.start_ns - s0))
        ends.append(abs(e0 - s.end_ns))
    if typical:
        assert statistics.median(starts) < 100_000, starts
        assert statistics.median(ends) < 100_000, ends


def _warm(pipeline, fc, frames, activities):
    """A process's first record_function pays a one-off set-up (about 0.6
    ms on a CPU) between the profiler's stamp and the log's."""
    with profile(activities=activities):
        pipeline(fc, frames)


def test_logged_spans_are_on_the_profilers_clock():
    fc, kw = _parts()
    pipeline = pro.make_forecast_pipeline(**kw)
    _warm(pipeline, fc, _frames(), [ProfilerActivity.CPU])
    n = len(profiling.spans())
    timer = profiling.StepTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.phase("serve"):
                pipeline(fc, _frames())
    logged = _since(n)
    assert {s.name for s in logged} == LAYERS | {"wftk.pipeline", "serve"}
    _assert_on_the_profilers_clock(logged, _host_events(prof))
    # StepTimer's phases are the spans around the calls
    phases = _tops(logged)
    assert [s.name for s in phases] == ["serve"] * 3
    for p in phases:
        assert [s.name for s in _children(logged, p)] == ["wftk.pipeline"]
    assert "serve" in timer.report().splitlines()[1]
    assert "host_s" in timer.report().splitlines()[0]


def test_input_bytes_count_what_leaves_host_memory():
    frames = _frames()
    card, host = torch.device("cuda"), torch.device("cpu")
    assert pro._host_bytes(frames, card) == frames.nbytes
    assert pro._host_bytes(torch.from_numpy(frames), card) == frames.nbytes
    assert pro._host_bytes(frames, host) == 0                        # stays on the host


def test_exported_pipeline_holds_no_profiler_op(tmp_path):
    fc, kw = _parts()
    pipeline = pro.make_forecast_pipeline(**kw)
    frames = torch.from_numpy(_frames())
    program = export_pipeline(pipeline, fc, frames, str(tmp_path / "p.pt2"))
    targets = [str(n.target) for n in program.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
    with torch.inference_mode():
        got = program.module()(frames)
    torch.testing.assert_close(got, pipeline(fc, frames), rtol=0, atol=0)


def test_chip_smoke_counts_no_span_shadow_as_a_kernel():
    """``chip_smoke.py``'s profiles read the card's operations through
    ``card_events``, which drops the device shadow of a user span."""
    import os
    import sys
    from types import SimpleNamespace

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    ev = [SimpleNamespace(key=k, device_type=d, is_user_annotation=u)
          for k, d, u in (("gemm", cuda, False), ("wftk.decode", cuda, True),
                          ("wftk.decode", cpu, False), ("Memcpy HtoD", cuda, False))]
    prof = SimpleNamespace(key_averages=lambda: ev)
    assert [e.key for e in chip_smoke.card_events(prof)] == ["gemm", "Memcpy HtoD"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_spans_are_on_the_profilers_clock_and_count_host_bytes(cuda_device):
    fc, kw = _parts(cuda_device)
    pipeline = pro.make_forecast_pipeline(**kw)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    frames = _frames()
    on_card = torch.from_numpy(frames).to(cuda_device)
    _warm(pipeline, fc, frames, activities)
    n = len(profiling.spans())
    with profile(activities=activities) as prof:
        pipeline(fc, frames)
        pipeline(fc, on_card)
        torch.cuda.synchronize()
    logged = _since(n)
    assert len(logged) == 2 * (len(LAYERS) + 1)
    _assert_on_the_profilers_clock(logged, _host_events(prof), typical=True)
    inputs = [s.counts["bytes"] for s in logged if s.name == "wftk.input"]
    assert inputs == [frames.nbytes, 0]
    # the copy and dequantise show on the device under the span's name
    shadows = [ev.name() for ev in prof.profiler.kineto_results.events()
               if ev.device_type() == torch.autograd.DeviceType.CUDA
               and ev.is_user_annotation()]
    assert "wftk.input" in shadows
