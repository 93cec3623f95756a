"""The two closed loops a mix drives, and the sample of answers kept for
the check.

batch: calls of B sequences back to back, each synchronised before the
  next, cycling through the pool of distinct batches. The window ends with
  the call that crosses ``seconds``; the rate is taken over all its calls
  and all its time.
tick: every tile's next frame a tick, the system's state (its window of
  each tile) kept on the card between ticks. Each tick is timed on the card's clock (CUDA events
  recorded on the stream before the tick's first operation and after its
  last), from issue to the synchronised forecast.

A seeded reservoir keeps ``SAMPLES`` of the window's answers (uniform over
the window's calls, whatever their number), copied as they are produced
so that a program that reuses its output buffers is judged on what each
call returned.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from .traffic_gen import sub_seed, tick_frame_index

SAMPLES = 3
WARM_CALLS = 2


class Clock:
    """Marks on the card's stream (CUDA events) or, on the CPU, the host's
    clock; ``seconds(a, b)`` after ``wait(b)``."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def wait(self, m) -> None:
        if self.cuda:
            m.synchronize()

    def seconds(self, a, b) -> float:
        return a.elapsed_time(b) / 1e3 if self.cuda else b - a

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


class Reservoir:
    """A uniform sample of ``k`` items over a stream of unknown length,
    drawn from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng(sub_seed(seed, 3))
        self.items: List = []

    def offer(self, i: int, make: Callable) -> None:
        if i < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            self.items[j] = make()


@dataclass
class Window:
    calls: int = 0
    seconds: float = 0.0
    tick_s: List[float] = field(default_factory=list)
    dispatch_s: List[float] = field(default_factory=list)
    samples: List = field(default_factory=list)


def warm_batch(system, pool: np.ndarray, clock: Clock) -> None:
    for i in range(WARM_CALLS):
        system.pipeline(system.params, pool[i % len(pool)])
        clock.sync()


def run_batch(system, pool: np.ndarray, seconds: float, seed: int,
              clock: Clock, span: Optional[Callable] = None) -> Window:
    """``span(name)`` (traced runs) opens a named host span."""
    win, res, params = Window(), Reservoir(SAMPLES, seed), system.params
    t0 = time.perf_counter()
    while True:
        p = win.calls % len(pool)
        ts = time.perf_counter()
        if span is None:
            out = system.pipeline(params, pool[p])
        else:
            with span("nb.call"):
                out = system.pipeline(params, pool[p])
        win.dispatch_s.append(time.perf_counter() - ts)
        clock.sync()
        res.offer(win.calls, lambda: (p, out.clone()))
        win.calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    win.seconds = time.perf_counter() - t0
    win.samples = res.items
    return win


class TickState:
    """The system's state on the card and the next tick's number."""

    def __init__(self, system, streams: np.ndarray, cfg: dict, clock: Clock):
        self.window = system.init(streams[:, :cfg["input_frames"]])
        self.tick = 0
        clock.sync()


def warm_tick(system, state: TickState, streams: np.ndarray, cfg: dict,
              mix: dict, clock: Clock) -> None:
    for _ in range(WARM_CALLS):
        f = streams[:, tick_frame_index(cfg, mix, state.tick)]
        state.window, _ = system.step(system.params, state.window, f)
        state.tick += 1
        clock.sync()


def run_tick(system, state: TickState, streams: np.ndarray, cfg: dict,
             mix: dict, seconds: float, seed: int, clock: Clock,
             span: Optional[Callable] = None) -> Window:
    win, res, params = Window(), Reservoir(SAMPLES, seed), system.params
    t0 = time.perf_counter()
    while True:
        f = streams[:, tick_frame_index(cfg, mix, state.tick)]
        a = clock.mark()
        ts = time.perf_counter()
        if span is None:
            state.window, out = system.step(params, state.window, f)
        else:
            with span("nb.call"):
                state.window, out = system.step(params, state.window, f)
        win.dispatch_s.append(time.perf_counter() - ts)
        b = clock.mark()
        clock.wait(b)
        win.tick_s.append(clock.seconds(a, b))
        tick, window = state.tick, state.window
        res.offer(win.calls, lambda: (tick, out.clone(), window.clone()))
        state.tick += 1
        win.calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    win.seconds = time.perf_counter() - t0
    win.samples = res.items
    return win
