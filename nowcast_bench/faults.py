"""Faults planted in the timed path, each a drop-in for ``system.build``:
the check has to call a run with any of them not correct. ``KINDS`` gives
the mix kinds each fault can strike (a cell runs on one card, so there is
no exchange between cards to leave out).

  stale_state     a tick that returns its state unchanged;
  half_batch      half of the batch left out, the first half's answers
                  standing in for the rest;
  altered_answer  the first row of what the system's ``ANSWER`` stage
                  returns scaled by 0.8, in every call.
"""

from __future__ import annotations

import torch

from . import system


def stale_state(*args, **kw):
    s = system.build(*args, **kw)
    real = s.step

    def step(params, state, frame):
        _, out = real(params, state, frame)
        return state, out
    s.step = step
    return s


def half_batch(*args, **kw):
    s = system.build(*args, **kw)
    real = s.pipeline

    def pipeline(params, frames):
        out = real(params, frames[:len(frames) // 2])
        return torch.cat([out, out])
    s.pipeline = pipeline
    return s


def altered_answer(cfg, kind, weights, device, wrap=None, control=False):
    answer = system.module(cfg).ANSWER

    def alter(name, fn):
        fn = wrap(name, fn) if wrap is not None else fn
        if name != answer:
            return fn

        def altered(x):
            y = fn(x)
            y[0] = 0.8 * y[0]
            return y
        return altered
    return system.build(cfg, kind, weights, device, wrap=alter, control=control)


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
KINDS = {"stale_state": ("tick",), "half_batch": ("batch",),
         "altered_answer": ("batch", "tick")}
