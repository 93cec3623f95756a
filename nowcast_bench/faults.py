"""Faults planted in the timed path, each a drop-in for ``system.build``:
the check has to call a run with any of them not correct. ``KINDS`` gives
the mix kinds each fault can strike (a cell runs on one card, so there is
no exchange between cards to leave out).

  stale_state     a tick that returns its latent windows unchanged;
  half_batch      half of the batch left out, the first half's answers
                  standing in for the rest;
  altered_answer  one decoded frame a call scaled by 0.8 where the decoder
                  produces it.
"""

from __future__ import annotations

import torch

from . import system


def stale_state(*args, **kw):
    s = system.build(*args, **kw)
    real = s.step

    def step(fc, window, frame):
        _, out = real(fc, window, frame)
        return window, out
    s.step = step
    return s


def half_batch(*args, **kw):
    s = system.build(*args, **kw)
    real = s.pipeline

    def pipeline(fc, frames):
        out = real(fc, frames[:len(frames) // 2])
        return torch.cat([out, out])
    s.pipeline = pipeline
    return s


def altered_answer(cfg, kind, vae_w, fc_w, device, wrap=None, conv_mode=None):
    def alter(name, fn):
        fn = wrap(name, fn) if wrap is not None else fn
        if name != "decode":
            return fn

        def decode(z):
            y = fn(z)
            y[0] = 0.8 * y[0]
            return y
        return decode
    return system.build(cfg, kind, vae_w, fc_w, device, wrap=alter, conv_mode=conv_mode)


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_answer": altered_answer}
KINDS = {"stale_state": ("tick",), "half_batch": ("batch",),
         "altered_answer": ("batch", "tick")}
