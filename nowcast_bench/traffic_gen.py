"""Traffic: advecting-blob VIL frames, and the inputs each mix draws from
them.

``vil_events`` is a frozen copy of the port's
``data/synthetic.py::synthetic_vil_events`` (2 to 4 gaussian blobs an
event, each with its own centre, velocity, width, amplitude and growth,
drawn with numpy in the same order from the same seed), computed for all
events, blobs and frames at once with torch on the card rather than frame by
frame on the host. Its uint8 frames equal the original's within one level
(``exp`` rounds differently in torch); the mixes take them from here, so no
change to the program can move them.

A mix's parameters come from ``traffic/<mix>.json``:
  kind "batch": ``pool`` distinct batches of ``batch`` sequences of T_in
    frames each, cycled through by the closed loop;
  kind "tick": ``tiles`` streams of ``stream_frames`` frames, one a tile;
    tick t brings frame (T_in + t) mod ``stream_frames`` of every stream.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_BLOBS = 4


def sub_seed(seed: int, stream: int) -> int:
    """A 32-bit seed for the ``stream``-th generator of run ``seed``."""
    return int(np.random.SeedSequence([seed % 2 ** 64, stream])
               .generate_state(1)[0])


def blob_params(num_events: int, height: int, width: int,
                seed: int) -> np.ndarray:
    """(N, MAX_BLOBS, 7) float32: cx, cy, vx, vy, sigma, amplitude, growth
    of each blob (amplitude 0, width 1 for the blobs an event lacks), drawn as
    ``synthetic_vil_events`` draws them."""
    rng = np.random.default_rng(seed)
    out = np.zeros((num_events, MAX_BLOBS, 7), np.float32)
    out[:, :, 4] = 1.0          # a blob an event lacks: amplitude 0, width 1
    for n in range(num_events):
        nb = int(rng.integers(2, 5))
        cx = rng.uniform(0, width, nb)
        cy = rng.uniform(0, height, nb)
        vx = rng.uniform(-1.5, 1.5, nb)
        vy = rng.uniform(-1.5, 1.5, nb)
        sig = rng.uniform(height / 16, height / 5, nb)
        amp = rng.uniform(90, 255, nb)
        grow = rng.uniform(-0.01, 0.01, nb)
        out[n, :nb] = np.stack([cx, cy, vx, vy, sig, amp, grow], axis=1)
    return out


@torch.no_grad()
def vil_events(num_events: int, height: int, width: int, t: int, seed: int,
               device, chunk_bytes: int = 1 << 28) -> np.ndarray:
    """(N, T, 1, H, W) uint8 frames of ``num_events`` events, in host
    memory."""
    params = torch.from_numpy(blob_params(num_events, height, width, seed)).to(device)
    yy = torch.arange(height, dtype=torch.float32, device=device)
    xx = torch.arange(width, dtype=torch.float32, device=device)
    k = torch.arange(t, dtype=torch.float32, device=device)
    out = torch.empty((num_events, t, 1, height, width), dtype=torch.uint8)
    step = max(1, chunk_bytes // (MAX_BLOBS * t * height * width * 4))
    for s in range(0, num_events, step):
        p = params[s:s + step, :, :, None]                  # (E, B, 7, 1)
        cx, cy, vx, vy, sig, amp, grow = p.unbind(2)        # (E, B, 1)
        a = amp * (1.0 + grow * k)                          # (E, B, T)
        dx = xx - (cx + vx * k)[..., None]                  # (E, B, T, W)
        dy = yy - (cy + vy * k)[..., None]                  # (E, B, T, H)
        two_s2 = (2 * sig ** 2)[..., None]
        d2 = dy[..., :, None] ** 2 + dx[..., None, :] ** 2  # (E, B, T, H, W)
        frame = (a[..., None, None] * torch.exp(-d2 / two_s2[..., None])).sum(1)
        out[s:s + step, :, 0] = frame.clamp(0, 255).to(torch.uint8).cpu()
    return out.numpy()


def batch_pool(mix: dict, cfg: dict, seed: int, device) -> np.ndarray:
    """(pool, B, T_in, 1, H, W) uint8: the distinct batches of a batch mix."""
    hw, t_in = cfg["frame_hw"], cfg["input_frames"]
    n = mix["pool"] * mix["batch"]
    ev = vil_events(n, hw, hw, t_in, sub_seed(seed, 0), device)
    return ev.reshape((mix["pool"], mix["batch"]) + ev.shape[1:])


def tick_streams(mix: dict, cfg: dict, seed: int, device) -> np.ndarray:
    """(tiles, stream_frames, 1, H, W) uint8: each tile's frame stream."""
    hw = cfg["frame_hw"]
    return vil_events(mix["tiles"], hw, hw, mix["stream_frames"],
                      sub_seed(seed, 0), device)


def tick_frame_index(cfg: dict, mix: dict, tick: int) -> int:
    """The stream frame that tick ``tick`` brings (tick 0 follows the
    T_in frames the windows start from)."""
    return (cfg["input_frames"] + tick) % mix["stream_frames"]


def tick_window(cfg: dict, mix: dict, streams: np.ndarray,
                tick: int) -> np.ndarray:
    """(tiles, T_in, 1, H, W): every tile's last T_in frames after tick
    ``tick``."""
    idx = [tick_frame_index(cfg, mix, tick - j)
           for j in range(cfg["input_frames"] - 1, -1, -1)]
    return streams[:, idx]
