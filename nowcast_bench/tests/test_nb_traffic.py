"""The frozen traffic generator against the port's original, the tick
windows, and the seeded sample of answers."""

import numpy as np
import torch

from nowcast_bench import loops, traffic_gen
from nowcast_bench.tests.nb_narrow import BATCH, TICK, narrow

CPU = torch.device("cpu")


def test_vil_events_match_the_ports_generator():
    from weatherforecastingtoolkit_tpu_torch.data.synthetic import synthetic_vil_events
    seed = 2 ** 31 + 77
    want = synthetic_vil_events(5, 40, 48, 9, seed=seed)          # (N, H, W, T)
    got = traffic_gen.vil_events(5, 40, 48, 9, seed, CPU, chunk_bytes=1 << 16)
    got = got[:, :, 0].transpose(0, 2, 3, 1)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
    assert want.max() > 50                                        # blobs are there


def test_same_seed_same_traffic_and_distinct_batches():
    cfg = narrow("akl_fast")
    a = traffic_gen.batch_pool(BATCH, cfg, 5, CPU)
    b = traffic_gen.batch_pool(BATCH, cfg, 5, CPU)
    c = traffic_gen.batch_pool(BATCH, cfg, 6, CPU)
    assert a.shape == (3, 2, 13, 1, 32, 32) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert all(not np.array_equal(a[i], a[(i + 1) % 3]) for i in range(3))


def test_tick_windows_follow_the_streams():
    cfg = narrow("akl_ref")
    streams = traffic_gen.tick_streams(TICK, cfg, 3, CPU)
    assert streams.shape == (2, 20, 1, 32, 32)
    assert np.array_equal(traffic_gen.tick_window(cfg, TICK, streams, -1), streams[:, :13])
    w = traffic_gen.tick_window(cfg, TICK, streams, 10)           # wraps past 20
    assert np.array_equal(w[:, -1], streams[:, traffic_gen.tick_frame_index(cfg, TICK, 10)])
    assert np.array_equal(w[:, 0], streams[:, (13 + 10 - 12) % 20])


def test_reservoir_is_seeded_and_spread_over_the_window():
    picks = []
    for seed in range(200):
        r = loops.Reservoir(3, seed)
        for i in range(100):
            r.offer(i, lambda i=i: i)
        picks.extend(r.items)
        r2 = loops.Reservoir(3, seed)
        for i in range(100):
            r2.offer(i, lambda i=i: i)
        assert r2.items == r.items
    assert np.mean(picks) > 40 and np.mean(np.asarray(picks) >= 50) > 0.4
