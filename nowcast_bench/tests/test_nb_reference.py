"""The plain reference against the port's CPU path at narrow widths, both
geometries: the same weights (drawn by the benchmark), the same uint8
frames, batch and tick."""

import numpy as np
import pytest
import torch

from nowcast_bench import check, reference, system, traffic_gen
from nowcast_bench.tests.nb_narrow import TICK, draw, narrow

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
def test_reference_equals_port_fp32(name):
    # fp32 on both sides: what is left is the order of sums (float32 ulps)
    cfg = narrow(name, dtype="float32")
    w = draw(cfg, 7)
    sys_ = system.build(cfg, "batch", w, CPU)
    frames = traffic_gen.vil_events(3, cfg["frame_hw"], cfg["frame_hw"], 13, 7, CPU)
    out = sys_.pipeline(sys_.params, frames)
    ref, _ = reference.rollout(w["vae"], w["forecaster"], cfg, torch.from_numpy(frames),
                               block=5)
    assert out.shape == ref.shape == (3, 12, 1, cfg["frame_hw"], cfg["frame_hw"])
    assert check.widest_gap(out, ref, 36) < 1e-4


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
def test_tick_equals_batch_over_the_same_window(name):
    cfg = narrow(name, dtype="float32")
    w = draw(cfg, 8)
    tick = system.build(cfg, "tick", w, CPU)
    batch = system.build(cfg, "batch", w, CPU)
    streams = traffic_gen.tick_streams(TICK, cfg, 8, CPU)
    window = tick.init(streams[:, :13])
    for t in range(TICK["stream_frames"] + 3):       # past the stream's wrap
        frame = streams[:, traffic_gen.tick_frame_index(cfg, TICK, t)]
        window, out = tick.step(tick.params, window, frame)
    frames = traffic_gen.tick_window(cfg, TICK, streams, t)
    want = batch.pipeline(batch.params, frames)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    z = reference.encode_window(w["vae"], cfg, torch.from_numpy(frames))
    assert check.widest_gap(window, z, z.shape[0]) < 1e-4


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
def test_param_spec_is_the_port_state_dict(name):
    cfg = narrow(name)
    w = draw(cfg, 9)
    vae, fc = system.module(cfg).modules(cfg, w, CPU)      # what build serves
    assert set(vae.state_dict()) == {n for n, _, _ in reference.param_spec(cfg["vae"])}
    assert set(fc.state_dict()) == {n for n, _, _ in reference.dlinear_spec(cfg["forecaster"])}
    # the port holds the values it was given, rounded to its dtype
    for k, v in vae.state_dict().items():
        assert torch.equal(v.float(), w["vae"][k]), k


def test_space_to_depth_is_the_port_layout():
    from weatherforecastingtoolkit_tpu_torch.models.common import (
        nchw_to_nhwc, nhwc_to_nchw, space_to_depth)
    x = torch.randn(2, 3, 8, 12)
    want = nhwc_to_nchw(space_to_depth(nchw_to_nhwc(x), 4))
    torch.testing.assert_close(reference.space_to_depth(x, 4), want, rtol=0, atol=0)
    torch.testing.assert_close(reference.depth_to_space(want, 4), x, rtol=0, atol=0)


def test_weights_depend_on_the_seed_alone():
    cfg = narrow("akl_fast")
    a = draw(cfg, 2 ** 31 + 5)["vae"]
    b = draw(cfg, 2 ** 31 + 5)["vae"]
    c = draw(cfg, 2 ** 31 + 6)["vae"]
    k = "decoder.conv_out.weight"
    assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
    # bf16-served weights are bf16 values
    assert torch.equal(a[k], a[k].to(torch.bfloat16).float())
    assert np.isfinite(a[k].numpy()).all()
