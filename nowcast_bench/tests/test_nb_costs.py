"""The analytic count against what the reference does: FLOPs against
``FlopCounterMode`` over the reference at narrow widths, GroupNorm calls
against the reference's own GroupNorm calls, and the full-width counts
against the architecture's."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from nowcast_bench import costs, harness, reference, system
from nowcast_bench.tests.nb_narrow import draw, narrow

CPU = torch.device("cpu")


def _record_gn(monkeypatch):
    calls = []
    plain = reference.group_norm

    def rec(x, w, b, groups, eps, silu):
        calls.append((x.shape[0], x.shape[1], x.shape[2], x.shape[3], silu))
        return plain(x, w, b, groups, eps, silu)
    monkeypatch.setattr(reference, "group_norm", rec)
    return calls


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
@pytest.mark.parametrize("kind", ["batch", "tick"])
def test_flops_and_gn_calls_match_the_reference(name, kind, monkeypatch):
    cfg = narrow(name, dtype="float32")
    w = draw(cfg, 3)
    vae_w, fc_w = w["vae"], w["forecaster"]
    b, t_enc = 3, (13 if kind == "batch" else 1)
    hw = cfg["frame_hw"]
    frames = torch.randint(0, 255, (b, t_enc, 1, hw, hw), dtype=torch.uint8)
    gn = _record_gn(monkeypatch)
    counter = FlopCounterMode(display=False)
    with counter:
        z = reference.encode_window(vae_w, cfg, frames, block=10 ** 6)
        if kind == "tick":            # the step forecasts from a full window
            z = z.expand(b, 13, z.shape[2]).contiguous()
        reference.forecast(vae_w, fc_w, cfg, z, block=10 ** 6)
    want = system.module(cfg).call_cost(cfg, b, t_enc)
    assert counter.get_total_flops() == want.flops
    assert sorted(gn) == sorted(tuple(g) for g in want.gn_calls)
    assert want.gn_elem_bytes == 4


def test_full_width_counts():
    """The reference VAE: 11.3 GFLOP a frame to encode, 42.1 to decode, so a
    B=64 call is 41.7 TFLOP; the fast VAE 3.1 and 8.2, 8.9 TFLOP a call (the
    architecture's counts, to the digits given); 42 and 30 GroupNorms a
    call."""
    ref = harness.load_json("configs", "akl_ref")
    fast = harness.load_json("configs", "akl_fast")
    for cfg, enc, dec, call, n_gn in ((ref, 11.3e9, 42.1e9, 41.7e12, 42),
                                      (fast, 3.1e9, 8.2e9, 8.9e12, 30)):
        call_cost = system.module(cfg).call_cost
        one_enc = call_cost(cfg, 1, 1).flops - call_cost(cfg, 1, 0).flops
        one_dec = call_cost(cfg, 1, 0).flops / 12
        assert one_enc == pytest.approx(enc, rel=0.025)
        assert one_dec == pytest.approx(dec, rel=0.025)
        c = call_cost(cfg, 64, 13)
        assert c.flops == pytest.approx(call, rel=0.025)
        assert len(c.gn_calls) == n_gn
        assert c.gn_elem_bytes == 2                        # bf16


def test_gn_bytes_and_bound():
    # x read once and y written once, scale and bias once
    assert costs.gn_bytes(2, 64, 8, 8, 2, 2) == 2 * 2 * 64 * 64 * 2 + 2 * 64 * 2
    peaks = costs.DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    calls = [(64, 128, 32, 32, True)]
    by = costs.gn_bytes(64, 128, 32, 32, 2, 2) / 3.35e12
    assert costs.gn_bound_s(calls, 2, 2, peaks) == pytest.approx(by)
    # bound by bytes in bf16, not by its ten fp32 operations an element
    assert by > 10 * 64 * 128 * 32 * 32 / 67e12
    assert costs.device_peaks("NVIDIA H100 80GB HBM3") is peaks
    assert costs.device_peaks("NVIDIA A100-SXM4-80GB") is None
