"""A run with the timed path broken underneath comes out not correct, and
so does the control (the port's int8 path, the precision below the
configuration's bf16), while the sound program comes out correct: at narrow
widths on the CPU, through the whole harness but its look for a card.
The faults are ``faults.FAULTS``; ``test_nb_card.py`` reads them at the
cells' own sizes on the card."""

import time

import pytest

from nowcast_bench import control, faults, harness
from nowcast_bench.tests.nb_narrow import BATCH, TICK, narrow

SEEDS = (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3)


def _run(cfg, mix, seed, build=None):
    return harness.run_cell(cfg, mix, [], seed, 0.3, False, "cpu",
                            time.perf_counter(), build=build)


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
@pytest.mark.parametrize("mix,fault", [(mix, f) for f, kinds in faults.KINDS.items()
                                       for mix in (BATCH, TICK) if mix["kind"] in kinds])
def test_fault_is_not_correct(name, mix, fault):
    cfg = narrow(name)
    assert _run(cfg, mix, SEEDS[0])["correct"]
    r = _run(cfg, mix, SEEDS[0], build=faults.FAULTS[fault])
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", ["akl_ref", "akl_fast"])
@pytest.mark.parametrize("mix", [BATCH, TICK])
def test_control_is_not_correct_where_the_program_is(name, mix):
    cfg = narrow(name)
    build = control.builder(control=True)
    for seed in SEEDS:
        ok = _run(cfg, mix, seed)
        bad = _run(cfg, mix, seed, build=build)
        assert ok["correct"], ok["checks"]
        assert not bad["correct"], bad["checks"]
