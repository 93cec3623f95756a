"""Readings that set a configuration's limits, many seeds in one process
on the card:

    python3 nowcast_bench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 3 [--control | --fault <name>]

For each seed, one run of the cell as ``run.py`` makes it (the same
set-up, window, sample and comparison with the reference), printing one
JSON line of the compared numbers. With ``--control`` the system module
builds its control (``build(..., control=True)``): its path in the nearest
precision below the one the configuration states. With ``--fault``
the timed path is broken underneath by one of ``faults.FAULTS``. A limit
lies above the program's readings and below the control's; each fault has
to read above it. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def builder(control: bool = False, fault: str = None):
    """The ``build`` a run takes: the program (None), the control, or a
    fault."""
    from nowcast_bench import faults, system
    if control:
        return functools.partial(system.build, control=True)
    return faults.FAULTS[fault] if fault else None


def readings(cell: dict, seeds, seconds: float, build=None):
    """Yields (seed, result) of one run a seed on the card."""
    from nowcast_bench import harness
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    for seed in seeds:
        yield seed, harness.run_cell(cfg, mix, [], seed, seconds, False, "cuda",
                                     time.perf_counter(), build=build)


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from nowcast_bench.faults import FAULTS
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--control", action="store_true")
    which.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    seeds = [int(s) for s in args.seeds.split(",")]
    build = builder(args.control, args.fault)
    for seed, r in readings(cell, seeds, args.seconds, build):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "calls": r["attempted"], "correct": r["correct"],
                          "readings": {k: c["value"] for k, c in r["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
