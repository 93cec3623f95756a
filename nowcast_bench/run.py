"""Run one cell of the benchmark once, on the card:

    python3 nowcast_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``) and a mix (``traffic/<mix>.json``). Prints one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics, or with
``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its limit,
which also close standard error. Exits non-zero with no result when the
card is missing, and when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".nowcast_cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "weatherforecastingtoolkit_tpu"}


def forbidden_modules():
    return sorted({m.split(".", 1)[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    # One host thread for the program's CPU work: a pool of OpenMP workers
    # (one a core by default) spins after every parallel copy, such as the
    # tick's gather of its tiles' frames, and takes cores from the thread
    # that dispatches to the card.
    os.environ["OMP_NUM_THREADS"] = "1"

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {cell['chips']} CUDA device(s), found {n}", file=sys.stderr)
        return 3

    sys.path.insert(0, str(ROOT))
    from nowcast_bench import harness
    cfg = harness.load_json("configs", cell["config"])
    mix = harness.load_json("traffic", cell["traffic"])
    metrics = harness.cell_metrics(bench, cell["name"])
    result = harness.run_cell(cfg, mix, metrics["per_layer" if args.trace else "end_to_end"],
                              args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
