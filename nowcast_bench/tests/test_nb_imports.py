"""No module the harness loads has a JAX or JAX-package top-level name
(compared whole: the port's own name begins with the JAX package's), and
the reference, the weights and the counts, the system modules' included,
import nothing of the port."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "weatherforecastingtoolkit_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; "
         "print(' '.join(sys.modules))"],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=300)
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    mods = _loaded("import nowcast_bench.run, nowcast_bench.harness, nowcast_bench.system, "
                   "nowcast_bench.trace, nowcast_bench.control; "
                   "from nowcast_bench import harness, system; import json; "
                   "b = json.load(open('BENCHMARK.json')); "
                   "[harness.reader(m['name']) for m in b['end_to_end'] + b['per_layer']]; "
                   "from nowcast_bench.tests.nb_narrow import draw, narrow; "
                   "c = narrow('akl_fast'); system.build(c, 'tick', draw(c, 1), 'cpu')")
    tops = {m.split(".", 1)[0] for m in mods}
    assert "weatherforecastingtoolkit_tpu_torch" in tops      # the port is loaded
    assert not tops & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    mods = _loaded("import nowcast_bench.reference, nowcast_bench.check, nowcast_bench.costs, "
                   "nowcast_bench.weights, nowcast_bench.traffic_gen; import json; "
                   "from nowcast_bench import harness, system, weights; "
                   "b = json.load(open('BENCHMARK.json')); "
                   "cfgs = [harness.load_json('configs', c['name']) for c in b['configs']]; "
                   "mods = [system.module(c) for c in cfgs]; "
                   "[m.call_cost(c, 1, 1) for m, c in zip(mods, cfgs)]; "
                   "[len(m.weight_groups(c)) for m, c in zip(mods, cfgs)]")
    tops = {m.split(".", 1)[0] for m in mods}
    assert not tops & (FORBIDDEN | {"weatherforecastingtoolkit_tpu_torch"})


def test_run_checks_the_names_whole():
    sys.path.insert(0, str(ROOT))
    from nowcast_bench import run
    before, found = dict(sys.modules), run.forbidden_modules()
    try:
        sys.modules["weatherforecastingtoolkit_tpu_torch_extra"] = sys
        assert run.forbidden_modules() == found
        sys.modules["jaxlib.xla_client"] = sys
        assert "jaxlib" in run.forbidden_modules()
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]
