"""chip_smoke.py's lanes on the CPU: fresh processes run lane by lane,
side by side, the lanes' card lock keeps two phases apart, and a failure
in any lane or process fails the run.

``run_lanes`` and ``run_process`` start ``chip_smoke.py`` itself; here
``__file__`` points at a stand-in script that prints its arguments and the
clock, optionally holds ``card_lock``, sleeps and exits with the code it
is given, so the children need no GPU. The card's memory watch is
replaced by a no-op.
"""

import contextlib
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

STAND_IN = f"""import os, sys, time
sys.path.insert(0, {REPO!r})
import chip_smoke
name, seconds, rc = sys.argv[1], float(sys.argv[2]), int(sys.argv[3])
with chip_smoke.card_lock(name) if sys.argv[4] == "lock" else open(os.devnull):
    print("start", name, time.time(), flush=True)
    time.sleep(seconds)
    print("end", name, time.time(), flush=True)
sys.exit(rc)
"""


@pytest.fixture
def stand_in(tmp_path, monkeypatch):
    script = tmp_path / "stand_in.py"
    script.write_text(STAND_IN)
    monkeypatch.setattr(chip_smoke, "__file__", str(script))
    monkeypatch.setattr(chip_smoke, "least_free",
                        lambda what: contextlib.nullcontext())
    return script


def events(out):
    """{(kind, name): clock} of the stand-ins' start and end lines."""
    got = {}
    for line in out.splitlines():
        parts = line.split()
        if parts and parts[0] in ("start", "end"):
            got[(parts[0], parts[1])] = float(parts[2])
    return got


def test_lanes_run_side_by_side_and_print_in_order(stand_in, capsys):
    chip_smoke.run_lanes([("a1", "0.8", "0", "-"), ("a2", "0.8", "0", "-")],
                         [("b1", "1.6", "0", "-")])
    out = capsys.readouterr().out
    ev = events(out)
    # the lanes overlap; within a lane a2 starts after a1 has ended
    assert ev[("start", "b1")] < ev[("end", "a1")]
    assert ev[("start", "a2")] >= ev[("end", "a1")]
    names = [ln.split()[:2] for ln in out.splitlines()
             if ln.startswith(("start", "end"))]
    assert names == [["start", "a1"], ["end", "a1"], ["start", "a2"],
                     ["end", "a2"], ["start", "b1"], ["end", "b1"]]
    assert "lanes a1 -> a2 | b1:" in out


def test_the_card_lock_keeps_two_phases_apart(stand_in, capsys):
    chip_smoke.run_lanes([("a1", "0.8", "0", "lock")],
                         [("b1", "0.8", "0", "lock")])
    ev = events(capsys.readouterr().out)
    first, second = sorted(("a1", "b1"), key=lambda n: ev[("start", n)])
    assert ev[("start", second)] >= ev[("end", first)]


def test_a_failed_lane_stops_and_fails_the_run(stand_in, capsys):
    with pytest.raises(AssertionError) as err:
        chip_smoke.run_lanes([("a1", "0", "3", "-"), ("a2", "0", "0", "-"),
                              ("a3", "0", "0", "-")],
                             [("b1", "0.3", "0", "-"), ("b2", "0", "5", "-")])
    out = capsys.readouterr().out
    # a1 failed, so a2 and a3 never ran; lane b ran on
    for name in ("a2", "a3"):
        assert f"start {name}" not in out
        assert f"chip_smoke.py {name}: not run (its lane failed)" in out
    assert "end b1" in out and "end b2" in out
    assert "a1 0 3 - exited 3" in str(err.value)
    assert "b2 0 5 - exited 5" in str(err.value)


def test_a_failed_process_fails_the_run(stand_in, capfd):
    chip_smoke.run_process("c1", "0", "0", "-")
    assert "end c1" in capfd.readouterr().out
    with pytest.raises(Exception, match="exit status 4"):
        chip_smoke.run_process("c2", "0", "4", "-")
