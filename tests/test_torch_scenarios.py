"""The port's chaos scenarios (``iotml_torch.chaos.scenarios``), their CLI
and ``faults.arm_from_env`` against the JAX package's, on the CPU.

``build(name, seed, records)`` gives byte-equal canonical text for every
scenario at three seeds (and two record counts), with the same topology
and the same errors for an unknown name or too few records;
``python -m iotml_torch.chaos schedule`` and ``run --list`` print what
JAX's print; ``arm_from_env`` arms the same events, and a faulted path
fires them the same way.  ``run --scenario`` of any topology but the
cluster's raises naming ROADMAP A14 (the runner's other topologies).

Tolerance: none; every comparison is exact.
"""

import contextlib
import io

import pytest

from iotml.chaos import __main__ as j_chaos_main
from iotml.chaos import faults as j_faults
from iotml.chaos import scenarios as j_scenarios
from iotml_torch.chaos import __main__ as chaos_main
from iotml_torch.chaos import faults, scenarios

SEEDS = (0, 7, 12345)


def test_the_table_is_jax_table():
    assert sorted(scenarios.SCENARIOS) == sorted(j_scenarios.SCENARIOS)
    for name, (_b, topo, desc) in scenarios.SCENARIOS.items():
        assert (topo, desc) == j_scenarios.SCENARIOS[name][1:]
    assert scenarios.CARS_PER_TICK == j_scenarios.CARS_PER_TICK
    assert "alert-burn" in scenarios.SCENARIOS


@pytest.mark.parametrize("name", sorted(j_scenarios.SCENARIOS))
@pytest.mark.parametrize("seed", SEEDS)
def test_canonical_text_is_byte_equal(name, seed):
    for records in (1000, 30):
        got = scenarios.build(name, seed=seed, records=records)
        want = j_scenarios.build(name, seed=seed, records=records)
        assert got.text().encode() == want.text().encode()
        assert got.topology == want.topology
        assert [e.line() for e in got.events] == \
            [e.line() for e in want.events]


@pytest.mark.parametrize("args", [("no-such",), ("mqtt-flap", 7, 3)])
def test_build_errors_equal(args):
    kw = {"seed": args[1], "records": args[2]} if len(args) > 1 else {}
    errs = []
    for mod in (scenarios, j_scenarios):
        with pytest.raises((KeyError, ValueError)) as e:
            mod.build(args[0], **kw)
        errs.append((type(e.value), str(e.value)))
    assert errs[0] == errs[1]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [
    ["run", "--list"],
    ["schedule", "--scenario", "alert-burn"],
    ["schedule", "--scenario", "drift-storm", "--seed", "3", "--records",
     "500"],
    ["schedule", "--scenario", "leader-kill-mid-drain", "--records", "75"]])
def test_cli_prints_as_jax(argv):
    got = _run(chaos_main.main, argv)
    assert got == _run(j_chaos_main.main, argv)
    assert got[0] == 0 and got[1]


def test_cli_run_without_a_scenario_exits_2_and_with_one_names_a14():
    for main in (chaos_main.main, j_chaos_main.main):
        with contextlib.redirect_stderr(io.StringIO()):
            assert _run(main, ["run"])[0] == 2
    # a scenario of every ported topology runs (exit status = verdict),
    # the one that drives the twin service too
    for scenario in ("mqtt-flap", "compaction-under-crash"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert chaos_main.main(["run", "--scenario", scenario,
                                    "--records", "100"], device="cpu") == 0
        assert "verdict: PASS" in out.getvalue()


def _armed(eng):
    """The events an engine was armed with, in canonical text."""
    return sorted([w[2].line() for ws in eng._windows.values() for w in ws]
                  + [e.line() for e in eng.runner_events])


def _fire(eng, point, n):
    """``n`` traversals of ``point``: the action kind or the exception
    raised at each."""
    out = []
    for _ in range(n):
        try:
            act = eng.fire(point)
        except (ConnectionError, OSError, RuntimeError) as e:
            out.append(type(e).__name__)
            continue
        out.append(None if act is None else act.kind)
    return out


@pytest.mark.parametrize("env", [
    {"IOTML_CHAOS": "1"},
    {"IOTML_CHAOS": "yes", "IOTML_CHAOS_SCENARIO": "alert-burn",
     "IOTML_CHAOS_SEED": "3", "IOTML_CHAOS_RECORDS": "600"},
    {"IOTML_CHAOS": "on", "IOTML_CHAOS_SCENARIO": "dup-storm",
     "IOTML_CHAOS_SEED": "12345"},
    {"IOTML_CHAOS": "off", "IOTML_CHAOS_SCENARIO": "dup-storm"}, {}])
def test_arm_from_env_arms_the_same_events(env):
    try:
        t_eng = faults.arm_from_env(env)
        j_eng = j_faults.arm_from_env(env)
        if env.get("IOTML_CHAOS") == "off" or not env:
            assert t_eng is None and j_eng is None
            return
        assert faults.engine() is t_eng
        want = j_scenarios.build(env.get("IOTML_CHAOS_SCENARIO",
                                         "mqtt-flap"),
                                 seed=int(env.get("IOTML_CHAOS_SEED", "7")),
                                 records=int(env.get("IOTML_CHAOS_RECORDS",
                                                     "1000")))
        assert _armed(t_eng) == _armed(j_eng) == \
            sorted(e.line() for e in want.events)
        # the armed schedules fire alike at every point without a delay
        points = {e.point for e in want.events} - {
            e.point for e in want.events if e.action == "delay"}
        for point in sorted(points - {"runner.kill_leader"}):
            assert _fire(t_eng, point, 60) == _fire(j_eng, point, 60)
        assert dict(t_eng.hits) == dict(j_eng.hits)
        assert dict(t_eng.injected) == dict(j_eng.injected)
    finally:
        faults.disarm()
        j_faults.disarm()
