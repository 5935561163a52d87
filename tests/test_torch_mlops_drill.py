"""The port's live mlops drills (``iotml_torch.mlops.drill``) and their CLI
against the JAX package's on the CPU: both drills' counts, SLO keys and
invariant verdicts equal JAX's at seed 7 (the swap and rollback times are
wall clock and held to their SLOs), the rollback gate decides as JAX's at
seeds 11 and 13, and ``python -m iotml_torch.mlops list`` / ``drill``
answer as JAX's CLI does."""

import json
import time

import pytest

from iotml.mlops import __main__ as j_mlops_cli
from iotml.mlops.drill import DRILLS as J_DRILLS
from iotml_torch.mlops import __main__ as t_mlops_cli
from iotml_torch.mlops.drill import DRILLS


def _summary(report) -> tuple:
    return (report.drill, report.records, report.published, report.scored,
            sorted(report.slos), sorted(report.restarts), report.injected,
            [(i.name, i.ok) for i in report.invariants])


@pytest.mark.parametrize("name", ["rollout", "rollback"])
def test_drill_verdicts_equal_jax_at_seed_7(name):
    port = DRILLS[name](seed=7, device="cpu")
    jax = J_DRILLS[name](seed=7)
    assert _summary(port) == _summary(jax)
    assert port.ok, [i.verdict() for i in port.invariants if not i.ok]
    slo = {"rollout": ("worst_swap_latency_s", 5.0),
           "rollback": ("time_to_rollback_s", 60.0)}[name]
    assert 0.0 < port.slos[slo[0]] <= slo[1]


@pytest.mark.parametrize("seed", [11, 13])
def test_rollback_gate_decides_as_jax(seed):
    port = DRILLS["rollback"](seed=seed, device="cpu")
    jax = J_DRILLS["rollback"](seed=seed)
    assert _summary(port) == _summary(jax)
    assert {i.name: i.ok for i in port.invariants}["regression_rolled_back"]


def _slow_swaps(monkeypatch, watcher_cls, delay_s=0.5):
    """Delay every watcher swap after the first by ``delay_s``."""
    real = watcher_cls.poll_once

    def poll_once(self):
        v = self.registry.channel(self.channel)
        if self.current_version is not None and v is not None \
                and v != self.current_version:
            time.sleep(delay_s)
        return real(self)

    monkeypatch.setattr(watcher_cls, "poll_once", poll_once)


def test_rollback_gate_waits_for_the_swap_under_an_injected_delay(
        monkeypatch):
    """With the watcher's swap to the candidate delayed 0.5 s, the port's
    gate waits for it and the drill passes; JAX's gate decides before
    the swap and its drill fails ``candidate_deployed_live``."""
    from iotml.mlops.rollout import RegistryWatcher as JRegistryWatcher
    from iotml_torch.mlops.rollout import RegistryWatcher

    _slow_swaps(monkeypatch, RegistryWatcher)
    _slow_swaps(monkeypatch, JRegistryWatcher)
    port = DRILLS["rollback"](seed=7, records=500, device="cpu")
    assert port.ok, [i.verdict() for i in port.invariants if not i.ok]
    jax = J_DRILLS["rollback"](seed=7, records=500)
    assert not {i.name: i.ok for i in jax.invariants}[
        "candidate_deployed_live"]


@pytest.mark.parametrize("name,records", [("rollout", 100),
                                          ("rollback", 499)])
def test_drills_refuse_too_few_records_as_jax(name, records):
    with pytest.raises(ValueError, match="needs >="):
        J_DRILLS[name](seed=7, records=records)
    with pytest.raises(ValueError, match="needs >="):
        DRILLS[name](seed=7, records=records, device="cpu")


def test_list_prints_as_jax(capsys):
    assert t_mlops_cli.main(["list"]) == 0
    got = capsys.readouterr().out
    assert j_mlops_cli.main(["list"]) == 0
    assert got == capsys.readouterr().out
    assert [line.split()[0] for line in got.splitlines()] == \
        ["rollback", "rollout"]


def test_drill_all_json_exits_with_the_verdict(capsys):
    argv = ["drill", "--all", "--seed", "7", "--records", "500", "--json"]
    assert t_mlops_cli.main(argv, device="cpu") == 0
    out, docs, at = capsys.readouterr().out.strip(), [], 0
    while at < len(out):  # one indented JSON document a drill
        doc, at = json.JSONDecoder().raw_decode(out, at)
        docs.append(doc)
        at = len(out) - len(out[at:].lstrip())
    assert [d["drill"] for d in docs] == ["rollback", "rollout"]
    assert all(d["ok"] and d["published"] == 500 for d in docs)
    assert t_mlops_cli.main(["drill", "--drill", "rollout", "--records",
                             "500", "--slo-swap", "4"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "slo worst_swap_latency_s" in out
    assert out.rstrip().endswith("DRILL PASS (rollout)")


def test_unknown_drill_and_no_command_exit_2(capsys):
    for main in (t_mlops_cli.main, j_mlops_cli.main):
        assert main(["drill", "--drill", "no-such-drill"]) == 2
        assert main([]) == 2
    capsys.readouterr()
