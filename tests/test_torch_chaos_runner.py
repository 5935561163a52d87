"""The port's chaos runner (``iotml_torch.chaos.runner``) against the JAX
package's ``ChaosRunner`` on the CPU: every ported scenario at seed 7
gives the same published, scored, rewinds, accounted drops, injected
faults and invariant verdicts (none of which reads a score's value);
the rollback gate decides as JAX's at two more seeds; a trainer-crash
run too short for its crash fails ``crash_injected_mid_publish`` where
JAX's raises KeyError; ``compaction-under-crash`` runs the twin's
compacted changelog to PASS; the CLI's exit status is the verdict; the traced topologies leave tracing
as they found it."""

import json

import pytest

from iotml.chaos import faults as j_faults
from iotml.chaos.runner import ChaosRunner as JChaosRunner
from iotml_torch.chaos import faults
from iotml_torch.chaos import runner as t_runner
from iotml_torch.chaos.__main__ import main as chaos_main
from iotml_torch.chaos.runner import ChaosRunner
from iotml_torch.obs import tracing

#: (scenario, records): 100 for the inproc, wire, store and replication
#: topologies, 500 for mlops and compaction-under-crash (deploy/smoke.sh's
#: size), drift-storm at JAX's own test size
CASES = [("mqtt-flap", 100), ("slow-bridge", 100), ("dup-storm", 100),
         ("partition-blackout", 100), ("scorer-crash-resume", 100),
         ("loss-bug-fixture", 100), ("leader-kill-mid-drain", 100),
         ("broker-crash-recover", 100), ("tier-upload-crash", 100),
         ("double-fault", 100), ("compaction-under-crash", 500),
         ("trainer-crash-mid-checkpoint", 500),
         ("rollout-regression-rollback", 500), ("drift-storm", 2000)]


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    j_faults.disarm()
    yield
    faults.disarm()
    j_faults.disarm()


def _summary(report) -> tuple:
    return (report.topology, report.published, report.scored,
            report.rewinds, report.dropped_accounted, report.injected,
            [(i.name, i.ok) for i in report.invariants])


def _both(scenario, records, tmp_path, seed=7):
    jax = JChaosRunner(scenario, seed=seed, records=records,
                       span_path=str(tmp_path / "jax.jsonl")).run()
    port = ChaosRunner(scenario, seed=seed, records=records,
                       span_path=str(tmp_path / "port.jsonl"),
                       device="cpu").run()
    return jax, port


@pytest.mark.parametrize("scenario,records", CASES)
def test_report_equals_jax_at_seed_7(scenario, records, tmp_path):
    jax, port = _both(scenario, records, tmp_path)
    assert _summary(port) == _summary(jax)
    assert sum(port.injected.values()) > 0
    failed = [i.name for i in port.invariants if not i.ok]
    if scenario == "loss-bug-fixture":
        # the checker checked: the seeded unledgered drop is caught
        assert "scored_or_accounted" in failed
        assert "SILENTLY LOST" in next(
            i.detail for i in port.invariants
            if i.name == "scored_or_accounted")
    elif scenario == "drift-storm":
        # both packages end the stream still adapting at seed 7
        assert failed == ["adaptation_converged"]
    else:
        assert port.ok, failed
    if port.topology in ("inproc", "store", "online"):
        assert port.span_path == str(tmp_path / "port.jsonl")


@pytest.mark.parametrize("seed", [11, 13])
def test_rollback_gate_decides_as_jax(seed, tmp_path):
    jax, port = _both("rollout-regression-rollback", 500, tmp_path,
                      seed=seed)
    assert _summary(port) == _summary(jax)
    gate = {i.name: i.ok for i in port.invariants}
    assert gate["regression_rolled_back"] and gate["quality_gap_real"]


def test_trainer_crash_too_short_fails_where_jax_raises(tmp_path):
    """Below one crash round of records the JAX runner raises KeyError
    ('committed'); the port reports the crash that never fired."""
    with pytest.raises(KeyError, match="committed"):
        JChaosRunner("trainer-crash-mid-checkpoint", seed=7,
                     records=100).run()
    report = ChaosRunner("trainer-crash-mid-checkpoint", seed=7,
                         records=100, device="cpu").run()
    verdicts = {i.name: i for i in report.invariants}
    assert not report.ok
    assert not verdicts["crash_injected_mid_publish"].ok
    assert "never fired" in verdicts["crash_injected_mid_publish"].detail
    assert report.injected.get("registry.commit:error") is None


def test_compaction_under_crash_names_a16():
    """Once left out naming ROADMAP A16, the scenario now runs: at the
    JAX suite's 100 records the compactor is killed mid-swap and every
    invariant holds, as in JAX; the engine is disarmed on the way out."""
    report = ChaosRunner("compaction-under-crash", seed=7, records=100,
                         device="cpu").run()
    assert report.ok, [i.detail for i in report.invariants if not i.ok]
    assert report.topology == "store"
    assert report.injected["store.compact_swap:error"] == 1
    assert [i.name for i in report.invariants] == [
        "crash_injected", "cleaned_tmp_swept", "no_key_lost",
        "survivors_byte_identical", "compacted_reads_byte_stable",
        "twin_rebuild_equals_snapshot"]
    assert faults.engine() is None


def test_alert_burn_runs_the_obs_drill_with_the_schedule(monkeypatch):
    """The obs topology stands the runner's engine down and hands the
    schedule's events, seed, records and device to the drill."""
    from iotml_torch.obs import drill as obs_drill
    from iotml_torch.supervise.drill import DrillReport

    seen = {}

    def drill(**kw):
        seen.update(kw, armed=faults.engine())
        return DrillReport(
            drill="alert-burn", seed=kw["seed"], records=kw["records"],
            published=7, scored=5, restarts={}, slos={},
            invariants=[t_runner.Invariant("alert_resolved", True, "ok")],
            injected={"mqtt.deliver:delay": 3})

    monkeypatch.setattr(obs_drill, "drill_alert_burn", drill)
    runner = ChaosRunner("alert-burn", seed=7, records=600, device="cpu")
    report = runner.run()
    assert seen["armed"] is None
    assert seen["events"] == runner.schedule.events
    assert (seen["seed"], seen["records"], seen["device"]) == (7, 600,
                                                               "cpu")
    assert (report.topology, report.published, report.scored) == \
        ("obs", 7, 5)
    assert report.injected == {"mqtt.deliver:delay": 3} and report.ok


@pytest.mark.parametrize("scenario,records,rc", [
    ("dup-storm", 100, 0), ("loss-bug-fixture", 100, 1),
    ("tier-upload-crash", 100, 0), ("leader-kill-mid-drain", 100, 0)])
def test_cli_exit_status_is_the_verdict(scenario, records, rc, tmp_path,
                                        capsys):
    argv = ["run", "--scenario", scenario, "--seed", "7", "--records",
            str(records)]
    assert chaos_main(argv + ["--json"], device="cpu") == rc
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] is (rc == 0) and doc["scenario"] == scenario
    spans = str(tmp_path / "spans.jsonl")
    assert chaos_main(argv + ["--spans", spans], device="cpu") == rc
    out = capsys.readouterr().out
    assert f"verdict: {'PASS' if rc == 0 else 'FAIL'}" in out
    assert "stage latency (obs.tracing breakdown" in out
    if doc["topology"] == "wire":
        assert "(no spans: wire topology" in out
    else:
        assert f"span log: {spans}" in out


def test_same_seed_same_verdict(tmp_path):
    a = ChaosRunner("mqtt-flap", seed=5, records=75,
                    span_path=str(tmp_path / "a.jsonl"), device="cpu").run()
    b = ChaosRunner("mqtt-flap", seed=5, records=75,
                    span_path=str(tmp_path / "b.jsonl"), device="cpu").run()
    assert _summary(a) == _summary(b) and a.ok


def test_runner_restores_tracing_state(tmp_path):
    before = (tracing.ENABLED, tracing._SAMPLE, tracing._PATH)
    ChaosRunner("dup-storm", records=50, span_path=str(tmp_path / "s"),
                device="cpu").run()
    assert (tracing.ENABLED, tracing._SAMPLE, tracing._PATH) == before
