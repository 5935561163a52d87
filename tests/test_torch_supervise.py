"""The port's supervisor (``iotml_torch.supervise.supervisor``) against the
JAX package's, on the CPU.

The scripts of the JAX tests (``tests/test_supervise.py``: a crash and
its restart, a restart storm given up as degraded, a wedged unit replaced,
``on_death`` fired once, a probed unit restarted, a clean stop, a loop
returning normally) run on both packages without the monitor thread: the
test drives ``_tick_unit`` itself on a scripted clock, waits for each
spawned incarnation to crash or to reach its steady loop before the next
tick, and draws the backoff's jitter from a seeded generator.  The unit
states, restart counts, errors and backoff deadlines after every tick and
the ``iotml_supervisor_*`` counter deltas are equal.  Then the live
supervisor (its monitor thread on) fills ``supervise.registry.snapshot``
and ``/healthz``, as JAX's does.

The failover half (tests/test_supervise.py's topology, epoch fencing,
replica promote, pause/resume and lag-gauge cases, and its live drills)
runs on the port: the ``Topology`` cell's resolve sequences equal JAX's,
a stale client and a resurrected old leader are fenced, a client
re-resolves its topology after a fence, a follower is fenced until
promoted.  The four live drills (leader-kill, broker-restart, mqtt-flap,
scorer-crash) run on the CPU at seed 7, their invariant verdicts equal
JAX's drills' (SLO times are not compared), and the CLI's ``list`` and
unknown-drill answers equal JAX's.

Tolerance: none; every comparison is exact.
"""

import random
import threading
import time

import pytest

from iotml.obs import metrics as j_metrics
from iotml.supervise import drill as j_drill
from iotml.supervise import supervisor as j_sup
from iotml.supervise.__main__ import main as j_sup_main
from iotml.supervise.topology import Topology as JTopology
from iotml.utils.backoff import ExpBackoff as JBackoff
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.kafka_wire import (FencedEpochError, KafkaWireBroker,
                                           KafkaWireServer)
from iotml_torch.stream.replica import FollowerReplica
from iotml_torch.supervise import drill as t_drill
from iotml_torch.supervise import registry
from iotml_torch.supervise import supervisor as t_sup
from iotml_torch.supervise.__main__ import main as sup_main
from iotml_torch.supervise.topology import Topology
from iotml_torch.utils.backoff import ExpBackoff as TBackoff

PACKAGES = {"torch": (t_sup, t_metrics, TBackoff),
            "jax": (j_sup, j_metrics, JBackoff)}


def _settle(unit, steady: threading.Event, timeout_s: float = 10.0):
    """Wait until the unit's newest incarnation has died or reached its
    steady loop (so the next tick sees a decided state)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        th = unit._thread
        if th is None or not th.is_alive() or steady.is_set():
            return
        time.sleep(0.001)
    raise AssertionError(f"unit {unit.name} never settled")


def _counters(metrics, name):
    return {"restarts": metrics.supervisor_restarts.value(unit=name),
            "wedged": metrics.supervisor_wedged.value(unit=name),
            "failovers": metrics.supervisor_failovers.value(unit=name),
            "degraded": metrics.supervisor_degraded.value(unit=name),
            "up": metrics.supervisor_unit_up.value(unit=name)}


def _run(pkg: str, script: str):
    mod, metrics, Backoff = PACKAGES[pkg]
    name = f"script-{script}"
    sup = mod.Supervisor(poll_interval_s=1.0, name=f"sup-{script}")
    steady, wedge = threading.Event(), threading.Event()
    runs, fired = [], []
    alive = {"ok": True}
    backoff = Backoff(base_s=0.05, cap_s=2.0, rng=random.Random(7))
    kw = {"backoff": backoff}

    def steady_loop(unit):
        steady.set()
        while not unit.should_stop():
            unit.heartbeat()
            unit._stop.wait(0.01)

    if script == "crash":
        def loop(unit):
            runs.append(1)
            if len(runs) <= 2:
                raise RuntimeError(f"incarnation {len(runs)} dies")
            steady_loop(unit)
        u = sup.add_loop(name, loop, **kw)
    elif script == "storm":
        def loop(unit):
            runs.append(1)
            raise RuntimeError("always dies")
        u = sup.add_loop(name, loop, max_restarts=3, restart_window_s=300.0,
                         **kw)
    elif script == "wedge":
        def loop(unit):
            runs.append(1)
            unit.heartbeat()
            if len(runs) == 1:
                steady.set()
                while not unit.should_stop():  # alive and silent
                    wedge.wait(0.01)
                return
            steady_loop(unit)
        u = sup.add_loop(name, loop, heartbeat_timeout_s=5.0, **kw)
    elif script == "finite":
        u = sup.add_loop(name, lambda unit: unit.heartbeat(), **kw)
    elif script == "on_death":
        u = sup.add_probed(name, lambda: alive["ok"], on_death=fired.append,
                           probe_failures=2, **kw)
    elif script == "probe_restart":
        def restart():
            runs.append(1)
            alive["ok"] = True
        u = sup.add_probed(name, lambda: alive["ok"], restart=restart,
                           probe_failures=2, **kw)
    else:
        raise AssertionError(script)

    before = _counters(metrics, name)
    trace = []
    # a probed unit's restart is stamped on the real clock: the scripted
    # clock starts there, and only a loop unit's deadline is compared
    base = time.monotonic()

    def tick(now):
        sup._tick_unit(u, now)
        _settle(u, steady)
        trace.append((u.state, u.restarts, u.last_error,
                      round(u._next_start_at - base, 9)
                      if u.state == mod.WAITING and u.loop is not None
                      else None,
                      u.backoff.attempt))

    try:
        if u.loop is not None:
            u._spawn()  # what start() does, without the monitor
            _settle(u, steady)
        else:
            u.state = mod.RUNNING
        if script == "wedge":
            now = base
            tick(now)                  # fresh heartbeat: running
            steady.clear()
            tick(now + 100.0)          # silent past its timeout: wedged
            tick(now + 200.0)          # the backoff passed: replaced
            tick(time.monotonic())     # the new incarnation beats
        elif script in ("on_death", "probe_restart"):
            for k in range(7):
                if k == 2:
                    alive["ok"] = False
                tick(base + 10.0 * k)
        else:
            for k in range(8):
                tick(base + 10.0 * k)
    finally:
        wedge.set()
        sup.stop(join_timeout_s=5.0)
    after = _counters(metrics, name)
    delta = {k: after[k] - before[k] for k in after}
    return {"trace": trace, "final": u.state, "runs": len(runs),
            "fired": [f.name for f in fired], "delta": delta}


@pytest.mark.parametrize("script", ["crash", "storm", "wedge", "finite",
                                    "on_death", "probe_restart"])
def test_scripted_sequences_equal_jax(script):
    got, want = _run("torch", script), _run("jax", script)
    assert got == want
    expect = {"crash": ("running", 2), "storm": ("degraded", 3),
              "wedge": ("running", 1), "finite": ("stopped", 0),
              "on_death": ("failed_over", 0),
              "probe_restart": ("running", 1)}[script]
    last = got["trace"][-1]
    assert (last[0], last[1]) == expect
    if script == "on_death":
        assert got["fired"] == [f"script-{script}"]
        assert got["delta"]["failovers"] == 1
    if script == "storm":
        assert got["delta"]["degraded"] == 1 and got["runs"] == 4
    if script == "wedge":
        assert got["delta"]["wedged"] == 1


def test_unit_states_and_constructor_checks_equal_jax():
    for name in ("IDLE", "RUNNING", "CRASHED", "WAITING", "DEGRADED",
                 "FAILED_OVER", "STOPPED"):
        assert getattr(t_sup, name) == getattr(j_sup, name)
    for mod in (t_sup, j_sup):
        with pytest.raises(ValueError, match="exactly one of"):
            mod.SupervisedUnit("x")
        sup = mod.Supervisor(poll_interval_s=1.0)
        sup.add_loop("dup", lambda u: None)
        with pytest.raises(ValueError, match="duplicate unit"):
            sup.add_loop("dup", lambda u: None)


def test_env_knobs_read_at_construction(monkeypatch):
    monkeypatch.setenv("IOTML_SUPERVISE_MAX_RESTARTS", "9")
    monkeypatch.setenv("IOTML_SUPERVISE_POLL_S", "0.25")
    for mod in (t_sup, j_sup):
        assert mod.SupervisedUnit("u", lambda u: None).max_restarts == 9
        assert mod.Supervisor().poll_interval_s == 0.25


def test_live_supervisor_fills_the_registry_and_healthz():
    """With its monitor on, a degraded unit reaches
    ``registry.snapshot()`` and turns ``/healthz`` degraded; stop()
    unregisters the supervisor."""
    def loop(unit):
        raise RuntimeError("always dies")

    sup = t_sup.Supervisor(poll_interval_s=0.01, name="torch-live-sup")
    u = sup.add_loop("torch-doomed", loop, max_restarts=2,
                     restart_window_s=30.0,
                     backoff=TBackoff(base_s=0.01, cap_s=0.02))
    sup.start()
    try:
        deadline = time.monotonic() + 10
        while u.state != t_sup.DEGRADED and time.monotonic() < deadline:
            time.sleep(0.01)
        assert u.state == t_sup.DEGRADED and u.restarts == 2
        snap = registry.snapshot()
        assert snap["torch-doomed"]["state"] == "degraded"
        doc = t_metrics._healthz_doc()
        assert doc["status"] == "degraded"
        assert doc["supervisor"]["torch-doomed"]["restarts"] == 2
        assert sup.degraded() == ["torch-doomed"]
        assert any(t.name == "iotml-torch-live-sup"
                   for t in registry.threads())
    finally:
        sup.stop()
    assert "torch-doomed" not in registry.snapshot()


# ------------------------------------------------------------- topology
def test_topology_publish_monotonic_and_resolve_order():
    topo = Topology("a:1", epoch=0, fallback=["b:2"])
    assert topo.resolve() == (["a:1", "b:2"], 0)
    topo.publish("b:2", 1)
    servers, epoch = topo.resolve()
    assert servers[0] == "b:2" and "a:1" in servers and epoch == 1
    with pytest.raises(ValueError):
        topo.publish("a:1", 0)  # epochs only move forward


def test_topology_sequences_equal_jax():
    script = [("publish", "b:2", 1), ("publish", "b:2", 1),
              ("fallback", "a:1", "c:3"), ("publish", "c:3", 4),
              ("fallback", None, "d:4"), ("fallback", "d:4", "c:3"),
              ("publish", "a:1", 9), ("publish", "z:0", 3)]
    runs = []
    for cls in (Topology, JTopology):
        topo = cls("a:1", epoch=0, fallback=["a:1", "b:2"])
        out = [topo.resolve()]
        for op in script:
            try:
                if op[0] == "publish":
                    topo.publish(op[1], op[2])
                else:
                    topo.replace_fallback(op[1], op[2])
                out.append((topo.resolve(), topo.leader, topo.epoch,
                            topo.generation))
            except ValueError as e:
                out.append(str(e))
        runs.append(out)
    assert runs[0] == runs[1]


# -------------------------------------------------------- epoch fencing
def _wire_pair(epoch=0):
    broker = Broker()
    broker.create_topic("T", partitions=1)
    srv = KafkaWireServer(broker, epoch=epoch).start()
    return broker, srv


def test_stale_client_is_fenced_on_produce_and_commit():
    broker, srv = _wire_pair(epoch=2)
    try:
        stale = KafkaWireBroker(f"127.0.0.1:{srv.port}", epoch=1)
        with pytest.raises(FencedEpochError):
            stale.produce("T", b"x")
        with pytest.raises(FencedEpochError):
            stale.commit("g", "T", 0, 5)
        assert broker.end_offset("T", 0) == 0
        assert broker.committed("g", "T", 0) is None
        assert stale.end_offset("T", 0) == 0  # reads stay open
        legacy = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        legacy.produce("T", b"y")  # unstamped: unfenced
        assert broker.end_offset("T", 0) == 1
        legacy.close()
        stale.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_resurrected_old_leader_is_fenced():
    broker, srv = _wire_pair(epoch=0)
    try:
        current = KafkaWireBroker(f"127.0.0.1:{srv.port}", epoch=1)
        with pytest.raises(FencedEpochError):
            current.produce("T", b"split-brain")
        assert broker.end_offset("T", 0) == 0
        current.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_client_reresolves_topology_after_fence():
    broker_a, srv_a = _wire_pair(epoch=0)
    broker_b, srv_b = _wire_pair(epoch=1)
    topo = Topology(f"127.0.0.1:{srv_a.port}", epoch=0,
                    fallback=[f"127.0.0.1:{srv_b.port}"])
    try:
        client = KafkaWireBroker(f"127.0.0.1:{srv_a.port}", topology=topo)
        client.produce("T", b"term0")
        assert broker_a.end_offset("T", 0) == 1
        topo.publish(f"127.0.0.1:{srv_b.port}", 1)
        srv_a.set_epoch(2)
        with pytest.raises(FencedEpochError):
            client.produce("T", b"stale")
        client.produce("T", b"term1")  # the same client, now on B
        assert broker_b.end_offset("T", 0) == 1
        assert client.epoch == 1
        client.close()
    finally:
        for s in (srv_a, srv_b):
            s.shutdown()
            s.server_close()


# ------------------------------------------------- replica promote/pause
def test_follower_fenced_until_promoted_then_serves():
    leader = Broker()
    leader.create_topic("T")
    for i in range(5):
        leader.produce("T", f"m{i}".encode())
    lsrv = KafkaWireServer(leader).start()
    rep = FollowerReplica(f"127.0.0.1:{lsrv.port}", topics=["T"])
    rep.server.start()
    try:
        while rep.sync_once() > 0:
            pass
        stamped = KafkaWireBroker(f"127.0.0.1:{rep.port}", epoch=0)
        with pytest.raises(FencedEpochError):
            stamped.produce("T", b"fork")  # not a leader before promotion
        addr = rep.promote(3)
        assert rep.promoted and addr.endswith(f":{rep.port}")
        assert t_metrics.failover_epoch.value() == 3
        promoted_client = KafkaWireBroker(f"127.0.0.1:{rep.port}", epoch=3)
        assert promoted_client.produce("T", b"post-failover") == 5
        with pytest.raises(RuntimeError):
            rep.promote(4)  # promotion is once
        promoted_client.close()
        stamped.close()
    finally:
        rep.server.shutdown()
        rep.server.server_close()
        lsrv.shutdown()
        lsrv.server_close()


def test_pause_resume_is_a_real_barrier():
    leader = Broker()
    leader.create_topic("T")
    leader.produce("T", b"a")
    lsrv = KafkaWireServer(leader).start()
    rep = FollowerReplica(f"127.0.0.1:{lsrv.port}", topics=["T"],
                          poll_interval_s=0.005).start()
    try:
        assert rep.caught_up(timeout_s=10)
        assert rep.pause()
        rounds = rep.rounds
        leader.produce("T", b"b")
        time.sleep(0.1)
        assert rep.rounds == rounds  # parked: no round ran
        assert rep.local.end_offset("T", 0) == 1
        rep.sync_once()
        assert rep.local.end_offset("T", 0) == 2
        rep.resume()
        leader.produce("T", b"c")
        deadline = time.monotonic() + 10
        while rep.local.end_offset("T", 0) != 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert rep.local.end_offset("T", 0) == 3
    finally:
        rep.stop()
        lsrv.shutdown()
        lsrv.server_close()


def test_replica_lag_gauge_is_live():
    leader = Broker()
    leader.create_topic("lagT")
    for _ in range(7):
        leader.produce("lagT", b"x")
    lsrv = KafkaWireServer(leader).start()
    rep = FollowerReplica(f"127.0.0.1:{lsrv.port}", topics=["lagT"],
                          poll_interval_s=0.005, commit_interval_s=0.01)
    try:
        rep.sync_once()
        assert rep.lag() == {"lagT": 0}
        assert t_metrics.replica_lag.value(topic="lagT") == 0
        leader.produce("lagT", b"y")
        assert rep.lag() == {"lagT": 1}
        assert t_metrics.replica_lag.value(topic="lagT") == 1
        assert t_metrics._healthz_doc()["replica_lag_records"]["lagT"] == 1
        rep.start()  # the background loop probes the gauge itself
        deadline = time.monotonic() + 10
        while t_metrics.replica_lag.value(topic="lagT") != 0 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        assert t_metrics.replica_lag.value(topic="lagT") == 0
    finally:
        rep.stop()
        lsrv.shutdown()
        lsrv.server_close()


# ---------------------------------------------------------- live drills
def test_live_drill_scorer_crash_heals():
    report = t_drill.drill_scorer_crash(seed=11, records=300, device="cpu")
    assert report.ok, "\n".join(report.lines())
    assert report.restarts["scorer"] >= 1
    assert report.scored >= report.published


def test_live_drill_leader_kill_promotes_and_fences():
    report = t_drill.drill_leader_kill(seed=5, records=400, device="cpu")
    assert report.ok, "\n".join(report.lines())
    by_name = {i.name: i for i in report.invariants}
    assert by_name["old_leader_fenced"].ok
    assert by_name["promotion_loss_bounded"].ok
    assert report.slos["time_to_promote_s"] is not None
    assert report.slos["time_to_promote_s"] <= 10.0


@pytest.mark.parametrize("name", ["leader-kill", "broker-restart",
                                  "mqtt-flap", "scorer-crash"])
def test_drill_verdicts_equal_jax_at_seed_7(name):
    got = t_drill.DRILLS[name](seed=7, device="cpu")
    want = j_drill.DRILLS[name](seed=7)
    want_v = [(i.name, i.ok) for i in want.invariants]
    if name == "broker-restart":
        # JAX's scorer loop keeps the outputs of the rows it rewinds over:
        # on a loaded host a flush whose response the killed broker lost
        # lands twice more and its predictions_bounded_gap_free fails
        # (2 of 36 runs at six drills at once; the port's 0 of 36).  The
        # port's loop drops them (OutputSequence.discard): that verdict
        # is held on the port alone.
        assert [n for n, ok in want_v if not ok] in \
            ([], ["predictions_bounded_gap_free"]), "\n".join(want.lines())
        want_v = [(n, True) if n == "predictions_bounded_gap_free"
                  else (n, ok) for n, ok in want_v]
    else:
        assert want.ok, "\n".join(want.lines())
    assert [(i.name, i.ok) for i in got.invariants] == want_v
    assert got.ok, "\n".join(got.lines())
    assert (got.drill, got.seed, got.records, sorted(got.slos)) == \
        (want.drill, want.seed, want.records, sorted(want.slos))
    assert got.published == want.published
    if name == "mqtt-flap":
        # its seeded schedule fires a message at a time: the same faults
        # (scorer-crash's hits accrue with idle polls, at wall-clock speed)
        assert got.injected == want.injected


def test_drill_cli_list_and_unknown(capsys):
    assert sup_main(["list"]) == 0
    out = capsys.readouterr().out
    assert j_sup_main(["list"]) == 0
    assert capsys.readouterr().out == out
    for name in ("leader-kill", "broker-restart", "mqtt-flap",
                 "scorer-crash"):
        assert name in out
    assert sup_main(["drill", "--drill", "no-such-drill"]) == \
        j_sup_main(["drill", "--drill", "no-such-drill"]) == 2
    assert sup_main([]) == j_sup_main([]) == 2
