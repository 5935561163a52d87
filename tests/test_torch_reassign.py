"""Online shard reassignment (``iotml_torch.replication.reassign``, the
controller's ``add_broker`` / ``drain_broker``, the ``reassign`` drill)
and the cluster drills, held against the JAX package on the CPU.

- ``ShardReassignment``: its states, timings and report under one
  scripted clock equal JAX's, for a move, a drain and a failure.
- The controller's moves on both packages, stepped by hand: the state
  sequence each move walks, its epochs, the records it mirrored over
  RAW_FETCH, the log after it.
- The cluster cases of tests/test_replication.py run on both packages: a
  topic created after a move reaches the promoted leader, add-broker and
  drain-broker (this one over CLUSTER_ADMIN through the drained shard's
  own leader) under writes, CLUSTER_ADMIN without a controller over the
  four client × server pairs.
- The drills at seed 7: the reassign drill's and rebalance-under-chaos's
  invariant verdicts equal JAX's.

Everything is exact.  Every server binds 127.0.0.1:0; every wait has a
deadline.
"""

import contextlib
import time

import pytest

from iotml import cluster as j_cluster
from iotml.chaos.runner import ChaosRunner as JChaosRunner
from iotml.replication import drill as j_drill
from iotml.replication import reassign as j_reassign
from iotml.stream import kafka_wire as jkw
from iotml.stream.broker import Broker as JBroker
from iotml_torch import cluster as t_cluster
from iotml_torch.chaos.runner import ChaosRunner
from iotml_torch.replication import ShardReassignment
from iotml_torch.replication import drill as t_drill
from iotml_torch.replication import reassign as t_reassign
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream.broker import Broker

T = "repl-topic"
PKG = {"port": dict(c=t_cluster, kw=tkw, reassign=t_reassign,
                    Broker=Broker),
       "jax": dict(c=j_cluster, kw=jkw, reassign=j_reassign,
                   Broker=JBroker)}
KINDS = list(PKG)
PAIRS = [(c, s) for c in PKG for s in PKG]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@contextlib.contextmanager
def quorum_cluster(kind, sync="thread", parts=6):
    ctl = PKG[kind]["c"].ClusterController(
        brokers=3, replication_factor=3, min_isr=2, replica_sync=sync,
        max_lag_s=0.4)
    ctl.start()
    try:
        ctl.create_topic(T, partitions=parts)
        for i in range(3):
            if sync == "manual":
                deadline = time.monotonic() + 15
                while ctl.replica_sets[i].state.isr_size(T, i) < 3 and \
                        time.monotonic() < deadline:
                    ctl.sync_replicas_once()
            assert ctl.replica_sets[i].await_isr(3, T, i, timeout_s=15)
        yield ctl
    finally:
        ctl.stop()


# ---------------------------------------------------- the state machine
@pytest.mark.parametrize("path", ["add", "drain", "fail"])
def test_shard_reassignment_states_equal_jax(path, monkeypatch):
    reports = []
    for k in PKG.values():
        mod = k["reassign"]
        clock = _Clock()
        monkeypatch.setattr(mod.time, "monotonic", clock)
        move = mod.ShardReassignment(shard=1, old_leader="a:1",
                                     started_mono=clock())
        trail = [move.state]
        steps = {"add": [mod.CATCHING_UP, mod.IN_SYNC, mod.MOVED,
                         mod.RETIRED],
                 "drain": [mod.IN_SYNC, mod.MOVED, mod.MOVED, mod.RETIRED],
                 "fail": [mod.CATCHING_UP]}[path]
        for i, state in enumerate(steps):
            clock.t += 0.25 * (i + 1)
            move.advance(state)
            trail.append((move.state, move.catch_up_s, move.move_s))
        if path == "fail":
            move.fail("RuntimeError: no ISR")
        move.target_rid, move.raw_mirrored, move.epoch = 7, 42, 1
        reports.append((trail, move.to_dict()))
        monkeypatch.undo()
    assert reports[0] == reports[1]
    final = reports[0][1]
    assert "started_mono" not in final
    assert final["state"] == {"add": "retired", "drain": "retired",
                              "fail": "failed"}[path]
    if path == "add":
        assert (final["catch_up_s"], final["move_s"]) == (0.75, 1.5)
    assert ShardReassignment is t_reassign.ShardReassignment
    assert [getattr(t_reassign, n) for n in (
        "BOOTSTRAPPING", "CATCHING_UP", "IN_SYNC", "MOVED", "RETIRED",
        "FAILED")] == [getattr(j_reassign, n) for n in (
            "BOOTSTRAPPING", "CATCHING_UP", "IN_SYNC", "MOVED", "RETIRED",
            "FAILED")]


def _moves(kind, monkeypatch):
    """add-broker on shard 1 and drain-broker on shard 2, stepped by hand:
    each move's state walk and report, the map after, the logs."""
    mod = PKG[kind]["reassign"]
    walked = []
    real = mod.ShardReassignment.advance

    def advance(self, state):
        walked.append((self.shard, state))
        return real(self, state)

    monkeypatch.setattr(mod.ShardReassignment, "advance", advance)
    with quorum_cluster(kind, sync="manual") as ctl:
        client = ctl.client(client_id="moves")
        for p in range(6):
            client.produce_many(T, [(None, f"{p}-{i}".encode(), i)
                                    for i in range(20)], partition=p,
                                acks=1)
        while ctl.sync_replicas_once() > 0:
            pass  # the quorum HWM covers the acks=1 writes
        add = ctl.add_broker(shard=1)
        drain = ctl.drain_broker(shard=2)
        time.sleep(0.4)  # the retirements run 0.25 s after each move
        for _ in range(3):
            ctl.sync_replicas_once()  # the survivors re-point and re-admit
        logs = {p: [m.value for m in client.fetch(T, p, 0, 100)]
                for p in range(6)}
        client.close()
        after = ([ctl.pmap.epoch(i) for i in range(3)],
                 [ctl.servers[i].retiring for i in range(3)])
    monkeypatch.undo()
    keep = ("shard", "state", "epoch", "records_mirrored", "raw_mirrored",
            "error")
    return (walked, {k: add[k] for k in keep}, {k: drain[k] for k in keep},
            after, logs)


def test_add_and_drain_broker_walk_equal_jax(monkeypatch):
    got, want = _moves("port", monkeypatch), _moves("jax", monkeypatch)
    assert got == want
    walked, add, drain, (epochs, retiring), logs = got
    assert walked == [(1, "catching_up"), (1, "in_sync"), (1, "moved"),
                      (1, "retired"), (2, "in_sync"), (2, "moved"),
                      (2, "retired")]
    assert add["state"] == drain["state"] == "retired"
    assert add["raw_mirrored"] == add["records_mirrored"] == 40 > 0
    assert epochs == [0, 1, 1] and retiring == [False, False, False]
    assert all(logs[p] == [f"{p}-{i}".encode() for i in range(20)]
               for p in range(6))


# -------------------------------- tests/test_replication.py's cluster cases
@pytest.mark.parametrize("kind", KINDS)
def test_cluster_topics_created_after_move_reach_the_new_leader(kind):
    with quorum_cluster(kind, parts=3) as ctl:
        ctl.drain_broker(shard=1)
        ctl.create_topic("late-topic", partitions=3)
        client = ctl.client(client_id="late-topic-client")
        try:
            for _ in range(5):
                try:
                    client.produce("late-topic", b"x", partition=1)
                    break
                except ConnectionError:
                    time.sleep(0.2)
            assert len(client.fetch("late-topic", 1, 0, 10)) == 1
        finally:
            client.close()


@pytest.mark.parametrize("kind", KINDS)
def test_cluster_quorum_mode_add_and_drain_under_writes(kind):
    k = PKG[kind]
    with quorum_cluster(kind) as ctl:
        client = ctl.client(client_id="test-elastic")
        try:
            for p in range(6):
                client.produce(T, f"pre-{p}".encode(), partition=p)
            rep = ctl.add_broker(shard=1)
            assert rep["state"] == "retired" and rep["raw_mirrored"] > 0
            assert ctl.pmap.epoch(1) == 1
            # the drain through the drained shard's own leader: the
            # deferred retirement flushes the admin response first
            wire = k["kw"].KafkaWireBroker(ctl.pmap.leader(2))
            drain = wire.cluster_admin("drain-broker", {"shard": 2})
            wire.close()
            assert drain["state"] == "retired"
            for i in (1, 2):
                assert ctl.replica_sets[i].state.await_isr(
                    2, T, i, timeout_s=15), f"shard {i} ISR never re-formed"
            for p in range(6):
                for attempt in range(5):
                    try:
                        client.produce(T, f"post-{p}".encode(), partition=p)
                        break
                    except ConnectionError:
                        if attempt == 4:
                            raise
                        time.sleep(0.1)
            assert sum(len(client.fetch(T, p, 0, 100))
                       for p in range(6)) == 12
        finally:
            client.close()


@pytest.mark.parametrize("kind", KINDS)
def test_drain_promotes_a_leader_holding_the_old_leaders_log(kind):
    """Records the shard's leader took but its followers have not
    mirrored yet (acks=1, the followers stepped by hand and in the ISR
    within a 30 s staleness window): the port's drain steps the leader
    down, mirrors the target to the leader's end and only then promotes
    it, so the new leader holds every record; JAX's promotes the lagging
    follower at once and they are gone (ROADMAP §C)."""
    ctl = PKG[kind]["c"].ClusterController(
        brokers=3, replication_factor=3, min_isr=2, replica_sync="manual",
        max_lag_s=30.0)
    ctl.start()
    client = None
    try:
        ctl.create_topic(T, partitions=3)
        deadline = time.monotonic() + 15
        while ctl.replica_sets[1].state.isr_size(T, 1) < 3:
            assert time.monotonic() < deadline, "ISR never formed"
            ctl.sync_replicas_once()
        client = ctl.client(client_id="test-drain-lag")
        client.produce_many(T, [(None, b"lag-%d" % i, 0) for i in range(50)],
                            partition=1, acks=1)
        old_end = ctl.brokers[1].end_offset(T, 1)
        assert old_end == 50
        assert ctl.drain_broker(shard=1)["state"] == "retired"
        new_end = ctl.brokers[1].end_offset(T, 1)
        if kind == "port":
            assert new_end == old_end
            assert [m.value for m in ctl.brokers[1].fetch(T, 1, 0, 100)] \
                == [b"lag-%d" % i for i in range(50)]
        else:
            assert new_end < old_end
    finally:
        if client is not None:
            client.close()
        ctl.stop()


@pytest.mark.parametrize("cli,srv", PAIRS)
def test_cluster_admin_unsupported_without_controller(cli, srv):
    broker = PKG[srv]["Broker"]()
    server = PKG[srv]["kw"].KafkaWireServer(broker).start()
    try:
        client = PKG[cli]["kw"].KafkaWireBroker(f"127.0.0.1:{server.port}")
        with pytest.raises(NotImplementedError):
            client.cluster_admin("status")
        # the connection survives the refusal
        assert client.api_versions()
        client.close()
    finally:
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------- drills
def test_reassign_drill_verdicts_equal_jax():
    got = t_drill.drill_reassign(seed=7)
    want = j_drill.drill_reassign(seed=7)
    assert [(i.name, i.ok) for i in got.invariants] == \
        [(i.name, i.ok) for i in want.invariants]
    assert got.ok and want.ok, "\n".join(got.lines() + want.lines())
    assert sorted(got.slos) == sorted(want.slos) == \
        ["catch_up_s", "consumer_max_stall_s", "move_s"]
    assert got.drill == "reassign" and got.published >= 1500


def test_rebalance_drill_verdicts_equal_jax():
    got = ChaosRunner("rebalance-under-chaos", seed=7, records=2000).run()
    want = JChaosRunner("rebalance-under-chaos", seed=7, records=2000).run()
    assert [(i.name, i.ok) for i in got.invariants] == \
        [(i.name, i.ok) for i in want.invariants]
    assert got.ok and want.ok
    assert (got.published, got.scored, got.injected,
            got.dropped_accounted) == \
        (want.published, want.scored, want.injected, want.dropped_accounted)
