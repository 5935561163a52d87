"""Quorum ISR durability (``iotml_torch.replication``, the replica leg and
quorum acks of ``stream/kafka_wire.py``, the broker's quorum ceiling,
``ops/framing.truncate_frame_batch`` and ``store/hwm.py``) held against
the JAX package on the CPU.

- The JAX suite's own cases (tests/test_replication.py, all but the
  cluster ones) run on the port: ISR admission, the quorum HWM, eviction
  and re-admission, acks=all at the quorum with errors 19, 7 and 21, the
  consumer read barrier on every read path, ISR-restricted election,
  survivors re-joining after a promotion, the HWM across a remount, a
  follower bootstrapped over RAW_FETCH, the gauges and ``/healthz``.
- Parity: ISR, quorum-HWM and eviction sequences on a scripted clock;
  ``wait_replicated`` outcomes; HWM file bytes (a remount, a torn file);
  ``truncate_frame_batch``; request and response bytes of FETCH and
  RAW_FETCH with a replica id and of acks=-1 PRODUCE and RAW_PRODUCE,
  errors 19, 21 and 74 among them; acks=all, fencing and the replica leg
  over the four client × server pairs; election and promotion; the
  double-fault drill's verdicts at seed 7.
- The cardata job from a promoted replica: the port CLI's fit bit-equal
  to its fit from the leader before the kill, and the fit from the
  promoted log against JAX's from the same converted params.

Tolerances: everything is exact (bytes, offsets, sets, counts, verdicts)
but the fit against JAX: losses rtol 2e-4 / atol 1e-6, params rtol 5e-3 /
atol 2e-5 (the JAX suite's fit bounds, tests/test_fused_train.py).  Every
server binds 127.0.0.1:0; every wait has a deadline.
"""

import contextlib
import json
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.obs import metrics as j_metrics
from iotml.ops import framing as j_framing
from iotml.replication import ReplicaSet as JReplicaSet
from iotml.replication import ReplicationState as JReplicationState
from iotml.replication import drill as j_drill
from iotml.replication import isr as j_isr
from iotml.store import hwm as j_hwm
from iotml.stream import kafka_wire as jkw
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.replica import FollowerReplica as JFollowerReplica
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.cli import _app as t_app
from iotml_torch.cli import cardata
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.ops import framing as t_framing
from iotml_torch.replication import ReplicaSet, ReplicationState
from iotml_torch.replication import drill as t_drill
from iotml_torch.replication import isr as t_isr
from iotml_torch.replication.__main__ import main as repl_main
from iotml_torch.store import hwm as t_hwm
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.replica import FollowerReplica
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.loop import Trainer, TrainState

T = "repl-topic"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
PKG = {"port": dict(Broker=Broker, ReplicaSet=ReplicaSet,
                    ReplicationState=ReplicationState, kw=tkw,
                    isr=t_isr, hwm=t_hwm, framing=t_framing,
                    metrics=t_metrics, Follower=FollowerReplica),
       "jax": dict(Broker=JBroker, ReplicaSet=JReplicaSet,
                   ReplicationState=JReplicationState, kw=jkw,
                   isr=j_isr, hwm=j_hwm, framing=j_framing,
                   metrics=j_metrics, Follower=JFollowerReplica)}
PAIRS = [(c, s) for c in PKG for s in PKG]


def _leader_with_set(n_followers=2, min_isr=2, max_lag_s=0.3,
                     partitions=1, groups=(), hwm_file=None,
                     store_dir=None, kind="port"):
    k = PKG[kind]
    leader = k["Broker"](store_dir=store_dir)
    leader.create_topic(T, partitions=partitions)
    srv = k["kw"].KafkaWireServer(leader).start()
    rs = k["ReplicaSet"](leader_broker=leader, leader_server=srv,
                         n_followers=n_followers, min_isr=min_isr,
                         max_lag_s=max_lag_s, topics=[T], groups=groups,
                         hwm_file=hwm_file)
    rs.start(sync="manual")
    return leader, srv, rs


def _teardown(srv, rs, *clients):
    for c in clients:
        try:
            c.close()
        except OSError:
            pass
    rs.stop()
    try:
        srv.shutdown()
        srv.server_close()
    except OSError:
        pass


def _form_isr(rs, partitions=1, width=None):
    want = width if width is not None else 1 + len(rs.followers)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        rs.sync_once()
        if all(rs.state.isr_size(T, p) >= want
               for p in range(partitions)):
            return
    raise AssertionError(
        f"ISR never formed: {rs.state.isr_size(T, 0)} < {want}")


def _stepped(rs, call, timeout_s=10.0):
    """Run ``call`` (an acks=all produce, which blocks a server handler
    until the quorum covers it) on a worker while this thread steps the
    manually synced followers; its result, or its exception raised."""
    result = {}

    def attempt():
        try:
            result["v"] = call()
        except Exception as e:  # noqa: BLE001 - surfaced to the test
            result["err"] = e

    t = threading.Thread(target=attempt, daemon=True,
                         name="iotml-test-quorum-produce")
    t.start()
    deadline = time.monotonic() + timeout_s
    while t.is_alive() and time.monotonic() < deadline:
        rs.sync_once()
        time.sleep(0.002)
    t.join(1.0)
    if "err" in result:
        raise result["err"]
    assert "v" in result, "quorum produce never resolved"
    return result["v"]


def _quorum_produce(client, rs, values, partition=0):
    return _stepped(rs, lambda: client.produce_many(
        T, [(None, v, 0) for v in values], partition=partition))


# ---------------------------------------------- the JAX suite, on the port
def test_isr_admission_requires_catch_up():
    broker = Broker()
    broker.create_topic(T)
    broker.produce_batch(T, [b"a", b"b", b"c"], partition=0)
    state = ReplicationState(broker, follower_ids=(1,), min_isr=2)
    assert state.isr_size(T, 0) == 1  # registered, never fetched
    state.observe_fetch(1, T, 0, 1)   # progress, not membership
    assert state.isr_size(T, 0) == 1
    state.observe_fetch(1, T, 0, 3)   # the log end admits
    assert state.isr_size(T, 0) == 2
    assert state.isr_follower_ids() == {1}


def test_quorum_hwm_is_min_over_isr_and_monotone():
    broker = Broker()
    broker.create_topic(T)
    state = ReplicationState(broker, follower_ids=(1, 2), min_isr=2,
                             max_lag_s=30.0)
    broker.produce_batch(T, [b"a", b"b"], partition=0)
    assert state.quorum_hwm(T, 0) == 2  # anchored at the end at first touch
    state.observe_fetch(1, T, 0, 2)
    state.observe_fetch(2, T, 0, 2)
    broker.produce_batch(T, [b"c", b"d"], partition=0)
    state.observe_fetch(1, T, 0, 3)
    state.observe_fetch(2, T, 0, 4)
    assert state.quorum_hwm(T, 0) == 3
    assert state.fetch_ceiling(T, 0) == 3
    state.observe_fetch(1, T, 0, 4)
    assert state.quorum_hwm(T, 0) == 4


def test_staleness_eviction_and_readmission():
    broker = Broker()
    broker.create_topic(T)
    state = ReplicationState(broker, follower_ids=(1,), min_isr=1,
                             max_lag_s=0.1)
    broker.produce_batch(T, [b"a"], partition=0)
    state.observe_fetch(1, T, 0, 1)
    assert state.isr_size(T, 0) == 2
    broker.produce_batch(T, [b"b"], partition=0)
    time.sleep(0.15)
    state.evict_stale()
    assert state.isr_size(T, 0) == 1
    assert state.quorum_hwm(T, 0) == 2  # past the evicted laggard
    state.observe_fetch(1, T, 0, 2)
    assert state.isr_size(T, 0) == 2


def test_unregister_advances_quorum():
    broker = Broker()
    broker.create_topic(T)
    state = ReplicationState(broker, follower_ids=(1, 2), min_isr=1,
                             max_lag_s=30.0)
    state.observe_fetch(1, T, 0, 0)
    state.observe_fetch(2, T, 0, 0)
    broker.produce_batch(T, [b"a", b"b"], partition=0)
    state.observe_fetch(2, T, 0, 2)
    assert state.quorum_hwm(T, 0) == 0
    state.unregister_follower(1)
    assert state.quorum_hwm(T, 0) == 2
    assert state.follower_ids == (2,)


def test_acks_all_without_replication_is_leader_ack():
    broker = Broker()
    broker.create_topic(T)
    with tkw.KafkaWireServer(broker) as srv:
        client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
        assert client.produce_many(T, [(None, b"v", 0)], partition=0) == 0
        client.close()


def test_acks_all_rejected_below_min_isr_nothing_appended():
    leader, srv, rs = _leader_with_set()
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        with pytest.raises(tkw.NotEnoughReplicasError):
            client.produce_many(T, [(None, b"v", 0)], partition=0)
        assert leader.end_offset(T, 0) == 0
        assert client.produce_many(T, [(None, b"v1", 0)], partition=0,
                                   acks=1) == 0
        assert client.produce_many(T, [(None, b"v0", 0)], partition=0,
                                   acks=0) == -1  # masked
        assert leader.end_offset(T, 0) == 2
    finally:
        _teardown(srv, rs, client)


def test_invalid_required_acks_is_error_21():
    leader, srv, rs = _leader_with_set()
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        with pytest.raises(ValueError, match="required_acks"):
            client.produce_many(T, [(None, b"v", 0)], partition=0, acks=5)
        with pytest.raises(ValueError, match="required_acks"):
            client.produce_raw(T, 0, t_framing.frame_entries(
                [(None, b"r", 0)], 0), acks=2)
        assert leader.end_offset(T, 0) == 0
    finally:
        _teardown(srv, rs, client)


def test_acks_all_commits_at_quorum_and_times_out_honestly():
    leader, srv, rs = _leader_with_set(max_lag_s=30.0)  # no eviction
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        assert _quorum_produce(client, rs, [b"q0", b"q1"]) == 1
        rs.kill_follower(sorted(rs.followers)[0])
        with pytest.raises(tkw.ProduceTimedOutError):
            client.produce_many(T, [(None, b"stall", 0)], partition=0,
                                timeout_ms=300)
        assert leader.end_offset(T, 0) == 3  # appended, above the hwm
        assert rs.state.quorum_hwm(T, 0) == 2
    finally:
        _teardown(srv, rs, client)


@pytest.mark.parametrize("api", ["produce", "raw"])
@pytest.mark.parametrize("srv_kind", list(PKG))
def test_acks_all_reached_below_min_isr_is_error_20(srv_kind, api):
    """Both followers stop fetching while an acks=all batch waits: the
    wait's eviction scan drops them and the quorum HWM reaches the batch
    with the leader alone in the ISR.  The port's server answers
    NOT_ENOUGH_REPLICAS_AFTER_APPEND (20), appended but unacked; JAX's
    acks it below min_isr (ROADMAP §C, open in JAX)."""
    leader, srv, rs = _leader_with_set(max_lag_s=0.2, kind=srv_kind)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        if api == "produce":
            send = lambda: client.produce_many(  # noqa: E731
                T, [(None, b"lone", 0)], partition=0, timeout_ms=5000)
        else:
            send = lambda: client.produce_raw(  # noqa: E731
                T, 0, t_framing.frame_entries([(None, b"lone", 0)], 0),
                timeout_ms=5000)
        if srv_kind == "port":
            with pytest.raises(tkw.NotEnoughReplicasAfterAppendError):
                send()
        else:
            assert send() == 0
        assert leader.end_offset(T, 0) == 1  # appended either way
        assert rs.state.quorum_hwm(T, 0) == 1
        assert rs.state.isr_size(T, 0) == 1 < rs.state.min_isr
        # the next acks=all batch is refused before any append
        with pytest.raises(tkw.NotEnoughReplicasError):
            client.produce_many(T, [(None, b"next", 0)], partition=0)
        assert leader.end_offset(T, 0) == 1
    finally:
        _teardown(srv, rs, client)


def test_raw_produce_acks_all_quorum_and_rejection():
    leader, srv, rs = _leader_with_set()
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        frames = t_framing.frame_entries(
            [(None, b"raw0", 0), (None, b"raw1", 0)], 0)
        with pytest.raises(tkw.NotEnoughReplicasError):
            client.produce_raw(T, 0, frames)
        assert leader.end_offset(T, 0) == 0
        _form_isr(rs)
        assert _stepped(rs, lambda: client.produce_raw(T, 0, frames)) == 0
        more = t_framing.frame_entries([(None, b"raw2", 0)], 0)
        assert client.produce_raw(T, 0, more, acks=1) == 2
    finally:
        _teardown(srv, rs, client)


def test_consumer_fetch_bounded_by_quorum_hwm():
    leader, srv, rs = _leader_with_set(max_lag_s=30.0)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        _quorum_produce(client, rs, [b"v0", b"v1"])
        client.produce_many(T, [(None, b"tail", 0)], partition=0, acks=1)
        assert leader.end_offset(T, 0) == 3
        assert rs.state.quorum_hwm(T, 0) == 2
        assert [m.value for m in client.fetch(T, 0, 0, 100)] == \
            [b"v0", b"v1"]
        assert client.last_hwm(T, 0) == 2
        raw = client.fetch_raw(T, 0, 0)
        assert [off for off, *_ in t_framing.iter_frame_entries(
            raw.data)] == [0, 1]
        assert [m.value for m in leader.fetch(T, 0, 0, 100)] == \
            [b"v0", b"v1"]
        assert leader.fetch_raw(T, 0, 2) is None
        assert [m.value for m in leader.fetch_tail(T, 0, 0, 100)] == \
            [b"v0", b"v1", b"tail"]
        for _ in range(10):
            rs.sync_once()
        assert [m.value for m in client.fetch(T, 0, 0, 100)] == \
            [b"v0", b"v1", b"tail"]
    finally:
        _teardown(srv, rs, client)


def test_truncate_frame_batch_cuts_at_frame_boundary():
    blob = t_framing.frame_entries([(None, b"a", 0), (None, b"bb", 0),
                                    (None, b"ccc", 0)], 10)
    cut = t_framing.truncate_frame_batch(blob, 12)
    assert [(off, v) for off, _k, v, _ts, _h
            in t_framing.iter_frame_entries(cut)] == [(10, b"a"),
                                                      (11, b"bb")]
    assert t_framing.truncate_frame_batch(blob, 10) == b""
    assert t_framing.truncate_frame_batch(blob, 99) == blob


def test_election_is_isr_restricted():
    leader, srv, rs = _leader_with_set(max_lag_s=0.2)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        _quorum_produce(client, rs, [b"v0", b"v1", b"v2"])
        dead, survivor = sorted(rs.followers)[:2]
        rs.kill_follower(dead)
        # the log must GROW for the frozen follower to become stale
        client.produce_many(T, [(None, b"tail", 0)], partition=0, acks=1)
        time.sleep(0.3)
        rs.sync_once()
        rs.state.evict_stale()
        assert rs.state.isr_follower_ids() == {survivor}
        with pytest.raises(RuntimeError, match="not in the ISR"):
            rs.promote(epoch=1, rid=dead)
        rid, addr = rs.promote(epoch=1)
        assert rid == survivor
        promoted = tkw.KafkaWireBroker(addr)
        assert [m.value for m in promoted.fetch(T, 0, 0, 100)] == \
            [b"v0", b"v1", b"v2", b"tail"]
        promoted.close()
    finally:
        _teardown(srv, rs, client)


def test_survivors_rejoin_isr_after_promotion():
    leader, srv, rs = _leader_with_set(n_followers=3, min_isr=2,
                                       max_lag_s=30.0)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs, width=4)
        _quorum_produce(client, rs, [b"v0", b"v1"])
        srv.kill()
        rid, addr = rs.promote(epoch=1)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                len(rs.state.isr_follower_ids()) < 2:
            rs.sync_once()
        assert len(rs.state.isr_follower_ids()) == 2
        c2 = tkw.KafkaWireBroker(addr)
        assert _quorum_produce(c2, rs, [b"v2"]) == 2
        c2.close()
    finally:
        _teardown(srv, rs, client)


def test_no_isr_member_refuses_promotion():
    leader, srv, rs = _leader_with_set(max_lag_s=0.2)
    try:
        with pytest.raises(RuntimeError, match="no in-sync replica"):
            rs.elect()
    finally:
        _teardown(srv, rs)


def test_hwm_persists_across_remount(tmp_path):
    store = str(tmp_path / "leader")
    leader, srv, rs = _leader_with_set(max_lag_s=30.0,
                                       hwm_file=t_hwm.HwmFile(store),
                                       store_dir=store)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        _quorum_produce(client, rs, [b"v0", b"v1"])
        client.produce_many(T, [(None, b"unreplicated", 0)], partition=0,
                            acks=1)
        leader.flush()
        rs.state.flush()
    finally:
        _teardown(srv, rs, client)
        leader.close()
    leader2 = Broker(store_dir=store)
    assert leader2.end_offset(T, 0) == 3
    state2 = ReplicationState(leader2, follower_ids=(999,), min_isr=2,
                              hwm_file=t_hwm.HwmFile(store))
    leader2.replication = state2
    assert state2.quorum_hwm(T, 0) == 2
    assert [m.value for m in leader2.fetch(T, 0, 0, 100)] == [b"v0", b"v1"]
    state2.observe_fetch(999, T, 0, 3)
    assert [m.value for m in leader2.fetch(T, 0, 0, 100)] == \
        [b"v0", b"v1", b"unreplicated"]
    leader2.close()


def test_add_follower_bootstraps_via_raw_fetch_and_joins_isr():
    leader, srv, rs = _leader_with_set(n_followers=1, min_isr=1,
                                       max_lag_s=30.0)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs, width=2)
        client.produce_many(T, [(None, f"r{i}".encode(), 0)
                                for i in range(50)], partition=0, acks=1)
        rid = rs.add_follower(sync="manual")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and \
                rid not in rs.state.isr_follower_ids():
            rs.sync_once()
        assert rid in rs.state.isr_follower_ids()
        rep = rs.followers[rid]
        assert rep.raw_mirrored == 50
        assert [m.value for m in rep.local.fetch(T, 0, 0, 100)] == \
            [m.value for m in leader.fetch(T, 0, 0, 100)]
        rs.retire_follower(rid)
        assert rid not in rs.state.isr_follower_ids()
        assert rid not in rs.followers
    finally:
        _teardown(srv, rs, client)


def test_replication_gauges_and_healthz_section():
    leader, srv, rs = _leader_with_set(max_lag_s=30.0)
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        _form_isr(rs)
        assert t_metrics.isr_size.value(topic=T, partition=0) == 3
        client.produce_many(T, [(None, b"v", 0)], partition=0, acks=1)
        rs.state.evict_stale()
        rendered = t_metrics.default_registry.render()
        for name in ("iotml_isr_size", "iotml_under_replicated_partitions",
                     "iotml_quorum_hwm_lag_records"):
            assert name in rendered
        doc = t_metrics._healthz_doc()["replication"]
        assert doc["isr"][f"{T}:0"] == 3
        assert f"{T}:0" in doc["quorum_hwm_lag_records"]
        assert rs.describe() == {
            "leader": f"127.0.0.1:{srv.port}",
            "followers": sorted(rs.followers),
            "isr_follower_ids": sorted(rs.followers),
            "isr_size": {f"{T}:0": 3}, "min_isr": 2}
    finally:
        _teardown(srv, rs, client)


# ------------------------------------------------ parity: the ISR tracker
class _Clock:
    """A scripted ``time`` module for the ISR tracker."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, _s):
        pass


def _isr_script(seed: int, n: int = 80) -> list:
    """Seeded ops over 2 partitions and followers 1-3: produce, fetch at
    a position near the end, tick the clock, evict, (un)register."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        k = rng.integers(0, 10)
        if k < 2:
            ops.append(("produce", int(rng.integers(0, 2)),
                        int(rng.integers(1, 4))))
        elif k < 6:
            ops.append(("fetch", int(rng.integers(1, 4)),
                        int(rng.integers(0, 2)), int(rng.integers(-2, 1))))
        elif k < 8:
            ops.append(("tick", float(rng.choice([0.01, 0.05, 0.2, 0.6]))))
        elif k == 8:
            ops.append(("evict",))
        else:
            ops.append((("unregister", "register")[int(rng.integers(0, 2))],
                        int(rng.integers(1, 4))))
    return ops


def _run_isr_script(kind: str, ops: list, monkeypatch) -> list:
    k = PKG[kind]
    clock = _Clock()
    monkeypatch.setattr(k["isr"], "time", clock)
    broker = k["Broker"]()
    broker.create_topic(T, partitions=2)
    state = k["ReplicationState"](broker, follower_ids=(1, 2, 3),
                                  min_isr=2, max_lag_s=0.4)
    out = []
    for op in ops:
        res = None
        if op[0] == "produce":
            broker.produce_batch(T, [b"x"] * op[2], partition=op[1])
        elif op[0] == "fetch":
            _, rid, p, back = op
            state.observe_fetch(rid, T, p,
                                max(broker.end_offset(T, p) + back, 0))
        elif op[0] == "tick":
            clock.now += op[1]
        elif op[0] == "evict":
            res = state.evict_stale()
        elif op[0] == "unregister":
            state.unregister_follower(op[1])
        else:
            state.register_follower(op[1])
        out.append((op, res, state.follower_ids,
                    sorted(state.isr_follower_ids()),
                    [(state.isr_size(T, p), state.quorum_hwm(T, p),
                      state.fetch_ceiling(T, p), state.positions(T, p),
                      k["metrics"].quorum_hwm_lag.value(topic=T,
                                                        partition=p))
                     for p in range(2)],
                    state.hwm_snapshot()))
    return out


#: admission, eviction past the window, re-admission, an unregister
HAND_SCRIPT = [("produce", 0, 3), ("fetch", 1, 0, -1), ("fetch", 1, 0, 0),
               ("fetch", 2, 0, 0), ("produce", 0, 2), ("tick", 0.2),
               ("fetch", 2, 0, 0), ("tick", 0.3), ("evict",),
               ("fetch", 1, 0, 0), ("produce", 1, 1), ("fetch", 3, 1, 0),
               ("unregister", 3), ("register", 3), ("fetch", 3, 1, 0)]


@pytest.mark.parametrize("script", ["hand", 0, 1, 2, 3])
def test_isr_sequences_equal_jax_on_a_scripted_clock(script, monkeypatch):
    ops = HAND_SCRIPT if script == "hand" else _isr_script(script)
    got = _run_isr_script("port", ops, monkeypatch)
    want = _run_isr_script("jax", ops, monkeypatch)
    assert got == want
    assert max(row[4][0][0] for row in got) >= 2  # someone was admitted
    if script == "hand":
        # follower 1 admitted, evicted by the window, re-admitted
        assert [row[4][0][0] for row in got][:10] == \
            [1, 1, 2, 3, 3, 3, 3, 3, 2, 3]
        assert got[8][1] == [1]


def _wait_outcomes(kind: str) -> list:
    k = PKG[kind]
    broker = k["Broker"]()
    broker.create_topic(T)
    broker.produce_batch(T, [b"a", b"b"], partition=0)
    state = k["ReplicationState"](broker, follower_ids=(1, 2), min_isr=2,
                                  max_lag_s=0.2)
    out = [state.wait_replicated(T, 0, 2, timeout_s=0.0)]  # anchored
    state.observe_fetch(1, T, 0, 2)
    state.observe_fetch(2, T, 0, 2)
    broker.produce_batch(T, [b"c"], partition=0)
    out.append(state.wait_replicated(T, 0, 3, timeout_s=0.05))  # nobody
    timer = threading.Timer(0.05, lambda: (state.observe_fetch(1, T, 0, 3),
                                           state.observe_fetch(2, T, 0, 3)))
    timer.start()
    out.append(state.wait_replicated(T, 0, 3, timeout_s=5.0))
    timer.join()
    # follower 2 dies: the wait rides out the staleness window and the
    # quorum re-forms without it
    broker.produce_batch(T, [b"d"], partition=0)
    timer = threading.Timer(0.02, lambda: state.observe_fetch(1, T, 0, 4))
    timer.start()
    out.append(state.wait_replicated(T, 0, 4, timeout_s=5.0))
    timer.join()
    out.append((state.quorum_hwm(T, 0), sorted(state.isr_follower_ids())))
    return out


def test_wait_replicated_outcomes_equal_jax():
    assert _wait_outcomes("port") == _wait_outcomes("jax") == \
        [True, False, True, True, (4, [1])]


def test_hwm_file_bytes_equal_jax_across_remount_and_torn(tmp_path):
    hwms = {("b", 3): 40, ("a:b", 0): 7, ("a", 10): 1_000_000}
    files = {}
    for kind in PKG:
        d = tmp_path / kind
        d.mkdir()
        PKG[kind]["hwm"].HwmFile(str(d)).store(hwms)
        files[kind] = (d / "replication-hwm.json").read_bytes()
        # a remount reads what was stored, through either package
        for other in PKG:
            assert PKG[other]["hwm"].HwmFile(str(d)).load() == hwms
    assert files["port"] == files["jax"]
    # a torn file degrades to no checkpoint; a malformed row is skipped
    for kind in PKG:
        d = tmp_path / kind
        (d / "replication-hwm.json").write_bytes(files[kind][:-5])
        assert PKG[kind]["hwm"].HwmFile(str(d)).load() == {}
        (d / "replication-hwm.json").write_bytes(
            b'{"hwm": {"t:x": 1, "t:2": 5, "u:1": "z"}}')
        assert PKG[kind]["hwm"].HwmFile(str(d)).load() == {("t", 2): 5}
    assert t_hwm.hwm_file_for(None) is None
    assert t_hwm.hwm_file_for(str(tmp_path)).path == \
        j_hwm.hwm_file_for(str(tmp_path)).path


def test_replication_state_checkpoint_equals_jax(tmp_path):
    files = {}
    for kind in PKG:
        k = PKG[kind]
        d = tmp_path / kind
        d.mkdir()
        broker = k["Broker"]()
        broker.create_topic(T, partitions=2)
        broker.produce_batch(T, [b"x"] * 5, partition=1)
        state = k["ReplicationState"](broker, follower_ids=(1,), min_isr=1,
                                      hwm_file=k["hwm"].HwmFile(str(d)))
        state.observe_fetch(1, T, 1, 5)
        broker.produce_batch(T, [b"y"] * 3, partition=1)
        state.observe_fetch(1, T, 1, 7)
        state.observe_fetch(1, T, 0, 0)
        state.flush()
        files[kind] = (d / "replication-hwm.json").read_bytes()
        # a remount re-anchors at the checkpoint, below the log end
        again = k["ReplicationState"](broker, follower_ids=(1,), min_isr=1,
                                      hwm_file=k["hwm"].HwmFile(str(d)))
        assert again.quorum_hwm(T, 1) == 7 and broker.end_offset(T, 1) == 8
    assert files["port"] == files["jax"]


@pytest.mark.parametrize("case", ["whole", "cut", "empty", "corrupt",
                                  "torn", "none_below"])
def test_truncate_frame_batch_equals_jax(case):
    entries = [(b"k%d" % i, b"v" * i, 100 + i) for i in range(12)]
    blob = j_framing.frame_entries(entries, 50)
    if case == "corrupt":
        mangled = bytearray(blob)
        mangled[len(blob) // 2] ^= 0xFF
        blob = bytes(mangled)
    elif case == "torn":
        blob = blob[:-7]
    elif case == "empty":
        blob = b""
    ceiling = {"whole": 1000, "cut": 57, "empty": 55, "corrupt": 61,
               "torn": 70, "none_below": 50}[case]
    assert t_framing.truncate_frame_batch(blob, ceiling) == \
        j_framing.truncate_frame_batch(blob, ceiling)


# ------------------------------------------------- parity: wire bytes
def _frame(api, ver, corr, client_id, body: bytes) -> bytes:
    return tkw._req_header(api, ver, corr, client_id) + body


def _roundtrip(port: int, frames) -> list:
    """Each frame sent on one connection; the response frames."""
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        for f in frames:
            s.sendall(struct.pack(">i", len(f)) + f)
            (n,) = struct.unpack(">i", _recv(s, 4))
            out.append(_recv(s, n))
    return out


def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "server closed"
        buf += chunk
    return buf


def _produce_body(acks, timeout_ms, parts) -> bytes:
    w = tkw._Writer()
    w.i16(acks).i32(timeout_ms)
    w.array([None], lambda wr, _: wr.string(T).array(
        parts, lambda pw, pe: pw.i32(pe[0]).bytes_(
            tkw._encode_message_set_py(pe[1]))))
    return bytes(w.buf)


def _fetch_body(rid, offset, max_bytes=1 << 20) -> bytes:
    w = tkw._Writer()
    w.i32(rid).i32(0).i32(1)
    w.array([None], lambda wr, _: wr.string(T).array(
        [None], lambda pw, __: pw.i32(0).i64(offset).i32(max_bytes)))
    return bytes(w.buf)


def _raw_fetch_body(rid, offset) -> bytes:
    w = tkw._Writer()
    w.string(T).i32(0).i64(offset).i32(1 << 20)
    if rid is not None:
        w.i32(rid)
    return bytes(w.buf)


def _raw_produce_body(frames, acks=None) -> bytes:
    w = tkw._Writer()
    w.string(T).i32(0).bytes_(frames)
    if acks is not None:
        w.i16(acks).i32(300)
    return bytes(w.buf)


def _commit_body(group, off) -> bytes:
    w = tkw._Writer()
    w.string(group).i32(-1).string("").i64(-1)
    w.array([None], lambda wr, _: wr.string(T).array(
        [None], lambda pw, __: pw.i32(0).i64(off).string(None)))
    return bytes(w.buf)


def _server_script(kind: str) -> list:
    """Raw requests against a kind's server at epoch 3 whose broker leads
    under a ReplicationState (follower 7, min_isr 2): the responses."""
    k = PKG[kind]
    broker = k["Broker"]()
    broker.create_topic(T)
    broker.produce_batch(T, [b"a", b"b", b"c"], partition=0)
    state = k["ReplicationState"](broker, follower_ids=(7,), min_isr=2,
                                  max_lag_s=30.0)
    broker.replication = state
    assert state.quorum_hwm(T, 0) == 3  # anchored before the tail lands
    ms = [(0, b"k", b"v", 5), (0, None, b"w", 6)]
    frames = j_framing.frame_entries([(b"k", b"r", 7)], 0)
    with k["kw"].KafkaWireServer(broker, epoch=3) as srv:
        script = [
            # ISR short: 19 with nothing appended, classic and raw
            _frame(tkw.PRODUCE, 2, 1, "c@e3", _produce_body(-1, 300,
                                                          [(0, ms)])),
            _frame(tkw.RAW_PRODUCE, 0, 2, "c@e3",
                   _raw_produce_body(frames, -1)),
            # no trailing acks on RAW_PRODUCE: -1, refused the same
            _frame(tkw.RAW_PRODUCE, 0, 3, "c", _raw_produce_body(frames)),
            # invalid acks: 21
            _frame(tkw.PRODUCE, 2, 4, "c@e3", _produce_body(7, 300,
                                                          [(0, ms)])),
            _frame(tkw.RAW_PRODUCE, 0, 5, "c",
                   _raw_produce_body(frames, 4)),
            # stale or future epochs: 74, before the broker is touched
            _frame(tkw.PRODUCE, 2, 6, "c@e2", _produce_body(1, 300,
                                                          [(0, ms)])),
            _frame(tkw.RAW_PRODUCE, 0, 7, "c@e4",
                   _raw_produce_body(frames, 1)),
            _frame(tkw.OFFSET_COMMIT, 2, 8, "c@e9", _commit_body("g", 2)),
            # acks=1 lands a tail above the quorum HWM
            _frame(tkw.PRODUCE, 2, 9, "c@e3", _produce_body(1, 300,
                                                          [(0, ms)])),
            _frame(tkw.RAW_PRODUCE, 0, 10, "c", _raw_produce_body(frames,
                                                                 1)),
            # a consumer's fetches stop at the quorum HWM (3)
            _frame(tkw.FETCH, 2, 11, "c", _fetch_body(-1, 0)),
            _frame(tkw.RAW_FETCH, 0, 12, "c", _raw_fetch_body(-1, 0)),
            _frame(tkw.RAW_FETCH, 0, 13, "c", _raw_fetch_body(None, 3)),
            # the replica's fetches read the tail and feed the ISR
            _frame(tkw.FETCH, 2, 14, "r", _fetch_body(7, 2)),
            _frame(tkw.RAW_FETCH, 0, 15, "r", _raw_fetch_body(7, 6)),
            # an unregistered replica id reads the tail, never counts
            _frame(tkw.FETCH, 2, 16, "r", _fetch_body(8, 0)),
            _frame(tkw.FETCH, 2, 17, "c", _fetch_body(-1, 4)),
            _frame(tkw.OFFSET_COMMIT, 2, 18, "c@e3", _commit_body("g", 2)),
        ]
        resp = _roundtrip(srv.port, script)
        resp.append((broker.end_offset(T, 0), state.quorum_hwm(T, 0),
                     state.isr_size(T, 0), broker.committed("g", T, 0)))
    return resp


def test_server_response_bytes_equal_jax():
    got, want = _server_script("port"), _server_script("jax")
    assert len(got) == len(want) == 19
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"response {i} differs"
    # the errors the script expects, read off the port's answers
    err_at = {0: 19, 3: 21, 5: 74}
    for i, e in err_at.items():
        r = tkw._Reader(got[i])
        r.i32(), r.i32(), r.string(), r.i32(), r.i32()
        assert r.i16() == e
    for i, e in {1: 19, 2: 19, 4: 21, 6: 74}.items():
        assert struct.unpack_from(">h", got[i], 4)[0] == e
    assert got[-1] == (6, 6, 2, 2)


class _RecordingSocket:
    def __init__(self, sock, log):
        self._sock, self._log = sock, log

    def sendall(self, data):
        self._log.append(bytes(data))
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _client_script(c):
    c.produce_many(T, [(b"k", b"v", 1), (None, b"w", 2)], partition=0)
    c.produce_many(T, [(None, b"x", 3)], partition=0, acks=1,
                   timeout_ms=500)
    c.produce_raw(T, 0, j_framing.frame_entries([(b"k", b"r", 4)], 0))
    c.produce_raw(T, 0, j_framing.frame_entries([(None, b"s", 5)], 0),
                  acks=0, timeout_ms=250)
    c.fetch(T, 0, 0)
    c.fetch_raw(T, 0, 1)
    c.commit("g", T, 0, 2)
    c.set_epoch(None)
    c.set_replica_id(-1)
    c.fetch(T, 0, 2)
    c.fetch_raw(T, 0, 0)


@pytest.mark.parametrize("server", list(PKG))
def test_client_request_bytes_equal_jax(server, monkeypatch):
    real = socket.create_connection
    frames = {}
    for which in PKG:
        log = []
        monkeypatch.setattr(socket, "create_connection",
                            lambda *a, **kw: _RecordingSocket(
                                real(*a, **kw), log))
        backing = PKG[server]["Broker"]()
        backing.create_topic(T)
        with PKG[server]["kw"].KafkaWireServer(backing, epoch=5) as srv:
            c = PKG[which]["kw"].KafkaWireBroker(
                f"127.0.0.1:{srv.port}", epoch=5, replica_id=4, acks=-1,
                timeout_s=5.0)
            _client_script(c)
            c.close()
        frames[which] = b"".join(log)
    assert frames["port"] == frames["jax"]
    assert b"iotml@e5" in frames["port"]


# ------------------------------------- parity: the four client x server pairs
@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_fencing_over_pairs(cli, srv_kind):
    sk, ck = PKG[srv_kind], PKG[cli]
    broker = sk["Broker"]()
    broker.create_topic(T)
    with sk["kw"].KafkaWireServer(broker, epoch=2) as srv:
        addr = f"127.0.0.1:{srv.port}"
        for epoch in (1, 3):  # a stale client; a resurrected old leader
            c = ck["kw"].KafkaWireBroker(addr, epoch=epoch, timeout_s=5.0)
            with pytest.raises(ck["kw"].FencedEpochError):
                c.produce(T, b"x")
            with pytest.raises(ck["kw"].FencedEpochError):
                c.produce_raw(T, 0, j_framing.frame_entries(
                    [(None, b"r", 0)], 0))
            with pytest.raises(ck["kw"].FencedEpochError):
                c.commit("g", T, 0, 5)
            assert c.end_offset(T, 0) == 0  # reads stay open
            c.close()
        assert broker.end_offset(T, 0) == 0
        assert broker.committed("g", T, 0) is None
        ok = ck["kw"].KafkaWireBroker(addr, epoch=2, timeout_s=5.0)
        assert ok.produce(T, b"y") == 0
        legacy = ck["kw"].KafkaWireBroker(addr, timeout_s=5.0)
        assert legacy.produce(T, b"z") == 1
        ok.close()
        legacy.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_topology_reresolve_after_fence_over_pairs(cli, srv_kind):
    from iotml.supervise.topology import Topology as JTopology
    from iotml_torch.supervise.topology import Topology

    sk, ck = PKG[srv_kind], PKG[cli]
    ba, bb = sk["Broker"](), sk["Broker"]()
    for b in (ba, bb):
        b.create_topic(T)
    with sk["kw"].KafkaWireServer(ba, epoch=0) as sa, \
            sk["kw"].KafkaWireServer(bb, epoch=1) as sb:
        topo = (Topology if cli == "port" else JTopology)(
            f"127.0.0.1:{sa.port}", epoch=0,
            fallback=[f"127.0.0.1:{sb.port}"])
        c = ck["kw"].KafkaWireBroker(f"127.0.0.1:{sa.port}", topology=topo,
                                     timeout_s=5.0)
        c.produce(T, b"term0")
        topo.publish(f"127.0.0.1:{sb.port}", 1)
        sa.set_epoch(2)
        with pytest.raises(ck["kw"].FencedEpochError):
            c.produce(T, b"stale")
        c.produce(T, b"term1")
        assert (ba.end_offset(T, 0), bb.end_offset(T, 0), c.epoch) == \
            (1, 1, 1)
        c.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_acks_all_and_replica_leg_over_pairs(cli, srv_kind):
    """A replica client's fetches feed the server's ISR; a plain client's
    acks=all produce is refused (19, nothing appended) while the ISR is
    short and acked once the replica's fetch passes it; consumers stop
    at the quorum HWM while the replica reads past it."""
    sk, ck = PKG[srv_kind], PKG[cli]
    broker = sk["Broker"]()
    broker.create_topic(T)
    state = sk["ReplicationState"](broker, follower_ids=(5,), min_isr=2,
                                   max_lag_s=30.0)
    broker.replication = state
    with sk["kw"].KafkaWireServer(broker) as srv:
        addr = f"127.0.0.1:{srv.port}"
        prod = ck["kw"].KafkaWireBroker(addr, timeout_s=5.0)
        rep = ck["kw"].KafkaWireBroker(addr, replica_id=5, timeout_s=5.0)
        with pytest.raises(ck["kw"].NotEnoughReplicasError):
            prod.produce_many(T, [(None, b"v", 0)], partition=0)
        assert broker.end_offset(T, 0) == 0
        assert rep.fetch(T, 0, 0) == []
        assert state.isr_size(T, 0) == 2  # admitted at the log end
        result = {}
        th = threading.Thread(target=lambda: result.setdefault(
            "last", prod.produce_many(T, [(None, b"a", 0), (None, b"b", 0)],
                                      partition=0)), daemon=True,
            name="iotml-test-pair-produce")
        th.start()
        deadline = time.monotonic() + 10
        while th.is_alive() and time.monotonic() < deadline:
            got = rep.fetch(T, 0, 0)  # the tail, then the position
            if got:
                rep.fetch(T, 0, got[-1].offset + 1)
            time.sleep(0.005)
        th.join(1.0)
        assert result == {"last": 1}
        prod.produce_many(T, [(None, b"tail", 0)], partition=0, acks=1)
        assert [m.value for m in prod.fetch(T, 0, 0)] == [b"a", b"b"]
        assert prod.last_hwm(T, 0) == 2
        assert [m.value for m in rep.fetch(T, 0, 0)] == [b"a", b"b", b"tail"]
        raw = rep.fetch_raw(T, 0, 2)
        assert [v for _o, _k, v, _t, _h in
                j_framing.iter_frame_entries(raw.data)][-1] == b"tail"
        assert state.quorum_hwm(T, 0) == 2
        assert rep.fetch(T, 0, 3) == []  # the position passes the tail
        assert state.quorum_hwm(T, 0) == 3
        for c in (prod, rep):
            c.close()


@pytest.mark.parametrize("fol,lead", PAIRS)
def test_follower_mirrors_across_packages(fol, lead, tmp_path):
    """A follower of either package mirrors a leader of either: records
    at identical offsets from a trimmed base, commits, RAW_FETCH."""
    lk, fk = PKG[lead], PKG[fol]
    leader = lk["Broker"]()
    leader.create_topic(T, partitions=2, retention_messages=40)
    for i in range(120):
        leader.produce(T, b"v%d" % i, key=b"k%d" % (i % 7),
                       partition=i % 2, timestamp_ms=1000 + i)
    with lk["kw"].KafkaWireServer(leader) as srv:
        c = lk["kw"].KafkaWireBroker(f"127.0.0.1:{srv.port}", timeout_s=5.0)
        c.commit("g", T, 0, 21)
        c.commit("g", T, 1, 12)
        rep = fk["Follower"](f"127.0.0.1:{srv.port}", topics=[T],
                             groups=("g",))
        try:
            while rep.sync_once() > 0:
                pass
            for p in range(2):
                want = [(m.offset, m.key, m.value, m.timestamp_ms)
                        for m in leader.fetch(T, p, leader.begin_offset(T, p),
                                              1000)]
                got = [(m.offset, m.key, m.value, m.timestamp_ms)
                       for m in rep.local.fetch(T, p,
                                                rep.local.begin_offset(T, p),
                                                1000)]
                assert got == want and want
                assert rep.local.begin_offset(T, p) == \
                    leader.begin_offset(T, p) > 0
            assert rep.raw_mirrored == sum(
                leader.end_offset(T, p) - leader.begin_offset(T, p)
                for p in range(2))
            assert (rep.local.committed("g", T, 0),
                    rep.local.committed("g", T, 1)) == (21, 12)
            assert rep.lag() == {T: 0}
        finally:
            c.close()
            rep._leader.close()
            rep.local.close()


def _election(kind: str) -> dict:
    k = PKG[kind]
    leader, srv, rs = _leader_with_set(n_followers=3, max_lag_s=0.2,
                                       kind=kind)
    first = min(rs.followers)
    client = k["kw"].KafkaWireBroker(f"127.0.0.1:{srv.port}", timeout_s=5.0)
    try:
        _form_isr(rs)
        _quorum_produce(client, rs, [b"v0", b"v1"])
        rs.kill_follower(first + 1)
        client.produce_many(T, [(None, b"tail", 0)], partition=0, acks=1)
        time.sleep(0.3)
        rs.sync_once()
        rs.state.evict_stale()
        isr = sorted(r - first for r in rs.state.isr_follower_ids())
        with pytest.raises(RuntimeError):
            rs.promote(epoch=1, rid=first + 1)
        rid, addr = rs.promote(epoch=4)
        promoted = k["kw"].KafkaWireBroker(addr, epoch=4, timeout_s=5.0)
        log = [m.value for m in promoted.fetch(T, 0, 0, 100)]
        hwm = rs.state.quorum_hwm(T, 0)
        desc = rs.describe()
        promoted.close()
        return {"isr_at_kill": isr, "elected": rid - first, "log": log,
                "hwm_carried": hwm, "followers": [r - first for r in
                                                  desc["followers"]],
                "isr_size": desc["isr_size"], "min_isr": desc["min_isr"]}
    finally:
        _teardown(srv, rs, client)


def test_election_and_promotion_equal_jax():
    got, want = _election("port"), _election("jax")
    assert got == want
    assert got["isr_at_kill"] == [0, 2] and got["elected"] in (0, 2)
    assert got["log"] == [b"v0", b"v1", b"tail"]


def test_double_fault_drill_verdicts_equal_jax():
    got = t_drill.drill_double_fault(seed=7)
    want = j_drill.drill_double_fault(seed=7)
    assert [(i.name, i.ok) for i in got.invariants] == \
        [(i.name, i.ok) for i in want.invariants]
    assert got.ok and want.ok, "\n".join(got.lines() + want.lines())
    assert sorted(got.slos) == sorted(want.slos)


def test_replication_cli_list_and_reassign_names_a14(capsys):
    """``list`` names both drills; ``drill --name reassign``, which raised
    naming A14 until the cluster was ported, runs and exits 0."""
    assert repl_main(["list"]) == 0
    out = capsys.readouterr().out
    assert "double-fault" in out and "reassign" in out
    assert repl_main(["drill", "--name", "reassign", "--records",
                      "300"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["drill"] == "reassign" and doc["ok"]


# ------------------------------------- the cardata job from a promoted replica
def _fleet_log(n: int = 3000):
    """The records of the emulator's fleet log, as produce entries."""
    src = t_app._broker_for(f"emulator:{n}", "SENSOR_DATA_S_AVRO")
    return [(m.key, m.value, m.timestamp_ms)
            for m in src.fetch("SENSOR_DATA_S_AVRO", 0, 0, n + 1)]


def _cli_params(servers, root, tmp_path, tag):
    argv = [servers, "SENSOR_DATA_S_AVRO", "0", "model-predictions",
            "train", "m1", str(root), "--train.epochs=2",
            "--train.batch_size=10"]
    assert cardata.main(argv, device="cpu") == 0
    got = CheckpointManager.load_dir(ArtifactStore(str(root)).download_tree(
        "m1", str(tmp_path / f"restore_{tag}")))
    return got["params"]


def test_cardata_fit_from_the_promoted_replica(tmp_path):
    entries = _fleet_log()
    leader = Broker()
    leader.create_topic("SENSOR_DATA_S_AVRO")
    srv = tkw.KafkaWireServer(leader).start()
    rs = ReplicaSet(leader_broker=leader, leader_server=srv, n_followers=2,
                    min_isr=2, max_lag_s=0.3, topics=["SENSOR_DATA_S_AVRO"])
    rs.start(sync="thread")
    client = tkw.KafkaWireBroker(f"127.0.0.1:{srv.port}")
    try:
        assert rs.await_isr(3, "SENSOR_DATA_S_AVRO", 0, timeout_s=15)
        assert client.produce_many("SENSOR_DATA_S_AVRO", entries,
                                   partition=0) == len(entries) - 1
        before = _cli_params(f"127.0.0.1:{srv.port}", tmp_path / "pre",
                             tmp_path, "pre")
        rs.kill_follower(min(rs.followers))
        client.produce_many("SENSOR_DATA_S_AVRO", entries[:10],
                            partition=0)  # acked once the ISR re-forms
        srv.kill()
        rid, addr = rs.promote(epoch=1)
        after = _cli_params(addr, tmp_path / "post", tmp_path, "post")
        for name in PARAM_NAMES:
            assert np.array_equal(after[name].numpy(),
                                  before[name].numpy()), name
        # the promoted log against JAX's fit from the same converted
        # params, both reading it over the wire
        tb = list(next(SensorBatches(
            StreamConsumer(tkw.KafkaWireBroker(addr),
                           ["SENSOR_DATA_S_AVRO:0:0"], group="fit"),
            batch_size=100, take=10, only_normal=True).epochs(1)))
        jbs = list(next(JSensorBatches(
            JStreamConsumer(jkw.KafkaWireBroker(addr),
                            ["SENSOR_DATA_S_AVRO:0:0"], group="jfit"),
            batch_size=100, take=10, only_normal=True).epochs(1)))
        assert len(tb) == len(jbs) == 10
        for x, y in zip(tb, jbs):
            assert np.array_equal(x.x, y.x) and np.array_equal(x.mask,
                                                               y.mask)
        tt, jt = Trainer(CAR_AUTOENCODER, device="cpu"), JTrainer(J_AE)
        jt._ensure_state(np.zeros((100, 18), np.float32))
        st = jt.state
        adam = st.opt_state[0]
        tt.state = TrainState(
            step=int(st.step),
            params=params_from_jax(jax.tree.map(np.asarray, st.params)),
            opt_state=adam_from_optax(adam.count,
                                      jax.tree.map(np.asarray, adam.mu),
                                      jax.tree.map(np.asarray, adam.nu)))
        th = tt.fit_compiled(tb, epochs=3)
        jh = jt.fit_compiled(jbs, epochs=3)
        np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
        j_params = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
        for name, v in tt.state.params.items():
            np.testing.assert_allclose(v.numpy(), j_params[name].numpy(),
                                       err_msg=name, **STATE_TOL)
    finally:
        client.close()
        rs.stop()
        with contextlib.suppress(OSError):
            srv.server_close()
