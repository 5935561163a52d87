"""The partitioned cluster (``iotml_torch.cluster`` and the cluster half of
``stream/kafka_wire.py``) held against the JAX package on the CPU.

- The JAX suite's own cases (tests/test_cluster.py, all fifteen) run on
  both packages: ownership, keyed routing, per-partition metadata, the
  error-6 bounce, the stale-metadata re-route without duplicates,
  identical offsets across a handoff, a group split across shards, the
  coordinator's death mid-generation, a cold restart from the stores,
  revocation grace, supervised per-shard failover, the pump fleet's
  rebalance.  So do the cluster cases of tests/test_rawproduce.py (raw
  batches routed to the owning shard), tests/test_chaos.py
  (rebalance-under-chaos at 200 records) and tests/test_mlops.py (the
  scorer fleet's hot swap).
- Parity: the responses of a cluster-viewed server of each package to one
  raw request script (METADATA, FIND_COORDINATOR, errors 6, 16 and 35,
  the retiring step-down) byte for byte; both clients' request bytes
  (``cluster_metadata``, ``find_coordinator``, ``cluster_admin``); each
  package's ``ClusterClient`` against the other's cluster; the partition
  map's answers; every partition touch point refused on an unowned
  partition; the fit over ``ClusterClient`` from converted params; the
  scorer fleet's payloads and errors.
- The command lines: ``python -m iotml_torch.cluster`` (``drill``, the
  admin verbs over CLUSTER_ADMIN, the unported flags naming A10) and
  ``python -m iotml_torch.chaos run --scenario rebalance-under-chaos``.

Tolerances: exact (bytes, offsets, sets, counts, verdicts) but the fit
(losses rtol 2e-4 / atol 1e-6, params rtol 5e-3 / atol 2e-5: the JAX
suite's fit bounds, tests/test_fused_train.py) and the fleet (payloads
atol 1e-6 parsed, per-row errors rtol 1e-5: two float32 forwards).  Every
server binds 127.0.0.1:0; every wait has a deadline.
"""

import contextlib
import io
import json
import os
import socket
import struct
import time
import zlib

import jax
import numpy as np
import pytest

from iotml import cluster as j_cluster
from iotml.chaos.runner import ChaosRunner as JChaosRunner
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.mlops.checkpoint import params_from_h5_bytes as j_from_h5
from iotml.mlops.checkpoint import params_to_h5_bytes as j_to_h5
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.ops import framing as j_framing
from iotml.stream import group as j_group
from iotml.stream import kafka_wire as jkw
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.streamproc.tasks import StreamTask as JStreamTask
from iotml.train.loop import Trainer as JTrainer
from iotml_torch import cluster as t_cluster
from iotml_torch.chaos.__main__ import main as chaos_main
from iotml_torch.chaos.runner import ChaosRunner
from iotml_torch.cluster.__main__ import main as cluster_main
from iotml_torch.cluster.shard import ShardBroker, _UnownedPartition
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import ModelRegistry
from iotml_torch.mlops.checkpoint import (params_from_h5_bytes,
                                          params_to_h5_bytes)
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.serve import scorer as t_scorer
from iotml_torch.stream import broker as t_broker
from iotml_torch.stream import group as t_group
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.streamproc.tasks import StreamTask
from iotml_torch.train.loop import Trainer, TrainState

TOPIC = "sensor-data"
PARTS = 6
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
PKG = {"port": dict(c=t_cluster, kw=tkw, group=t_group, Broker=Broker,
                    StreamTask=StreamTask, Registry=ModelRegistry,
                    fleet_kw={"device": "cpu"}),
       "jax": dict(c=j_cluster, kw=jkw, group=j_group, Broker=JBroker,
                   StreamTask=JStreamTask, Registry=JModelRegistry,
                   fleet_kw={})}
KINDS = list(PKG)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def fill(client, n=60):
    for i in range(n):
        client.produce(TOPIC, f"v{i}".encode(), key=f"car{i}".encode())


@contextlib.contextmanager
def cluster_of(kind, **kw):
    ctl = PKG[kind]["c"].ClusterController(brokers=3, **kw).start()
    try:
        yield ctl
    finally:
        ctl.stop()


@pytest.fixture(params=KINDS)
def cluster(request):
    with cluster_of(request.param) as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        ctl.kind = request.param
        yield ctl


def _close(*clients):
    for c in clients:
        c.close()


# ------------------------------------------------- tests/test_cluster.py
def test_each_broker_materializes_only_its_partitions(cluster):
    cli = cluster.client()
    fill(cli)
    for i, b in enumerate(cluster.brokers):
        owned = [p for p in range(PARTS) if b.owns(TOPIC, p)]
        assert owned == [p for p in range(PARTS) if p % 3 == i]
        for p in range(PARTS):
            if b.owns(TOPIC, p):
                b.end_offset(TOPIC, p)
            else:
                with pytest.raises(PKG[cluster.kind]["kw"]
                                   .NotLeaderForPartitionError):
                    b.end_offset(TOPIC, p)
    assert sum(cli.end_offset(TOPIC, p) for p in range(PARTS)) == 60
    cli.close()


def test_keyed_routing_is_cross_client_stable(cluster):
    """One key lands on one partition through the cluster client, the
    plain wire client and the single in-process broker of both packages."""
    cli = cluster.client()
    raws = [k["kw"].KafkaWireBroker(cluster.pmap.leader(0))
            for k in PKG.values()]
    singles = [k["Broker"]() for k in PKG.values()]
    for b in singles:
        b.create_topic(TOPIC, partitions=PARTS)
    for key in (b"car1", b"car42", b"x"):
        expect = zlib.crc32(key) % PARTS
        assert cli._partition_for(TOPIC, key) == expect
        assert [r._partition_for(TOPIC, key) for r in raws] == [expect] * 2
        assert [b._partition_for(TOPIC, key) for b in singles] == \
            [expect] * 2
    _close(cli, *raws)


def test_metadata_carries_per_partition_leaders(cluster):
    for k in PKG.values():
        raw = k["kw"].KafkaWireBroker(cluster.pmap.leader(1))
        meta = raw.cluster_metadata([TOPIC])
        assert {n for n, _h, _p, _r in meta["brokers"]} == {0, 1, 2}
        for p in range(PARTS):
            assert meta["leaders"][(TOPIC, p)] == p % 3
        assert meta["topics"] == {TOPIC: PARTS}
        raw.close()


def test_unowned_partition_bounces_error_6(cluster):
    for k in PKG.values():
        raw = k["kw"].KafkaWireBroker(cluster.pmap.leader(0))
        with pytest.raises(k["kw"].NotLeaderForPartitionError):
            raw.fetch(TOPIC, 1, 0)
        with pytest.raises(k["kw"].NotLeaderForPartitionError):
            raw.produce(TOPIC, b"x", partition=2)
        raw.close()


def test_stale_metadata_fetch_refreshes_and_reroutes(cluster):
    seed = cluster.client()
    fill(seed)
    wc = PKG[cluster.kind]["c"].ClusterClient(
        bootstrap=cluster.pmap.leader(0))
    before = wc.fetch(TOPIC, 1, 0, 100)
    assert before
    wc._leaders[(TOPIC, 1)] = 0  # a stale map: partition 1 on node 0
    again = wc.fetch(TOPIC, 1, 0, 100)
    assert [(m.offset, m.value) for m in again] == \
        [(m.offset, m.value) for m in before]
    assert wc._leaders[(TOPIC, 1)] == 1  # the bounce healed the cache
    _close(wc, seed)


def test_stale_metadata_produce_retries_without_duplication(cluster):
    wc = PKG[cluster.kind]["c"].ClusterClient(
        bootstrap=cluster.pmap.leader(2))
    wc.produce(TOPIC, b"a", partition=1)
    wc._leaders[(TOPIC, 1)] = 2
    wc.produce(TOPIC, b"b", partition=1)
    assert [m.value for m in wc.fetch(TOPIC, 1, 0, 10)] == [b"a", b"b"]
    wc.close()


@pytest.mark.parametrize("kind", KINDS)
def test_handoff_during_drain_keeps_offsets_identical(kind):
    with cluster_of(kind, replicated=True, replica_sync="manual") as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        cli = ctl.client()
        fill(cli, 90)
        cursors, seen = {}, []
        for p in range(PARTS):
            got = cli.fetch(TOPIC, p, 0, 5)
            seen.extend((m.partition, m.offset, m.value) for m in got)
            cursors[p] = got[-1].offset + 1 if got else 0
        ctl.sync_replicas_once()
        pre_end = {p: cli.end_offset(TOPIC, p) for p in range(PARTS)}
        ctl.fail_shard(1)
        assert ctl.pmap.epoch(1) == 1
        for p in range(PARTS):
            got = cli.fetch(TOPIC, p, cursors[p], 1000)
            seen.extend((m.partition, m.offset, m.value) for m in got)
        assert len(seen) == len(set(seen)) == 90
        assert {p: cli.end_offset(TOPIC, p) for p in range(PARTS)} == \
            pre_end
        cli.close()


def test_group_members_split_partitions_across_shards(cluster):
    k = PKG[cluster.kind]
    seed = cluster.client()
    fill(seed, 60)
    c1, c2 = cluster.client(), cluster.client()
    g1 = k["group"].GroupConsumer(k["kw"].RemoteGroupCoordinator(c1, "g"),
                                  [TOPIC])
    g2 = k["group"].GroupConsumer(k["kw"].RemoteGroupCoordinator(c2, "g"),
                                  [TOPIC])
    g1.poll(0)
    assert sorted(g1.assignment + g2.assignment) == \
        [(TOPIC, p) for p in range(PARTS)]
    seen = []
    for gc in (g1, g2):
        while True:
            batch = gc.poll(1000)
            if not batch:
                break
            seen.extend((m.partition, m.offset) for m in batch)
        assert gc.commit() is True
    assert len(seen) == len(set(seen)) == 60
    _close(c1, c2, seed)


@pytest.mark.parametrize("kind", KINDS)
def test_coordinator_death_mid_generation(kind):
    k = PKG[kind]
    with cluster_of(kind, replicated=True, replica_sync="manual",
                    mirror_groups=("g",)) as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        seed = ctl.client()
        fill(seed, 60)
        c1, c2 = ctl.client(), ctl.client()
        g1 = k["group"].GroupConsumer(
            k["kw"].RemoteGroupCoordinator(c1, "g"), [TOPIC])
        g2 = k["group"].GroupConsumer(
            k["kw"].RemoteGroupCoordinator(c2, "g"), [TOPIC])
        seen = []
        for gc in (g1, g2):
            while True:
                batch = gc.poll(1000)
                if not batch:
                    break
                seen.extend((m.partition, m.offset) for m in batch)
            assert gc.commit() is True
        assert len(seen) == 60
        fill(seed, 60)
        while ctl.sync_replicas_once() > 0:
            pass
        assert ctl.pmap.coordinator()[0] == 0
        ctl.fail_shard(0)
        assert seed.committed("g", TOPIC, 0) is not None
        seen2 = []
        for _ in range(30):
            for gc in (g1, g2):
                batch = gc.poll(1000)
                seen2.extend((m.partition, m.offset) for m in batch)
                if batch:
                    gc.commit()
            assigned = set(g1.assignment) | set(g2.assignment)
            if len(seen2) >= 60 and \
                    assigned == {(TOPIC, p) for p in range(PARTS)}:
                break
        assert g1.rebalances + g2.rebalances > 0
        assert sorted(set(seen2)) == sorted(seen2)
        assert len(seen2) == 60
        assert not set(seen2) & set(seen)
        _close(c1, c2, seed)


@pytest.mark.parametrize("kind", KINDS)
def test_cold_restart_resumes_every_shard_from_store(kind, tmp_path):
    root = str(tmp_path / "cluster")
    with cluster_of(kind, store_root=root) as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        cli = ctl.client()
        fill(cli, 60)
        ends = {p: cli.end_offset(TOPIC, p) for p in range(PARTS)}
        payload = {p: [m.value for m in cli.fetch(TOPIC, p, 0, 1000)]
                   for p in range(PARTS)}
        cli.commit("g", TOPIC, 1, 4)
        cli.close()
    for i in range(3):
        pdir = os.path.join(root, f"broker-{i}", "segments", TOPIC)
        assert sorted(os.listdir(pdir)) == \
            sorted(str(p) for p in range(PARTS) if p % 3 == i)
    with cluster_of(kind, store_root=root) as ctl2:
        assert ctl2.pmap.topics()[TOPIC] == PARTS
        cli2 = ctl2.client()
        assert {p: cli2.end_offset(TOPIC, p) for p in range(PARTS)} == ends
        assert {p: [m.value for m in cli2.fetch(TOPIC, p, 0, 1000)]
                for p in range(PARTS)} == payload
        assert cli2.committed("g", TOPIC, 1) == 4
        cli2.close()


def _broker_10(kind):
    b = PKG[kind]["Broker"]()
    b.create_topic("sensor-data", partitions=10)
    for i in range(200):
        b.produce("sensor-data", f"r{i}".encode(), partition=i % 10)
    return b


@pytest.mark.parametrize("kind", KINDS)
def test_revocation_commits_before_release(kind):
    g = PKG[kind]["group"]
    broker = _broker_10(kind)
    coord = g.GroupCoordinator(broker, "g", session_timeout_s=30.0)
    c1 = g.GroupConsumer(coord, ["sensor-data"])
    for _ in range(3):
        c1.poll(40)
    polled = {p: off for _t, p, off in c1.positions()}
    c2 = g.GroupConsumer(coord, ["sensor-data"])
    c1.poll(1)
    for t, p in c2.assignment:
        assert broker.committed("g", t, p) == polled[p]


@pytest.mark.parametrize("kind", KINDS)
def test_revocation_grace_never_rewinds_successor(kind):
    broker = _broker_10(kind)
    coord = PKG[kind]["group"].GroupCoordinator(
        broker, "g", session_timeout_s=30.0, clock=FakeClock())
    m1, gen1, _ = coord.join(["sensor-data"])
    coord.join(["sensor-data"])
    m2 = [m for m in coord.members() if m != m1][0]
    _, gen2, assigned2 = coord.join(["sensor-data"], m2)
    t, p = assigned2[0]
    assert coord.fenced_commit(m2, gen2, [(t, p, 15)])
    coord.fenced_commit(m1, gen1, [(t, p, 3)])
    assert broker.committed("g", t, p) == 15


@pytest.mark.parametrize("kind", KINDS)
def test_expired_member_gets_no_grace(kind):
    broker = _broker_10(kind)
    clock = FakeClock()
    coord = PKG[kind]["group"].GroupCoordinator(
        broker, "g", session_timeout_s=5.0, clock=clock)
    m1, gen1, assigned = coord.join(["sensor-data"])
    clock.t += 10.0
    coord.members()  # the expiry sweep
    t, p = assigned[0]
    assert coord.fenced_commit(m1, gen1, [(t, p, 7)]) is False
    assert broker.committed("g", t, p) is None


@pytest.mark.parametrize("kind", KINDS)
def test_supervised_per_shard_failover_moves_one_shard(kind):
    with cluster_of(kind, replicated=True, replica_sync="manual") as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        cli = ctl.client()
        fill(cli, 30)
        ctl.sync_replicas_once()
        sup = ctl.supervised(poll_interval_s=0.02).start()
        try:
            before = {s: ctl.pmap.leader(s) for s in range(3)}
            ctl.kill_shard(2)
            assert ctl.await_failover(2, timeout_s=10.0)
            assert ctl.pmap.leader(2) != before[2]
            assert [ctl.pmap.leader(s) for s in (0, 1)] == \
                [before[0], before[1]]
            assert ctl.pmap.epoch(2) == 1
        finally:
            sup.stop()
        assert sum(cli.end_offset(TOPIC, p) for p in range(PARTS)) == 30
        cli.produce(TOPIC, b"post", partition=2)
        assert cli.fetch(TOPIC, 2, 0, 100)[-1].value == b"post"
        cli.close()


@pytest.mark.parametrize("kind", KINDS)
def test_pump_fleet_rebalances_on_member_death(kind):
    k = PKG[kind]

    class Upper(k["StreamTask"]):
        def process(self, messages):
            return [(m.key, m.value.upper(), m.timestamp_ms)
                    for m in messages]

    with cluster_of(kind) as ctl:
        ctl.create_topic("src", partitions=PARTS)
        seed = ctl.client()
        for i in range(40):
            seed.produce("src", f"r{i}".encode(), key=f"k{i}".encode())
        fleet = k["c"].PumpFleet(
            lambda: ctl.client(),
            lambda client, consumer: Upper(client, "src", "dst",
                                           partitions=PARTS,
                                           consumer=consumer),
            n_members=2, src_topic="src", group="pumps",
            session_timeout_ms=400)
        for _ in range(5):
            fleet.pump_once()
        fleet.kill(0)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            fleet.pump_once()
            if set(fleet.members[1].consumer.assignment) == \
                    {("src", p) for p in range(PARTS)}:
                break
            time.sleep(0.05)
        for _ in range(10):
            fleet.pump_once()
        assert sum(seed.end_offset("dst", p) for p in range(PARTS)) == 40
        fleet.stop()
        seed.close()


# ------------------------------- the cluster cases of other JAX test files
@pytest.mark.parametrize("kind", KINDS)
def test_cluster_client_routes_raw_batches_to_owning_shards(kind):
    """tests/test_rawproduce.py's cluster case."""
    with cluster_of(kind) as ctl:
        ctl.create_topic("t", partitions=6)
        cli = ctl.client()
        frames = j_framing.frame_entries(
            [(b"car-%d" % (i % 7), b"payload-%d" % i, 1000 + i)
             for i in range(10)])
        for p in range(6):
            assert cli.produce_raw("t", p, frames) == 0
        for p in range(6):
            assert cli.end_offset("t", p) == 10
        for b in ctl.brokers:
            for p in range(6):
                if b.owns("t", p):
                    assert b.end_offset("t", p) == 10
        cli.close()


@pytest.mark.parametrize("kind", KINDS)
def test_rebalance_under_chaos_scenario_holds_the_invariants(kind):
    """tests/test_chaos.py's cluster topology case, at 200 records."""
    runner = {"port": ChaosRunner, "jax": JChaosRunner}[kind]
    report = runner("rebalance-under-chaos", seed=7, records=200).run()
    assert report.ok, [i.verdict() for i in report.invariants]
    assert report.topology == "cluster"
    assert report.injected.get("runner.kill_member:kill_member") == 1
    assert report.injected.get(
        "runner.kill_shard_leader:kill_shard_leader") == 1
    by_name = {i.name: i for i in report.invariants}
    for name in ("zero_records_lost", "zero_double_scored",
                 "member_death_rebalanced", "shard_failover_one_shard_only"):
        assert by_name[name].ok


def _jax_params(seed):
    tr = JTrainer(J_AE, rng=jax.random.PRNGKey(seed))
    tr._ensure_state(np.zeros((4, 18), np.float32))
    return jax.device_get(tr.state.params)


@pytest.mark.parametrize("kind", KINDS)
def test_scorer_fleet_hot_swaps_every_member(kind, tmp_path):
    """tests/test_mlops.py's fleet case: ONE watcher swaps the whole
    fleet between drains when serving moves (the registry's weights are
    JAX's, converted for the port)."""
    k = PKG[kind]
    to_h5 = j_to_h5 if kind == "jax" else (
        lambda p: params_to_h5_bytes(params_from_jax(p)))
    from_h5 = j_from_h5 if kind == "jax" else params_from_h5_bytes
    gen_cls = (JFleetGenerator, JFleetScenario) if kind == "jax" else \
        (FleetGenerator, FleetScenario)
    ctl = k["c"].ClusterController(brokers=2).start()
    try:
        reg = k["Registry"](str(tmp_path / "reg"))
        v1 = reg.publish({"model.h5": to_h5(_jax_params(0))}).version
        reg.promote(v1)
        ctl.create_topic(TOPIC, partitions=2)
        ctl.create_topic("preds", partitions=2)
        seed_client = ctl.client()
        gen = gen_cls[0](gen_cls[1](num_cars=100))
        gen.publish(seed_client, TOPIC, n_ticks=2, partitions=2)
        fleet = k["c"].ScorerFleet(
            lambda: ctl.client(), (J_AE if kind == "jax" else
                                   CAR_AUTOENCODER),
            from_h5(reg.load_bytes(v1, "model.h5")), n_members=2,
            in_topic=TOPIC, out_topic="preds", group="fleet-swap",
            registry=reg, **k["fleet_kw"])
        for _ in range(6):
            fleet.pump_once()
        assert all(m.payload.model_version == v1 for m in fleet.members)
        scored_before = fleet.scored()
        v2 = reg.publish({"model.h5": to_h5(_jax_params(1))}).version
        reg.promote(v2)
        gen.publish(seed_client, TOPIC, n_ticks=2, partitions=2)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            fleet.pump_once()
            if all(m.payload.model_version == v2
                   for m in fleet.members) and fleet.scored() == 400:
                break
            time.sleep(0.02)
        assert all(m.payload.model_version == v2 for m in fleet.members)
        assert fleet.scored() == 400 > scored_before
        seed_client.close()
        fleet.stop()
    finally:
        ctl.stop()


# --------------------------------------------------- parity: the wire bytes
class _View:
    """A fixed cluster view (node 1 of three, coordinator node 0): both
    packages' servers answer from the same map."""

    node_id = 1

    def brokers(self):
        return [(0, "h0", 9090), (1, "h1", 9091), (2, "h2", 9092)]

    def leader_node(self, topic, partition):
        return partition % 3

    def coordinator(self):
        return (0, "h0", 9090)


def _frame(api, ver, corr, cid, body):
    w = tkw._Writer()
    w.i16(api).i16(ver).i32(corr).string(cid)
    payload = bytes(w.buf) + body
    return struct.pack(">i", len(payload)) + payload


def _roundtrip(port, frames):
    out = []
    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        for f in frames:
            s.sendall(f)
            (size,) = struct.unpack(">i", tkw.recv_exact(s, 4))
            out.append(tkw.recv_exact(s, size))
    return out


def _w():
    return tkw._Writer()


def _cluster_script():
    """Raw requests to a cluster node that is neither the owner of
    partitions 0, 2, 3, 5 nor the coordinator."""
    ms = tkw._encode_message_set_py([(0, b"k", b"v", 5)])
    meta = _w().array([TOPIC], lambda wr, t: wr.string(t))
    meta_all = _w().i32(-1)
    produce = _w().i16(1).i32(1000)
    produce.array([None], lambda wr, _: wr.string(TOPIC).array(
        [0, 1], lambda pw, p: pw.i32(p).bytes_(ms)))
    fetch = _w().i32(-1).i32(0).i32(1)
    fetch.array([None], lambda wr, _: wr.string(TOPIC).array(
        [0, 1], lambda pw, p: pw.i32(p).i64(0).i32(1 << 20)))
    offsets = _w().i32(-1)
    offsets.array([None], lambda wr, _: wr.string(TOPIC).array(
        [(0, -1), (1, -1), (2, -2), (4, 0)],
        lambda pw, pe: pw.i32(pe[0]).i64(pe[1])))
    raw_fetch = _w().string(TOPIC).i32(0).i64(0).i32(1 << 20)
    frames = j_framing.frame_entries([(b"k", b"r", 7)], 0)
    raw_produce = _w().string(TOPIC).i32(0).bytes_(frames).i16(1).i32(300)
    raw_produce_own = _w().string(TOPIC).i32(1).bytes_(frames).i16(1)
    raw_produce_own.i32(300)
    commit = _w().string("g").i32(-1).string("").i64(-1)
    commit.array([None], lambda wr, _: wr.string(TOPIC).array(
        [1], lambda pw, p: pw.i32(p).i64(3).string(None)))
    ofetch = _w().string("g")
    ofetch.array([None], lambda wr, _: wr.string(TOPIC).array(
        [1], lambda pw, p: pw.i32(p)))
    find = _w().string("g")
    join = _w().string("g").i32(10_000).string("").string("consumer")
    join.array([("range", b"\x00\x00\x00\x00\x00\x00\x00\x00")],
               lambda wr, p: wr.string(p[0]).bytes_(p[1]))
    sync = _w().string("g").i32(1).string("m").array([], None)
    hb = _w().string("g").i32(1).string("m")
    leave = _w().string("g").string("m")
    admin = _w().string("status").bytes_(b"{}")
    script = [(tkw.METADATA, 1, meta), (tkw.METADATA, 1, meta_all),
              (tkw.PRODUCE, 2, produce), (tkw.FETCH, 2, fetch),
              (tkw.LIST_OFFSETS, 1, offsets), (tkw.RAW_FETCH, 0, raw_fetch),
              (tkw.RAW_PRODUCE, 0, raw_produce),
              (tkw.OFFSET_COMMIT, 2, commit), (tkw.OFFSET_FETCH, 1, ofetch),
              (tkw.FIND_COORDINATOR, 0, find), (tkw.JOIN_GROUP, 0, join),
              (tkw.SYNC_GROUP, 0, sync), (tkw.HEARTBEAT, 0, hb),
              (tkw.LEAVE_GROUP, 0, leave), (tkw.CLUSTER_ADMIN, 0, admin),
              (tkw.API_VERSIONS, 0, _w())]
    retiring = [(tkw.PRODUCE, 2, produce),
                (tkw.RAW_PRODUCE, 0, raw_produce_own),
                (tkw.FETCH, 2, fetch)]
    return script, retiring


def _server_responses(kind):
    k = PKG[kind]
    shard = {"port": ShardBroker,
             "jax": j_cluster.ShardBroker}[kind](
        lambda t, p: p % 3 == 1, shard_id=1)
    shard.create_topic(TOPIC, partitions=PARTS)
    shard.produce(TOPIC, b"held", partition=1)
    script, retiring = _cluster_script()
    with k["kw"].KafkaWireServer(shard, cluster=_View()) as srv:
        resp = _roundtrip(srv.port, [_frame(a, v, i, "c", bytes(b.buf))
                                     for i, (a, v, b) in enumerate(script)])
        srv.retiring = True
        resp += _roundtrip(srv.port, [
            _frame(a, v, 100 + i, "c", bytes(b.buf))
            for i, (a, v, b) in enumerate(retiring)])
    resp.append(tuple(shard.end_offset(TOPIC, 1) for _ in range(1)))
    return resp


def test_cluster_server_response_bytes_equal_jax():
    got, want = _server_responses("port"), _server_responses("jax")
    assert len(got) == len(want) == 20
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"response {i} differs"
    # the errors the script expects, read off the port's answers
    r = tkw._Reader(got[2])
    r.i32()
    parts = r.array(lambda rd: (rd.string(), rd.array(
        lambda p: (p.i32(), p.i16(), p.i64(), p.i64()))))
    assert [(p, e) for p, e, _, _ in parts[0][1]] == \
        [(0, tkw.ERR_NOT_LEADER_FOR_PARTITION), (1, tkw.ERR_NONE)]
    assert struct.unpack_from(">h", got[6], 4)[0] == \
        tkw.ERR_NOT_LEADER_FOR_PARTITION
    for i in (10, 12, 13):  # join, heartbeat, leave: NOT_COORDINATOR
        assert struct.unpack_from(">h", got[i], 4)[0] == \
            tkw.ERR_NOT_COORDINATOR == 16
    assert struct.unpack_from(">h", got[14], 4)[0] == \
        tkw.ERR_UNSUPPORTED_VERSION
    assert struct.unpack_from(">h", got[17], 4)[0] == \
        tkw.ERR_NOT_LEADER_FOR_PARTITION  # retiring raw produce
    # only the acks=1 produce to owned partition 1 landed
    assert got[-1] == (2,)


class _RecordingSocket:
    def __init__(self, sock, log):
        self._sock, self._log = sock, log

    def sendall(self, data):
        self._log.append(bytes(data))
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


@pytest.mark.parametrize("server", KINDS)
def test_client_request_bytes_equal_jax(server, monkeypatch):
    real = socket.create_connection
    frames = {}
    with cluster_of(server) as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        for which in PKG:
            log = []
            monkeypatch.setattr(socket, "create_connection",
                                lambda *a, **kw: _RecordingSocket(
                                    real(*a, **kw), log))
            c = PKG[which]["kw"].KafkaWireBroker(ctl.pmap.leader(1))
            meta = c.cluster_metadata([TOPIC])
            assert meta["leaders"][(TOPIC, 4)] == 1
            assert c.find_coordinator("g")[0] == 0
            assert c.cluster_admin("status")["brokers"] == 3
            with pytest.raises(RuntimeError, match="unknown admin command"):
                c.cluster_admin("nope", {"shard": 1})
            with pytest.raises(PKG[which]["kw"].CoordinatorMovedError):
                c.commit("g", TOPIC, 1, 3)
            with pytest.raises(PKG[which]["kw"].CoordinatorMovedError):
                c.committed("g", TOPIC, 1)
            with pytest.raises(PKG[which]["kw"].CoordinatorMovedError):
                c.join_group("g", [TOPIC])
            c.close()
            monkeypatch.setattr(socket, "create_connection", real)
            frames[which] = b"".join(log)
    assert frames["port"] == frames["jax"]


@pytest.mark.parametrize("cli,srv", [("port", "jax"), ("jax", "port")])
def test_cluster_client_against_the_other_packages_cluster(cli, srv):
    """A bootstrap ``ClusterClient`` of one package over the other's
    cluster: keyed produce, routed fetch, the stale-map bounce, group
    APIs pinned to the coordinator, the admin verbs."""
    with cluster_of(srv, replication_factor=2, min_isr=1,
                    replica_sync="manual") as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        wc = PKG[cli]["c"].ClusterClient(bootstrap=ctl.bootstrap())
        for i in range(30):
            wc.produce_many(TOPIC, [(f"car{i}".encode(), f"v{i}".encode(),
                                     i)], acks=1)
        by_part = {p: [(m.key, m.value) for m in wc.fetch(TOPIC, p, 0, 100)]
                   for p in range(PARTS)}
        for p, recs in by_part.items():
            assert all(zlib.crc32(k) % PARTS == p for k, _ in recs)
        assert sum(len(v) for v in by_part.values()) == 30
        wc._leaders[(TOPIC, 2)] = 0
        assert [(m.key, m.value) for m in wc.fetch(TOPIC, 2, 0, 100)] == \
            by_part[2]
        wc.commit("g", TOPIC, 2, len(by_part[2]))
        assert wc.committed("g", TOPIC, 2) == len(by_part[2])
        assert ctl.brokers[0].committed("g", TOPIC, 2) == len(by_part[2])
        raw = PKG[cli]["kw"].KafkaWireBroker(ctl.pmap.leader(2))
        doc = raw.cluster_admin("status")
        raw.close()
        assert doc["epochs"] == [0, 0, 0] and doc["replication_factor"] == 2
        assert sorted(doc["shards"]) == ["0", "1", "2"]
        wc.close()


@pytest.mark.parametrize("kind", KINDS)
def test_partition_map_answers_equal_jax(kind):
    maps = [k["c"].PartitionMap(["a:1", "b:2", "c:3"])
            for k in PKG.values()]
    trail = []
    for m in maps:
        m.register_topic(TOPIC, 10)
        steps = [m.partitions_of(1, TOPIC), m.resolve(TOPIC, 4),
                 m.coordinator()]
        m.publish(1, "d:4", 1)
        steps += [m.resolve(TOPIC, 4), m.resolve(TOPIC, 3), m.addresses(),
                  m.generation, m.epoch(1)]
        with pytest.raises(ValueError):
            m.publish(1, "e:5", 0)
        m.set_coordinator(2)
        steps += [m.coordinator(), m.coordinator_shard]
        with pytest.raises(ValueError):
            m.set_coordinator(3)
        trail.append(steps)
    assert trail[0] == trail[1]
    assert trail[0][0] == [1, 4, 7]
    with pytest.raises(ValueError):
        PKG[kind]["c"].PartitionMap([])


def test_unowned_partition_refuses_every_touch_point(tmp_path):
    """Every public method of the port's in-memory and durable partitions
    (the raw legs and truncation included) raises the routing signal on
    an unowned partition; the broker-level raw and offset-explicit paths
    bounce; compaction and tiering skip the placeholder."""
    surface = {n for cls in (t_broker._Partition, t_broker._DurablePartition)
               for n in dir(cls) if not n.startswith("_")
               and callable(getattr(cls, n))}
    assert surface >= {"append_raw", "read_raw", "append_at", "reset",
                       "drop_head", "align_base"}
    u = _UnownedPartition("t", 1)
    for name in sorted(surface):
        with pytest.raises(tkw.NotLeaderForPartitionError):
            getattr(u, name)()
    b = ShardBroker(lambda t, p: p == 0, shard_id=0,
                    store_dir=str(tmp_path / "s"))
    b.create_topic("t", partitions=2, cleanup_policy="compact")
    frames = j_framing.frame_entries([(b"k", b"v", 1)])
    for call in (lambda: b.produce_raw("t", 1, frames),
                 lambda: b.produce_raw_at("t", 1, frames),
                 lambda: b.fetch_raw("t", 1, 0),
                 lambda: b.fetch_raw_tail("t", 1, 0),
                 lambda: b.fetch("t", 1, 0),
                 lambda: b.fetch_tail("t", 1, 0),
                 lambda: b.produce_at("t", 1, 0, b"v"),
                 lambda: b.reset_partition("t", 1, 0),
                 lambda: b.align_base_offset("t", 1, 0),
                 lambda: b.offset_for_timestamp("t", 1, 0),
                 lambda: b.produce_many("t", [(b"k", b"v", 0)], partition=1)):
        with pytest.raises(tkw.NotLeaderForPartitionError):
            call()
    b.produce("t", b"v", key=b"k", partition=0)
    b.produce("t", b"w", key=b"k", partition=0)
    assert b.run_compaction(force=True) is not None
    assert b.run_tiering() == {}
    assert sorted(os.listdir(tmp_path / "s" / "segments" / "t")) == ["0"]
    b.close()


# ---------------------------------------------- parity: the fit and fleet
def _fleet_log(n_cars=100, ticks=40):
    """Seeded fleet records, as produce entries a partition."""
    mem = Broker()
    mem.create_topic("SENSOR_DATA_S_AVRO", partitions=2)
    FleetGenerator(FleetScenario(num_cars=n_cars, failure_rate=0.02)) \
        .publish(mem, "SENSOR_DATA_S_AVRO", n_ticks=ticks, partitions=2)
    return {p: [(m.key, m.value, m.timestamp_ms) for m in
                mem.fetch("SENSOR_DATA_S_AVRO", p, 0, 10 ** 6)]
            for p in range(2)}


def _seeded_clusters(stack, log):
    ctls = {}
    for kind in KINDS:
        ctl = stack.enter_context(cluster_of(kind))
        ctl.create_topic("SENSOR_DATA_S_AVRO", partitions=2)
        ctl.create_topic("preds", partitions=2)
        c = ctl.client()
        for p, ents in log.items():
            c.produce_many("SENSOR_DATA_S_AVRO", ents, partition=p)
        c.close()
        ctls[kind] = ctl
    return ctls


def test_fit_over_cluster_client_equals_jax():
    """The cardata fit from batches read through each package's bootstrap
    ``ClusterClient`` (the port's over RAW_FETCH routed to the owners):
    the batches equal, and the port's fit from JAX's converted start
    state within the fit bounds."""
    log = _fleet_log()
    with contextlib.ExitStack() as stack:
        ctls = _seeded_clusters(stack, log)
        specs = [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(2)]
        tc = t_cluster.ClusterClient(bootstrap=ctls["jax"].bootstrap())
        jc = j_cluster.ClusterClient(bootstrap=ctls["port"].bootstrap())
        tb = list(next(SensorBatches(StreamConsumer(tc, specs, group="f"),
                                     batch_size=100, take=20,
                                     only_normal=True).epochs(1)))
        jbs = list(next(JSensorBatches(JStreamConsumer(jc, specs,
                                                       group="f"),
                                       batch_size=100, take=20,
                                       only_normal=True).epochs(1)))
        _close(tc, jc)
    assert len(tb) == len(jbs) == 20
    for x, y in zip(tb, jbs):
        assert np.array_equal(x.x, y.x) and np.array_equal(x.mask, y.mask)
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


def _fleet_payloads(kind, ctl, params, xs_log):
    """Drive a 2-member fleet over the seeded topic; per member's
    assignment, its payload rows, and the id of the member's scorer."""
    k = PKG[kind]
    model = CAR_AUTOENCODER if kind == "port" else J_AE
    fleet = k["c"].ScorerFleet(lambda: ctl.client(), model, params,
                               n_members=2, in_topic="SENSOR_DATA_S_AVRO",
                               out_topic="preds", group="fleet-parity",
                               **k["fleet_kw"])
    total = sum(len(v) for v in xs_log.values())
    deadline = time.monotonic() + 30
    while fleet.scored() < total and time.monotonic() < deadline:
        fleet.pump_once()
    assert fleet.scored() == total
    c = ctl.client()
    out, scorers = {}, {}
    for i, m in enumerate(fleet.members):
        msgs = []
        while len(msgs) < m.payload.scored:
            got = c.fetch("preds", i, len(msgs), 4096)
            assert got
            msgs.extend(got)
        rows = np.array([np.array(g.value.decode().strip("[]").split(),
                                  np.float64) for g in msgs])
        out[tuple(m.consumer.assignment)] = rows
        scorers[tuple(m.consumer.assignment)] = id(m.payload)
    c.close()
    fleet.stop()
    return out, scorers


def test_scorer_fleet_payloads_and_errors_equal_jax(monkeypatch):
    log = _fleet_log(ticks=30)
    jp = _jax_params(3)
    fed = []
    real = t_scorer.StreamScorer._score_super_batch

    def spy(self, bs, base):
        fed.append((id(self), np.concatenate([b.x[:b.n_valid] for b in bs])))
        return real(self, bs, base)

    monkeypatch.setattr(t_scorer.StreamScorer, "_score_super_batch", spy)
    with contextlib.ExitStack() as stack:
        ctls = _seeded_clusters(stack, log)
        got, scorer_of = _fleet_payloads("port", ctls["port"],
                                         params_from_jax(jp), log)
        want, _ = _fleet_payloads("jax", ctls["jax"], jp, log)
    assert sorted(got) == sorted(want) and len(got) == 2
    assert sum(len(r) for r in got.values()) == \
        sum(len(v) for v in log.values())
    by_scorer = {}
    for sid, x in fed:
        by_scorer.setdefault(sid, []).append(x)
    assert sorted(by_scorer) == sorted(scorer_of.values())
    for key, rows in got.items():
        np.testing.assert_allclose(rows, want[key], rtol=0, atol=1e-6)
        # the member's own inputs, by its scorer and its assignment
        x = np.concatenate(by_scorer[scorer_of[key]])
        assert len(x) == len(rows)
        np.testing.assert_allclose(np.square(rows - x).mean(axis=1),
                                   np.square(want[key] - x).mean(axis=1),
                                   rtol=1e-5)


# ------------------------------------------------------------ command lines
def test_cluster_cli_drill_and_admin_verbs(capsys):
    """``drill`` exits with its verdict; ``status``, ``add-broker`` and
    ``drain-broker`` reach a live controller over CLUSTER_ADMIN; the
    unported flags name A10; against a plain server the verbs raise."""
    assert cluster_main(["drill", "--seed", "7", "--records", "200"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["topology"] == "cluster"
    with cluster_of("port", replication_factor=3, min_isr=2,
                    replica_sync="thread", max_lag_s=0.4) as ctl:
        ctl.create_topic(TOPIC, partitions=PARTS)
        for i in range(3):
            assert ctl.replica_sets[i].await_isr(3, TOPIC, i, timeout_s=15)
        boot = ctl.bootstrap()
        assert cluster_main(["status", "--bootstrap", boot]) == 0
        status = json.loads(capsys.readouterr().out)
        assert status["brokers"] == 3 and status["epochs"] == [0, 0, 0]
        assert cluster_main(["add-broker", "--bootstrap", boot,
                             "--shard", "1"]) == 0
        add = json.loads(capsys.readouterr().out)
        assert add["state"] == "retired" and add["epoch"] == 1
        assert cluster_main(["drain-broker", "--bootstrap", boot,
                             "--shard", "2"]) == 0
        drain = json.loads(capsys.readouterr().out)
        assert drain["state"] == "retired" and ctl.pmap.epoch(2) == 1
    for flag in (["--mesh-data", "2"], ["--device-normalize", "1"]):
        with pytest.raises(NotImplementedError, match="A10"):
            cluster_main(["up"] + flag)
    with contextlib.redirect_stderr(io.StringIO()), pytest.raises(SystemExit):
        cluster_main(["up", "--decode-ring-buffers", "0"])
    srv = tkw.KafkaWireServer(Broker()).start()
    try:
        with pytest.raises(NotImplementedError, match="CLUSTER_ADMIN"):
            cluster_main(["status", "--bootstrap", f"127.0.0.1:{srv.port}"])
    finally:
        srv.shutdown()
        srv.server_close()


def test_chaos_cli_runs_the_cluster_scenario_and_names_a14_otherwise(
        capsys):
    argv = ["run", "--scenario", "rebalance-under-chaos", "--records",
            "200"]
    assert chaos_main(argv + ["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["ok"] and doc["published"] == 200 and doc["scored"] == 203
    assert chaos_main(argv) == 0
    out = capsys.readouterr().out
    assert "verdict: PASS" in out and "runner.kill_member" in out
    # the other topologies run too; the twin's scenario names its item
    for scenario in ("leader-kill-mid-drain", "double-fault"):
        assert chaos_main(["run", "--scenario", scenario, "--records",
                           "100"], device="cpu") == 0
        assert "verdict: PASS" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP A16"):
        chaos_main(["run", "--scenario", "compaction-under-crash"],
                   device="cpu")
