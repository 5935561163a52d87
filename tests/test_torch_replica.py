"""Follower replication and leader failover (``iotml_torch.stream.replica``)
on the CPU: the JAX suite's cases (tests/test_replica.py and
tests/test_compact.py's compacted-topic mirror) run on the port, and the
port's follower's log, commits and realignment equal JAX's follower's on
the same leader.

The reference's stream plane is replicated (RF-3 topics on 3 brokers,
01_installConfluentPlatform.sh:180-183); the port's equivalent is a pull
follower serving the same wire protocol at identical offsets, failover
living in the client's bootstrap list or its topology.

Tolerance: none; every comparison is exact.  Every server binds
127.0.0.1:0; every wait has a deadline.
"""

import socket
import struct
import threading
import time

import pytest

from iotml.stream.broker import Broker as JBroker
from iotml.stream.kafka_wire import KafkaWireServer as JKafkaWireServer
from iotml.stream.replica import FollowerReplica as JFollowerReplica
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.store import StorePolicy
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import (KafkaWireBroker, KafkaWireServer,
                                           SaslAuthError)
from iotml_torch.stream.replica import FollowerReplica


def _leader_with_data(n_ticks=20, partitions=2, retention=None):
    broker = Broker()
    broker.create_topic("T", partitions=partitions,
                        retention_messages=retention)
    gen = FleetGenerator(FleetScenario(num_cars=30, seed=7))
    gen.publish(broker, "T", n_ticks=n_ticks, partitions=partitions)
    srv = KafkaWireServer(broker).start()
    return broker, srv, gen


def _all_messages(broker_like, topic, partitions):
    out = {}
    for p in range(partitions):
        msgs, off = [], broker_like.begin_offset(topic, p)
        while True:
            chunk = broker_like.fetch(topic, p, off, 1000)
            if not chunk:
                break
            msgs.extend((m.offset, m.key, m.value, m.timestamp_ms)
                        for m in chunk)
            off = msgs[-1][0] + 1
        out[p] = msgs
    return out


def test_follower_mirrors_messages_offsets_and_commits():
    broker, srv, gen = _leader_with_data()
    try:
        leader_client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        leader_client.commit("g1", "T", 0, 123)
        leader_client.commit("g1", "T", 1, 45)
        with FollowerReplica(f"127.0.0.1:{srv.port}", topics=["T"],
                             groups=("g1",)) as rep:
            assert rep.caught_up(timeout_s=15)
            rep.sync_once()  # one more round: the commit mirror ran
            want = _all_messages(broker, "T", 2)
            got = _all_messages(rep.local, "T", 2)
            assert want == got and all(want.values())
            assert rep.local.committed("g1", "T", 0) == 123
            assert rep.local.committed("g1", "T", 1) == 45
            assert rep.lag() == {"T": 0}
        leader_client.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_late_start_follower_aligns_trimmed_base_offset():
    broker, srv, gen = _leader_with_data(n_ticks=40, partitions=1,
                                         retention=300)
    try:
        assert broker.begin_offset("T", 0) > 0  # the head was trimmed
        with FollowerReplica(f"127.0.0.1:{srv.port}", topics=["T"]) as rep:
            assert rep.caught_up(timeout_s=15)
            assert rep.local.begin_offset("T", 0) == \
                broker.begin_offset("T", 0)
            assert rep.local.end_offset("T", 0) == broker.end_offset("T", 0)
            off = broker.begin_offset("T", 0) + 5
            assert [m.value for m in rep.local.fetch("T", 0, off, 10)] == \
                [m.value for m in broker.fetch("T", 0, off, 10)]
    finally:
        srv.shutdown()
        srv.server_close()


def test_consumer_survives_leader_death_mid_drain():
    """A consumer bootstrapped with "leader,follower" drains half the
    stream, commits, the leader DIES, and the same consumer drains the
    rest from the follower at the same offsets: every record once, and
    the committed offsets survive for a crash-restart."""
    broker, srv, gen = _leader_with_data(n_ticks=20, partitions=2)
    total = sum(len(v) for v in _all_messages(broker, "T", 2).values())
    rep = FollowerReplica(f"127.0.0.1:{srv.port}", topics=["T"],
                          groups=("g2",)).start()
    try:
        assert rep.caught_up(timeout_s=15)
        client = KafkaWireBroker(
            f"127.0.0.1:{srv.port},127.0.0.1:{rep.port}")
        consumer = StreamConsumer(client, [f"T:{p}:0" for p in range(2)],
                                  group="g2")
        seen = []
        deadline = time.monotonic() + 20
        while len(seen) < total // 2 and time.monotonic() < deadline:
            for m in consumer.poll(200):
                seen.append((m.partition, m.offset, m.value))
        assert len(seen) >= total // 2
        consumer.commit()
        # the barrier: the loop parks between rounds, so this mirror and
        # the kill race nothing
        assert rep.pause()
        rep.sync_once()
        want = {p: off for _, p, off in consumer.positions()}
        assert all(rep.local.committed("g2", "T", p) == want[p]
                   for p in range(2))
        srv.kill()
        rep.resume()
        deadline = time.monotonic() + 20
        while len(seen) < total and time.monotonic() < deadline:
            try:
                batch = consumer.poll(200)
            except ConnectionError:
                # the kill can race a fetch and its one retry
                time.sleep(0.05)
                continue
            for m in batch:
                seen.append((m.partition, m.offset, m.value))
        assert len(seen) == total
        for p in range(2):
            offs = sorted(o for pp, o, _ in seen if pp == p)
            assert offs == list(range(len(offs)))
        c2 = StreamConsumer.from_committed(
            KafkaWireBroker(f"127.0.0.1:{rep.port}"), "T", range(2),
            group="g2")
        assert {p: off for _, p, off in c2.positions()} == want
    finally:
        rep.stop()
        try:
            srv.server_close()
        except OSError:
            pass


class _RejectingSaslServer:
    """Accepts the SASL handshake, then REJECTS the PLAIN token with a
    non-empty answer (what real brokers do with bad credentials); counts
    its connections."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.connections = 0
        threading.Thread(target=self._serve, daemon=True,
                         name="iotml-test-rejecting-sasl").start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.connections += 1
            try:
                (size,) = struct.unpack(">i", conn.recv(4))
                frame = conn.recv(size)
                corr = struct.unpack(">i", frame[4:8])[0]
                body = (struct.pack(">i", corr) + struct.pack(">h", 0)
                        + struct.pack(">i", 1)
                        + struct.pack(">h", 5) + b"PLAIN")
                conn.sendall(struct.pack(">i", len(body)) + body)
                (size,) = struct.unpack(">i", conn.recv(4))
                conn.recv(size)
                conn.sendall(struct.pack(">i", 4) + b"nope")
            except OSError:
                pass
            finally:
                conn.close()

    def close(self):
        self.sock.close()


def test_failover_rejects_bad_credentials_without_retry_spam():
    a, b = _RejectingSaslServer(), _RejectingSaslServer()
    try:
        with pytest.raises(SaslAuthError):
            KafkaWireBroker(f"127.0.0.1:{a.port},127.0.0.1:{b.port}",
                            sasl_username="svc", sasl_password="wrong")
        assert a.connections == 1 and b.connections == 0
    finally:
        a.close()
        b.close()


def test_bad_credentials_against_fixture_server_fail_closed():
    broker = Broker()
    broker.create_topic("T")
    srv = KafkaWireServer(broker, credentials=("svc", "right")).start()
    try:
        with pytest.raises(ConnectionError):
            KafkaWireBroker(f"127.0.0.1:{srv.port}",
                            sasl_username="svc", sasl_password="wrong")
        good = KafkaWireBroker(f"127.0.0.1:{srv.port}",
                               sasl_username="svc", sasl_password="right")
        assert good.topics() == ["T"]
        good.close()
    finally:
        srv.shutdown()
        srv.server_close()


def test_failover_survives_mid_request_reconnect_with_sasl():
    broker = Broker()
    broker.create_topic("T")
    broker.produce("T", b"x", key=b"k")
    srv_a = KafkaWireServer(broker, credentials=("svc", "pw")).start()
    srv_b = KafkaWireServer(broker, credentials=("svc", "pw")).start()
    try:
        client = KafkaWireBroker(
            f"127.0.0.1:{srv_a.port},127.0.0.1:{srv_b.port}",
            sasl_username="svc", sasl_password="pw")
        assert client.end_offset("T", 0) == 1
        srv_a.kill()
        assert client.end_offset("T", 0) == 1  # B, after a re-auth
        client.close()
    finally:
        for s in (srv_a, srv_b):
            try:
                s.shutdown()
                s.server_close()
            except OSError:
                pass


def test_commit_mirror_throttled_and_batched():
    """Idle rounds do not hammer the leader with offset fetches: the
    background cadence mirrors only after a round that copied or once a
    ``commit_interval_s``, in ONE OffsetFetch a group; a direct
    ``sync_once()`` mirrors unconditionally."""
    broker, srv, _gen = _leader_with_data(n_ticks=4, partitions=2)
    try:
        leader_client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        leader_client.commit("g", "T", 0, 3)
        rep = FollowerReplica(f"127.0.0.1:{srv.port}", topics=["T"],
                              groups=("g",), commit_interval_s=3600.0)
        assert rep.sync_once(mirror_commits=None) > 0
        assert rep.local.committed("g", "T", 0) == 3
        leader_client.commit("g", "T", 0, 4)
        corr_before = rep._leader._corr
        assert rep.sync_once(mirror_commits=None) == 0
        assert rep.local.committed("g", "T", 0) == 3  # skipped
        assert rep._leader._corr - corr_before <= 1 + 2
        rep._last_commit_sync = float("-inf")
        corr_before = rep._leader._corr
        assert rep.sync_once(mirror_commits=None) == 0
        assert rep.local.committed("g", "T", 0) == 4
        assert rep._leader._corr - corr_before == 2 + 1  # + one OffsetFetch
        leader_client.commit("g", "T", 1, 9)
        rep.sync_once()
        assert rep.local.committed("g", "T", 1) == 9
        rep._leader.close()
        leader_client.close()
    finally:
        srv.shutdown()
        srv.server_close()


def _compacted_leader(kind, path):
    from iotml.store import StorePolicy as JStorePolicy

    B, P = (Broker, StorePolicy) if kind == "port" else (JBroker,
                                                         JStorePolicy)
    leader = B(store_dir=str(path),
               store_policy=P(fsync="never", segment_bytes=256))
    leader.create_topic("C", cleanup_policy="compact")
    for rnd in range(8):
        for k in range(4):
            leader.produce("C", f"v{rnd}".encode(), key=f"k{k}".encode(),
                           partition=0, timestamp_ms=1000 + rnd)
    leader.store.log_for("C", 0).roll()
    leader.run_compaction(force=True)
    return leader


@pytest.mark.parametrize("lead", ["port", "jax"])
def test_replica_mirrors_compacted_topic_with_holes(lead, tmp_path):
    """Compaction punches offset holes; a durable follower mirrors them
    at their offsets (produce_at / the raw leg), never renumbered: from
    the port's leader and from JAX's."""
    leader = _compacted_leader(lead, tmp_path / "leader")
    want = [(m.offset, m.key, m.value, m.timestamp_ms)
            for m in leader.fetch("C", 0, 0, 10 ** 6)]
    assert [o for o, _k, _v, _t in want] != list(range(len(want)))
    Server = KafkaWireServer if lead == "port" else JKafkaWireServer
    with Server(leader) as srv:
        with FollowerReplica(f"127.0.0.1:{srv.port}", topics=["C"],
                             store_dir=str(tmp_path / "follower"),
                             compacted_topics=("C",)) as rep:
            assert rep.caught_up(timeout_s=15)
            rep.pause()
            assert rep.sync_errors == []
            got = [(m.offset, m.key, m.value, m.timestamp_ms)
                   for m in rep.local.fetch("C", 0, 0, 10 ** 6)]
            assert got == want
            assert rep.local.topic("C").cleanup_policy == "compact"
    leader.close()


def _mirror(kind, srv_port, store):
    cls = FollowerReplica if kind == "port" else JFollowerReplica
    rep = cls(f"127.0.0.1:{srv_port}", topics=["T"], groups=("g",),
              store_dir=store, fetch_batch=7)
    try:
        while rep.sync_once() > 0:
            pass
        return {"log": _all_messages(rep.local, "T", 2),
                "base": [rep.local.begin_offset("T", p) for p in range(2)],
                "commits": [rep.local.committed("g", "T", p)
                            for p in range(2)],
                "raw": rep.raw_mirrored, "errors": rep.sync_errors,
                "lag": rep.lag()}
    finally:
        rep._leader.close()
        rep.local.close()


@pytest.mark.parametrize("raw", ["auto", "off"])
def test_port_follower_equals_jax_follower(raw, tmp_path, monkeypatch):
    """Both followers of one trimmed leader, durable, over the raw leg
    and (IOTML_RAW_PRODUCE=off) the per-record leg: the same logs at the
    same offsets, bases, commits, copied counts and realignments; the
    store segments byte for byte."""
    monkeypatch.setenv("IOTML_RAW_PRODUCE", raw)
    broker, srv, _gen = _leader_with_data(n_ticks=30, partitions=2,
                                          retention=300)
    try:
        c = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        c.commit("g", "T", 0, 400)
        c.commit("g", "T", 1, 410)
        assert all(broker.begin_offset("T", p) > 0 for p in range(2))
        got = _mirror("port", srv.port, str(tmp_path / "port"))
        want = _mirror("jax", srv.port, str(tmp_path / "jax"))
        c.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert got == want
    assert got["base"] == [broker.begin_offset("T", p) for p in range(2)]
    assert all(b > 0 for b in got["base"])
    assert got["raw"] == (0 if raw == "off" else
                          sum(len(v) for v in got["log"].values()))
    for p in range(2):
        seg = sorted((tmp_path / "port" / "segments" / "T" /
                      str(p)).glob("*.log"))
        jseg = sorted((tmp_path / "jax" / "segments" / "T" /
                       str(p)).glob("*.log"))
        assert [s.name for s in seg] == [s.name for s in jseg] and seg
        assert [s.read_bytes() for s in seg] == \
            [s.read_bytes() for s in jseg]
