"""The port's Kafka wire layer (``iotml_torch.stream.kafka_wire``,
``utils/net.py``, the native message-set engine, ``Broker.produce_many``
and the batched ``OutputSequence.flush``) held against the JAX package
on the CPU.

- Message sets: the port's native and pure encoders and JAX's encoders
  give the same bytes; decode round-trips, drops a partial trailing
  entry and raises JAX's CRC error text.
- Request bytes: the port's client and JAX's send the same frames for
  the same calls (a recording socket under both).
- Client × server: every scenario runs over the four pairs {port, JAX}
  client × {port, JAX} server with the same results.
- Failover, retention over the wire, remote groups, write-back and the
  ``broker`` config section.

Every server binds 127.0.0.1:0, every client has a short timeout, and
every thread join has one.  Tolerance: everything here is exact (bytes,
offsets, partitions, generations, assignments, commits).
"""

import contextlib
import socket
import struct
import threading
import zlib

import numpy as np
import pytest

from iotml import config as j_config
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.stream import kafka_wire as jkw
from iotml.stream.broker import Broker as JBroker
from iotml.stream.broker import OffsetOutOfRangeError as JOffsetOutOfRange
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.group import GroupConsumer as JGroupConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.utils import net as j_net
from iotml_torch import config as t_config
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker, OffsetOutOfRangeError
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.group import GroupConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.utils import net as t_net

TIMEOUT_S = 5.0
#: per package: the wire module, its in-memory broker and its consumers
PKG = {"port": dict(kw=tkw, Broker=Broker, StreamConsumer=StreamConsumer,
                    GroupConsumer=GroupConsumer, SensorBatches=SensorBatches,
                    OffsetOutOfRange=OffsetOutOfRangeError),
       "jax": dict(kw=jkw, Broker=JBroker, StreamConsumer=JStreamConsumer,
                   GroupConsumer=JGroupConsumer,
                   SensorBatches=JSensorBatches,
                   OffsetOutOfRange=JOffsetOutOfRange)}
PAIRS = [(c, s) for c in PKG for s in PKG]


@contextlib.contextmanager
def serving(kind, backing=None, **kw):
    """A started wire server of package ``kind`` over ``backing`` (a new
    in-memory broker of that package when None)."""
    backing = PKG[kind]["Broker"]() if backing is None else backing
    with PKG[kind]["kw"].KafkaWireServer(backing, **kw) as srv:
        yield srv, backing


def client(kind, srv_or_servers, **kw):
    servers = srv_or_servers if isinstance(srv_or_servers, str) \
        else f"127.0.0.1:{srv_or_servers.port}"
    return PKG[kind]["kw"].KafkaWireBroker(servers, timeout_s=TIMEOUT_S, **kw)


def _msgs(messages):
    return [(m.partition, m.offset, m.key, m.value, m.timestamp_ms)
            for m in messages]


# ---------------------------------------------------------- message sets
def _entries(seed, n):
    """Seeded entries over every edge the wire carries: null and empty
    keys, null values (tombstones), empty values, explicit offsets and
    timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        key = None if i % 3 == 0 else \
            bytes(rng.integers(0, 256, i % 17, dtype=np.uint8))
        value = None if i % 7 == 5 else \
            bytes(rng.integers(0, 256, (i * 13) % 301, dtype=np.uint8))
        out.append((int(i * 7 + seed), key, value,
                    int(1_700_000_000_000 + rng.integers(0, 10**6))))
    return out


MSGSET_CASES = {
    "mixed": _entries(5, 64),
    "unkeyed": [(i, None, b"v%d" % i, i) for i in range(40)],
    "keyed": [(100 + i, b"car-%d" % i, b"x" * i, 0) for i in range(40)],
    "tombstones": [(0, b"k", None, 1), (1, None, None, 2)],
    "empty_key_and_value": [(99, b"", b"", 0)],
    "one": [(0, b"k1", b"v1", 5)],
}


@pytest.mark.parametrize("case", sorted(MSGSET_CASES))
def test_message_set_bytes_match_jax_native_and_pure(case):
    entries = MSGSET_CASES[case]
    want = jkw._encode_message_set_py(entries)
    assert tkw.encode_message_set(entries) == want       # native
    assert tkw._encode_message_set_py(entries) == want   # plain
    assert jkw.encode_message_set(entries) == want
    assert native.msgset_encode(entries) == want
    # decode round-trips, native and plain, and agrees with JAX
    assert tkw.decode_message_set(want) == entries
    assert tkw._decode_message_set_py(want) == entries
    assert jkw.decode_message_set(want) == entries


@pytest.mark.parametrize("cut", [1, 3, 5, 12, 20, 33])
def test_truncated_tail_is_dropped_as_jax_drops_it(cut):
    buf = jkw._encode_message_set_py(MSGSET_CASES["mixed"])
    want = jkw._decode_message_set_py(buf[:-cut])
    assert want == MSGSET_CASES["mixed"][:len(want)]
    assert len(want) < len(MSGSET_CASES["mixed"])
    assert native.msgset_decode(buf[:-cut]) == want
    assert tkw.decode_message_set(buf[:-cut]) == want
    assert tkw._decode_message_set_py(buf[:-cut]) == want


@pytest.mark.parametrize("where", ["last_byte", "first_value"])
def test_bad_crc_raises_jax_error_text(where):
    entries = [(0, b"k1", b"v1", 5), (1, None, b"v2", 6), (2, b"k3", b"", 7)]
    buf = bytearray(jkw._encode_message_set_py(entries))
    buf[-1 if where == "last_byte" else 35] ^= 0xFF
    with pytest.raises(ValueError) as jax_err:
        jkw._decode_message_set_py(bytes(buf))
    for decode in (tkw.decode_message_set, tkw._decode_message_set_py):
        with pytest.raises(ValueError) as err:
            decode(bytes(buf))
        assert str(err.value) == str(jax_err.value)
        assert "CRC mismatch" in str(err.value)
    with pytest.raises(ValueError, match="refused"):
        native.msgset_decode(bytes(buf))


@pytest.mark.parametrize("size", [-1, 0, 2, 3, 13])
@pytest.mark.parametrize("after_a_good_entry", [False, True])
def test_entry_size_under_the_smallest_body_raises(size, after_a_good_entry):
    """A size field of 0-13 would move the reads past the entry's end (a
    negative one would move them backwards): both decoders refuse the set,
    and none of its records come back."""
    good = jkw._encode_message_set_py(MSGSET_CASES["one"]) \
        if after_a_good_entry else b""
    buf = good + struct.pack(">qi", 7, size) + b"\x00" * 30
    assert len(buf) >= 26  # past the plain-decoder dispatch
    with pytest.raises(ValueError, match="refused"):
        native.msgset_decode(buf)
    for decode in (tkw.decode_message_set, tkw._decode_message_set_py):
        with pytest.raises(ValueError, match=f"message size {size} under"):
            decode(buf)


def test_short_sets_take_the_plain_decoder():
    head = jkw._encode_message_set_py(MSGSET_CASES["one"])[:25]
    for buf in (b"", b"\x00" * 11, head):
        assert tkw.decode_message_set(buf) == \
            jkw.decode_message_set(buf) == []


def test_native_refusal_of_a_valid_set_raises(monkeypatch):
    """No call on the path returns the plain decoder's records in place
    of the engine's: where the two disagree, the port raises."""
    buf = jkw._encode_message_set_py(MSGSET_CASES["keyed"])

    def refuse(_buf):
        raise ValueError("the message-set engine refused the buffer")

    monkeypatch.setattr(native, "msgset_decode", refuse)
    with pytest.raises(ValueError, match="disagree"):
        tkw.decode_message_set(buf)


def test_a_failed_engine_build_raises_not_falls_back(monkeypatch):
    def broken_build(*a, **kw):
        raise RuntimeError("native stream engine build failed (g++ exit 1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "build", broken_build)
    with pytest.raises(RuntimeError, match="build failed"):
        tkw.encode_message_set(MSGSET_CASES["one"])
    with pytest.raises(RuntimeError, match="build failed"):
        tkw.decode_message_set(
            jkw._encode_message_set_py(MSGSET_CASES["keyed"]))


def test_encode_grows_its_buffer_on_the_engines_request(monkeypatch):
    """-(needed) from the engine is "call again with a bigger buffer"."""
    entries = MSGSET_CASES["keyed"]
    lib = native.load()
    calls = []

    class Shrunk:
        def __getattr__(self, name):
            return getattr(lib, name)

        def iotml_msgset_encode(self, *args):
            args = list(args)
            if not calls:
                args[-1] = 8  # a first buffer too small
            calls.append(args[-1])
            return lib.iotml_msgset_encode(*args)

    monkeypatch.setattr(native, "load", lambda: Shrunk())
    assert native.msgset_encode(entries) == \
        jkw._encode_message_set_py(entries)
    assert calls[0] == 8 and calls[1] == len(
        jkw._encode_message_set_py(entries))


def test_client_epoch_tag_parses_as_jax():
    for cid in ("iotml", "iotml@e3", "a@b@e10", "", None, "x@e"):
        assert tkw.parse_client_epoch(cid) == jkw.parse_client_epoch(cid)


# --------------------------------------------------------- request bytes
class _RecordingSocket:
    """A socket whose sent bytes are recorded."""

    def __init__(self, sock, log):
        self._sock = sock
        self._log = log

    def sendall(self, data):
        self._log.append(bytes(data))
        return self._sock.sendall(data)

    def __getattr__(self, name):
        return getattr(self._sock, name)


def _frames(log):
    """The recorded byte stream cut into its length-prefixed frames."""
    data = b"".join(log)
    out, pos = [], 0
    while pos < len(data):
        (n,) = struct.unpack_from(">i", data, pos)
        out.append(data[pos + 4:pos + 4 + n])
        pos += 4 + n
    return out


def _request_script(c, coord_kw):
    """The client calls whose request frames are compared."""
    c.topics()
    c.create_topic("t", partitions=3, retention_messages=1000,
                   retention_bytes=1 << 20, retention_ms=3_600_000,
                   cleanup_policy="delete")
    c.produce_many("t", [(b"car-%d" % i, b"v%d" % i, 1000 + i)
                         for i in range(7)])
    c.produce_many("t", [(None, b"u%d" % i, 0) for i in range(5)])
    c.produce_many("t", [(None, b"p", 9)], partition=2)
    c.fetch("t", 0, 0)
    c.fetch("t", 1, 2, max_messages=1)
    c.end_offset("t", 1)
    c.begin_offset("t", 2)
    c.offset_for_timestamp("t", 0, 1003)
    c.commit("g", "t", 0, 2)
    c.commit_many("g", "t", [(1, 1), (2, 1)])
    c.committed("g", "t", 0)
    c.committed_many("g", [("t", 2), ("t", 0), ("t", 1)])
    c.find_coordinator("grp")
    gen, mid, leader, members = c.join_group("grp", ["t"], "member-a",
                                             **coord_kw)
    c.sync_group("grp", gen, mid, {mid: [("t", [2, 0, 1])]})
    c.heartbeat_group("grp", gen, mid)
    c.commit_fenced("grp", gen, mid, [("t", 0, 1)])
    c.leave_group("grp", mid)
    c.api_versions()


@pytest.mark.parametrize("server", list(PKG))
def test_request_frames_are_byte_identical_to_jax(server, monkeypatch):
    real = socket.create_connection
    frames = {}
    for which in PKG:
        log = []
        monkeypatch.setattr(socket, "create_connection",
                            lambda *a, **kw: _RecordingSocket(real(*a, **kw),
                                                              log))
        with serving(server, credentials=("svc", "pw")) as (srv, _):
            c = client(which, srv, sasl_username="svc", sasl_password="pw")
            _request_script(c, {"session_timeout_ms": 3000})
            c.close()
        frames[which] = _frames(log)
    got, want = frames["port"], frames["jax"]
    assert len(got) == len(want) == 23  # handshake + token + 21 requests
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"frame {i} differs"
    # the SASL handshake names PLAIN, then the raw token frame
    assert got[1] == b"\x00svc\x00pw"
    assert struct.unpack_from(">h", got[0])[0] == tkw.SASL_HANDSHAKE


# ------------------------------------------------------- client × server
@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_produce_fetch_offsets_commits(cli, srv_kind):
    with serving(srv_kind) as (srv, backing):
        c = client(cli, srv)
        c.create_topic("t", partitions=3)
        assert "t" in c.topics() and c.topic("t").partitions == 3
        # keyed produce lands on crc32(key) % 3; offsets come back
        assert c.produce("t", b"hello", key=b"car-1") == 0
        assert c.produce("t", b"world", key=b"car-1") == 1
        p = zlib.crc32(b"car-1") % 3
        assert [backing.end_offset("t", q) for q in range(3)] == \
            [2 if q == p else 0 for q in range(3)]
        assert [(m.value, m.key) for m in c.fetch("t", p, 0)] == \
            [(b"hello", b"car-1"), (b"world", b"car-1")]
        assert c.end_offset("t", p) == 2 and c.begin_offset("t", p) == 0
        assert [m.value for m in c.fetch("t", p, 1)] == [b"world"]
        assert c.last_hwm("t", p) == 2
        # unkeyed records round-robin from partition 0
        assert [c.produce("t", b"rr") for _ in range(3)] == \
            [2 if q == p else 0 for q in range(3)]
        # group offsets round-trip
        assert c.committed("g", "t", p) is None
        c.commit("g", "t", p, 2)
        assert c.committed("g", "t", p) == 2 == backing.committed("g", "t", p)
        # by timestamp: produce_many carries timestamps
        c.produce_many("ts", [(None, b"a", 10), (None, b"b", 20),
                              (None, b"c", 30)], partition=0)
        assert [c.offset_for_timestamp("ts", 0, t) for t in (0, 15, 30, 31)] \
            == [0, 1, 2, 3]
        c.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_create_topic_twice_and_unknown_topic(cli, srv_kind):
    with serving(srv_kind) as (srv, backing):
        c = client(cli, srv)
        assert c.create_topic("t", partitions=2).partitions == 2
        # the second hits TOPIC_EXISTS and answers the server's count
        assert c.create_topic("t", partitions=5).partitions == 2
        assert backing.topic("t").partitions == 2
        with pytest.raises(KeyError):
            c.fetch("nope", 0, 0)
        with pytest.raises(KeyError):
            c.topic("nope")
        with pytest.raises(ValueError):
            c.create_topic("bad", retention_messages=-5)
        c.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_sasl_plain_required(cli, srv_kind):
    backing = PKG[srv_kind]["Broker"]()
    backing.produce("t", b"secret")
    with serving(srv_kind, backing, credentials=("test", "test123")) \
            as (srv, _):
        ok = client(cli, srv, sasl_username="test", sasl_password="test123")
        assert [m.value for m in ok.fetch("t", 0, 0)] == [b"secret"]
        ok.close()
        with pytest.raises(ConnectionError):
            client(cli, srv, sasl_username="test", sasl_password="wrong")
        # unauthenticated protocol use is refused outright
        bad = client(cli, srv)
        with pytest.raises(ConnectionError):
            bad.fetch("t", 0, 0)
        bad.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_stream_consumer_and_sensor_batches_over_the_wire(cli, srv_kind):
    reference = Broker()
    FleetGenerator(FleetScenario(num_cars=50)).publish(
        reference, "SENSOR_DATA_S_AVRO", n_ticks=4)
    want = list(SensorBatches(StreamConsumer(
        reference, ["SENSOR_DATA_S_AVRO:0:0"]), batch_size=50))
    with serving(srv_kind) as (srv, _):
        c = client(cli, srv)
        FleetGenerator(FleetScenario(num_cars=50)).publish(
            c, "SENSOR_DATA_S_AVRO", n_ticks=4)  # 200 records
        consumer = PKG[cli]["StreamConsumer"](
            c, ["SENSOR_DATA_S_AVRO:0:0"], group="wire-test")
        got = list(PKG[cli]["SensorBatches"](consumer, batch_size=50))
        assert sum(b.n_valid for b in got) == 200
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g.x), w.x)
        consumer.commit()
        assert c.committed("wire-test", "SENSOR_DATA_S_AVRO", 0) == 200
        c.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_committed_many_in_one_round_trip(cli, srv_kind):
    backing = PKG[srv_kind]["Broker"]()
    backing.create_topic("A", partitions=3)
    backing.create_topic("B", partitions=2)
    with serving(srv_kind, backing) as (srv, _):
        c = client(cli, srv)
        c.commit("g", "A", 0, 10)
        c.commit("g", "A", 2, 30)
        c.commit("g", "B", 1, 5)
        pairs = [("A", p) for p in range(3)] + [("B", p) for p in range(2)]
        before = c._corr
        got = c.committed_many("g", pairs)
        assert c._corr == before + 1  # exactly one wire request
        assert got == {("A", 0): 10, ("A", 2): 30, ("B", 1): 5}
        assert c.committed("g", "A", 1) is None
        c.close()


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_tombstones_and_headers_over_the_wire(cli, srv_kind):
    with serving(srv_kind) as (srv, backing):
        c = client(cli, srv)
        c.produce_many("t", [(b"k", b"v", 1), (b"k", None, 2),
                             (None, b"", 3, (("h", b"x"),))], partition=0)
        got = _msgs(c.fetch("t", 0, 0))
        assert got == [(0, 0, b"k", b"v", 1), (0, 1, b"k", None, 2),
                       (0, 2, None, b"", 3)]
        assert _msgs(backing.fetch("t", 0, 0))[:3] == got
        c.close()


@pytest.mark.parametrize("api", ["fetch_raw", "produce_raw",
                                 "cluster_admin"])
def test_port_server_answers_jax_extensions_unsupported(api):
    """JAX's client against the port's server: RAW_FETCH and RAW_PRODUCE
    are in its table and round-trip (the frames JAX's client reads are
    the broker's, a batch it ships lands as the same records); the
    connection survives each; CLUSTER_ADMIN, served only by a server with
    a cluster controller attached (``iotml_torch.cluster``), is answered
    UNSUPPORTED_VERSION by this one, which JAX's client reads as a server
    without the extension."""
    from iotml.ops import framing as j_framing

    with serving("port") as (srv, backing):
        backing.produce("t", b"x", key=b"k", timestamp_ms=7)
        c = client("jax", srv)
        if api == "fetch_raw":
            raw = c.fetch_raw("t", 0, 0)
            assert raw.start_offset == 0 and \
                raw.data == backing.fetch_raw("t", 0, 0).data
            assert list(j_framing.iter_frame_entries(raw.data)) == \
                [(0, b"k", b"x", 7, None)]
        elif api == "produce_raw":
            frames = j_framing.frame_entries([(b"k2", b"y", 8),
                                              (None, None, 9)])
            assert c.produce_raw("t", 0, frames) == 1
            assert _msgs(backing.fetch("t", 0, 1)) == \
                [(0, 1, b"k2", b"y", 8), (0, 2, None, None, 9)]
        else:
            with pytest.raises(NotImplementedError):
                c.cluster_admin("status")
        # the connection survives: a classic fetch still answers
        assert [m.value for m in c.fetch("t", 0, 0)][0] == b"x"
        c.close()
        c = client("port", srv)
        assert set(c.api_versions()) == set(tkw._SUPPORTED)
        c.close()


def _fetch_response(c, topic, partition, offset, max_bytes):
    w = tkw._Writer()
    w.i32(-1).i32(0).i32(1)
    w.array([None], lambda wr, _: (wr.string(topic), wr.array(
        [None], lambda pw, _: pw.i32(partition).i64(offset).i32(max_bytes))))
    r = c._request(tkw.FETCH, 2, bytes(w.buf))
    return r.buf[r.pos:]


@pytest.mark.parametrize("max_bytes", [100, 1000, 5000, 4 << 20])
def test_fetch_responses_and_the_max_bytes_cut_match_jax(max_bytes):
    """The same fetch against both servers over the same log answers the
    same bytes; a set cut mid-entry decodes to its whole entries."""
    answers = {}
    for kind in PKG:
        backing = PKG[kind]["Broker"]()
        backing.create_topic("t")
        for i in range(5000):  # more than one fetch's 4,096
            backing.produce("t", b"v%05d" % i, key=b"k%d" % (i % 7),
                            partition=0, timestamp_ms=i)
        with serving(kind, backing) as (srv, _):
            c = client("port", srv)
            answers[kind] = _fetch_response(c, "t", 0, 3, max_bytes)
            msgs = c.fetch("t", 0, 3, max_messages=10_000)
            c.close()
        want = min(4096, max(0, 5000 - 3))
        assert [m.offset for m in msgs] == list(range(3, 3 + want))
    assert answers["port"] == answers["jax"]
    r = tkw._Reader(answers["port"])
    r.i32()
    (_, [(_, err, hwm, blob)]), = r.array(lambda rd: (rd.string(), rd.array(
        lambda p: (p.i32(), p.i16(), p.i64(), p.bytes_()))))
    assert (err, hwm) == (0, 5000) and len(blob) <= max_bytes
    got = tkw.decode_message_set(blob)
    assert got == tkw._decode_message_set_py(blob)
    assert [e[0] for e in got] == list(range(3, 3 + len(got)))


# -------------------------------------------------------------- failover
@pytest.mark.parametrize("bad", ["x:1", ", 9O92", "[::1]:3,[fe80::1]",
                                 "a:1, b ,c:9O92,d:2", ",,", "h", "[::1",
                                 "host:", ":9092"])
def test_parse_bootstrap_matches_jax(bad):
    assert t_net.parse_bootstrap(bad) == j_net.parse_bootstrap(bad)


@pytest.mark.parametrize("srv_kind", list(PKG))
def test_bootstrap_failover_past_a_dead_address(srv_kind):
    backing = PKG[srv_kind]["Broker"]()
    backing.produce("t", b"x")
    with serving(srv_kind, backing) as (srv, _):
        c = client("port", f"127.0.0.1:1, 127.0.0.1:{srv.port}")
        assert [m.value for m in c.fetch("t", 0, 0)] == [b"x"]
        c.close()
    for kind in PKG:
        with pytest.raises(OSError):
            PKG[kind]["kw"].KafkaWireBroker("127.0.0.1:1,127.0.0.1:2",
                                            timeout_s=1.0)


def _two_servers(kind):
    b1, b2 = PKG[kind]["Broker"](), PKG[kind]["Broker"]()
    for b in (b1, b2):
        b.create_topic("t", partitions=1)
        for i in range(3):
            b.produce("t", f"m{i}".encode())
    kw = PKG[kind]["kw"]
    return kw.KafkaWireServer(b1).start(), kw.KafkaWireServer(b2).start()


@pytest.mark.parametrize("srv_kind", list(PKG))
def test_failover_retries_idempotent_apis_only(srv_kind):
    s1, s2 = _two_servers(srv_kind)
    try:
        c = client("port", f"127.0.0.1:{s1.port},127.0.0.1:{s2.port}")
        assert c.produce("t", b"on-leader") == 3
        s1.kill()
        # non-idempotent: surfaced, not silently retried
        with pytest.raises(ConnectionError, match="non-idempotent"):
            c.produce("t", b"during-failover")
        # ...but the client reconnected: an explicit redelivery lands
        assert c.produce("t", b"redelivered") == 3
        # reads fail over transparently
        assert [m.value for m in c.fetch("t", 0, 0)] == \
            [b"m0", b"m1", b"m2", b"redelivered"]
        s2.kill()
        with pytest.raises(ConnectionError):
            c.commit("g", "t", 0, 1)  # OffsetCommit: same contract
        c.close()
    finally:
        for s in (s1, s2):
            s.server_close()


@pytest.mark.parametrize("srv_kind", list(PKG))
def test_failover_fetch_is_transparent(srv_kind):
    s1, s2 = _two_servers(srv_kind)
    try:
        c = client("port", f"127.0.0.1:{s1.port},127.0.0.1:{s2.port}")
        assert len(c.fetch("t", 0, 0)) == 3
        s1.kill()
        assert [m.value for m in c.fetch("t", 0, 0)] == [b"m0", b"m1", b"m2"]
        assert c.end_offset("t") == 3
        c.close()
    finally:
        for s in (s1, s2):
            s.server_close()


def test_idempotent_apis_match_jax():
    """The retry table equals JAX's (RAW_FETCH in, RAW_PRODUCE out), and
    the served table equals JAX's, CLUSTER_ADMIN included."""
    names = ("FETCH", "RAW_FETCH", "METADATA", "LIST_OFFSETS",
             "OFFSET_FETCH", "API_VERSIONS", "SASL_HANDSHAKE", "HEARTBEAT",
             "FIND_COORDINATOR")
    assert tkw.IDEMPOTENT_APIS == {getattr(jkw, n) for n in names} == \
        jkw.IDEMPOTENT_APIS
    assert tkw.RAW_PRODUCE not in tkw.IDEMPOTENT_APIS
    assert (tkw.RAW_FETCH, tkw.RAW_PRODUCE, tkw.ERR_CORRUPT_MESSAGE) == \
        (jkw.RAW_FETCH, jkw.RAW_PRODUCE, jkw.ERR_CORRUPT_MESSAGE)
    assert jkw._SUPPORTED == tkw._SUPPORTED
    assert (tkw.CLUSTER_ADMIN, tkw.ERR_NOT_COORDINATOR,
            tkw.ERR_UNKNOWN_SERVER) == (jkw.CLUSTER_ADMIN,
                                        jkw.ERR_NOT_COORDINATOR,
                                        jkw.ERR_UNKNOWN_SERVER)


# ---------------------------------------------------- retention, over wire
@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_consumer_outrun_by_retention_parks_over_the_wire(cli, srv_kind):
    """The retention chase of test_torch_resolve.py's in-memory case, with
    the log behind a wire server: OffsetOutOfRangeError crosses the wire
    with the earliest offset, four resets, then an empty batch with the
    cursor parked, never a raise."""
    class Trimming(PKG[srv_kind]["Broker"]):
        def fetch(self, topic, partition, offset, max_messages=1024):
            for i in range(10):
                self.produce(topic, str(i).encode(), partition=partition)
            return super().fetch(topic, partition, offset, max_messages)

    backing = Trimming()
    backing.create_topic("t", retention_messages=5)
    with serving(srv_kind, backing) as (srv, _):
        c = client(cli, srv)
        consumer = PKG[cli]["StreamConsumer"](c, ["t:0:0"], group="g",
                                              eof=False)
        polls = [[m.offset for m in consumer.poll()] for _ in range(3)]
        assert polls == [[], [], []]
        # each fetch adds 10 records; the chase and begin_offset calls of
        # the wire client see the server's base each time
        assert consumer.positions() == [("t", 0, 115)]
        assert backing.begin_offset("t", 0) == 115
        if cli == "port":
            assert consumer.autoresets == 12
        with pytest.raises(PKG[cli]["OffsetOutOfRange"]) as err:
            c.fetch("t", 0, 0)
        assert err.value.earliest == 125
        c.close()


# ---------------------------------------------------------- remote groups
def _group_script(kind, srv):
    """Two members with fixed ids over one server: joins, a heal, fenced
    commits (own, peer's, stale), an empty-positions commit, a leave and
    the survivor's takeover; returns what each step answered."""
    kw = PKG[kind]["kw"]
    c1, c2 = client(kind, srv), client(kind, srv)
    r1 = kw.RemoteGroupCoordinator(c1, "g")
    r2 = kw.RemoteGroupCoordinator(c2, "g")
    trace = [r1.join(["t"], "m-a")]
    trace.append(r2.join(["t"], "m-b"))
    trace.append(r1.heartbeat("m-a", trace[0][1]))  # stale: rejoin
    m1, g1, a1 = r1.join(["t"], "m-a")
    trace.append((m1, g1, a1))
    _, g2, a2 = trace[1]
    trace.append(r1.fenced_commit(m1, g1, [("t", p, 10 + p) for _, p in a1]))
    trace.append(r2.fenced_commit("m-b", g2, [("t", p, 20 + p)
                                              for _, p in a2]))
    trace.append(c1.commit_fenced("g", g1, m1, [(a2[0][0], a2[0][1], 5)]))
    trace.append(r1.fenced_commit(m1, g1, []))
    trace.append(r1.fenced_commit(m1, g1 - 1, []))
    trace.append(c2.commit_fenced("g", 1, "ghost", [("t", 0, 0)]))
    trace.append(sorted(c1.committed_many("g", [("t", p)
                                                for p in range(5)]).items()))
    r2.leave("m-b")
    trace.append(r1.heartbeat(m1, g1))
    trace.append(r1.join(["t"], m1))
    c1.close()
    c2.close()
    return trace


def test_remote_group_coordinator_matches_jax():
    traces = {}
    for kind in PKG:
        backing = PKG[kind]["Broker"]()
        backing.create_topic("t", partitions=5)
        with serving(kind, backing) as (srv, _):
            traces[kind] = _group_script(kind, srv)
    assert traces["port"] == traces["jax"]
    t = traces["port"]
    assert t[3][1] == 2 and len(t[3][2]) + len(t[1][2]) == 5
    assert t[4] is True and t[5] is True and t[6] is False
    assert (t[7], t[8], t[9]) == (True, False, False)
    assert t[12] == ("m-a", 3, [("t", p) for p in range(5)])


@pytest.mark.parametrize("cli,srv_kind", PAIRS)
def test_group_consumers_split_and_heal_over_the_wire(cli, srv_kind):
    """Two clients, as two pods, split the partitions, drain, commit, and
    a leave hands everything to the survivor (JAX's
    test_cross_process_consumer_groups_over_wire)."""
    backing = PKG[srv_kind]["Broker"]()
    backing.create_topic("t", partitions=6)
    for i in range(120):
        backing.produce("t", f"r{i}".encode(), partition=i % 6)
    kw, GC = PKG[cli]["kw"], PKG[cli]["GroupConsumer"]
    with serving(srv_kind, backing) as (srv, _):
        c1, c2 = client(cli, srv), client(cli, srv)
        g1 = GC(kw.RemoteGroupCoordinator(c1, "g"), ["t"], member_id="m-1")
        g2 = GC(kw.RemoteGroupCoordinator(c2, "g"), ["t"], member_id="m-2")
        seen = [m.value for m in g1.poll(1)]  # heal after g2's join
        assert g1.assignment == [("t", p) for p in range(3)]
        assert g2.assignment == [("t", p) for p in range(3, 6)]
        for g in (g1, g2):
            while True:
                msgs = g.poll()
                if not msgs:
                    break
                seen.extend(m.value for m in msgs)
        assert sorted(seen) == sorted(f"r{i}".encode() for i in range(120))
        assert g1.commit() is True and g2.commit() is True
        assert [backing.committed("g", "t", p) for p in range(6)] == [20] * 6
        g2.close()
        g1.poll()
        assert g1.assignment == [("t", p) for p in range(6)]
        c1.close()
        c2.close()


# ------------------------------------------------------------- write-back
@pytest.mark.parametrize("retention", [None, 4])
def test_broker_produce_many_matches_jax(retention):
    got = {}
    for kind in PKG:
        b = PKG[kind]["Broker"]()
        b.create_topic("t", partitions=3, retention_messages=retention)
        lasts = [b.produce_many("t", [(b"car-%d" % (i % 5), b"v%d" % i, i)
                                      for i in range(20)]),
                 b.produce_many("t", [(None, b"u%d" % i, 0)
                                      for i in range(7)]),
                 b.produce_many("t", [(None, b"x", 1), (b"k", b"y", 2)],
                                partition=1),
                 b.produce_many("t", []),
                 b.produce_many("auto", [(None, b"z", 0)])]
        logs = [[(m.offset, m.key, m.value, m.timestamp_ms)
                 for m in b.fetch("t", p, b.begin_offset("t", p), 100)]
                for p in range(3)]
        got[kind] = (lasts, logs, [b.begin_offset("t", p) for p in range(3)],
                     b.topic("auto").partitions)
    assert got["port"] == got["jax"]


def test_flush_is_one_produce_many():
    class Counting(Broker):
        calls = []

        def produce_many(self, topic, entries, partition=None):
            self.calls.append(("produce_many", len(list(entries))))
            return super().produce_many(topic, entries, partition=partition)

        def produce(self, *a, **kw):
            self.calls.append(("produce", 1))
            return super().produce(*a, **kw)

    b = Counting()
    out = OutputSequence(b, "preds", partition=0)
    jb = JBroker()
    jout = JOutputSequence(jb, "preds", partition=0)
    for i in (2, 0, 1, 3):
        out[i] = f"row{i}"
        jout[i] = f"row{i}"
    assert out.flush() == jout.flush() == 4
    assert b.calls == [("produce_many", 4)]
    assert [m.value for m in b.fetch("preds", 0, 0)] == \
        [m.value for m in jb.fetch("preds", 0, 0)] == \
        [b"row0", b"row1", b"row2", b"row3"]


def test_flush_over_the_wire_is_one_produce_request():
    with serving("port") as (srv, backing):
        c = client("port", srv)
        c.create_topic("preds")
        keys = []
        real = c._request
        c._request = lambda k, *a: (keys.append(k), real(k, *a))[1]
        out = OutputSequence(c, "preds", partition=0)
        for i in range(500):
            out[i] = f"row{i}"
        assert out.flush() == 500
        assert keys == [tkw.PRODUCE]
        assert backing.end_offset("preds", 0) == 500
        c.close()


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("argv,env", [
    ([], {}),
    ([], {"IOTML_BROKER_SASL_USERNAME": "svc",
          "IOTML_BROKER_SASL_PASSWORD": "s3cret"}),
    (["--broker.sasl_username=a", "--broker.sasl_password", "b"],
     {"IOTML_BROKER_SASL_USERNAME": "env"}),
    (["--broker.sasl_password=flag"],
     {"IOTML_BROKER_SASL_USERNAME": "svc",
      "IOTML_BROKER_SASL_PASSWORD": "env"}),
])
def test_broker_config_matches_jax(argv, env):
    t_cfg, t_left = t_config.load_config(["x", *argv], env=env)
    j_cfg, j_left = j_config.load_config(["x", *argv], env=env)
    assert t_left == j_left == ["x"]
    fields = ("sasl_username", "sasl_password")
    assert [getattr(t_cfg.broker, f) for f in fields] == \
        [getattr(j_cfg.broker, f) for f in fields]
    assert {k for k in t_cfg.applied if k.startswith("broker.")} == \
        {k for k in j_cfg.applied if k.startswith("broker.")}


def test_broker_config_rejects_what_jax_rejects():
    for argv in (["--broker.sasl_username"], ["--broker.nope=1"]):
        with pytest.raises(ValueError):
            t_config.load_config(argv, env={})
        with pytest.raises(ValueError):
            j_config.load_config(argv, env={})


@pytest.mark.parametrize("field,value", [
    ("servers", "kafka:9092"), ("partitions", "4"),
    ("retention_messages", "100")])
@pytest.mark.parametrize("layer", ["flag", "env", "file"])
def test_broker_keys_nothing_reads_raise(tmp_path, field, value, layer):
    """The JAX package parses these and never reads them: the port refuses
    them rather than accept a setting that does nothing."""
    argv, env = [], {}
    if layer == "flag":
        argv = [f"--broker.{field}={value}"]
    elif layer == "env":
        env = {f"IOTML_BROKER_{field.upper()}": value}
    else:
        path = tmp_path / "cfg.json"
        path.write_text(f'{{"broker": {{"{field}": "{value}"}}}}')
        env = {"IOTML_CONFIG": str(path)}
    with pytest.raises(ValueError, match=f"'broker.{field}' is not read"):
        t_config.load_config(argv, env=env)
    j_cfg, _ = j_config.load_config(argv, env=env)  # JAX: parsed, unread
    assert f"broker.{field}" in j_cfg.applied


def test_concurrent_clients_append_every_record():
    with serving("port") as (srv, _):
        cs = [client("port", srv) for _ in range(3)]
        threads = []

        def work(c, i):
            c.produce_many("t", [(None, b"%d" % i, 0)] * 50, partition=0)

        for i, c in enumerate(cs):
            threads.append(threading.Thread(target=work, args=(c, i)))
            threads[-1].start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
            assert not t.is_alive()
        assert cs[0].end_offset("t", 0) == 150
        for c in cs:
            c.close()
