"""The port's native Kafka client (``iotml_torch.stream.native_kafka``,
``cpp/kafka_client.cc``) held against the port's pure wire client and the
JAX package's native client, on the port's and JAX's wire servers, on the
CPU.

- Round trips (produce, fetch, offsets, commits, ``commit_many`` in one
  request), SASL/PLAIN good and bad, an unknown topic, an idempotent
  create and two threads sharing one client give the same answers from
  every client on every server.
- The fused ``fetch_decode`` / ``fetch_decode_keys`` equals the
  per-message fetch + ``NativeCodec`` decode bit for bit: per partition,
  across a fetch cut mid-entry, at a partition's end, and as
  ``SensorBatches`` (the fused leg against the message-list leg).
- The schema-id guard: an evolved writer's frame stops the fused decode;
  the batcher takes exactly one chunk through the resolving leg and
  resumes; batches equal the JAX package's over its own native client.
- An entry size under 14 bytes (-1, 0, 2, 3, 13) in a hand-built fetch
  response raises instead of reading past the buffer; this one runs
  against the port's client only (JAX's reads ~2^64 bytes past it).

Every server binds 127.0.0.1:0.  Tolerance: none; everything is exact.
"""

import socket
import struct
import threading
import warnings

import numpy as np
import pytest

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.stream import kafka_wire as jkw
from iotml.stream import native as j_native
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.native_kafka import NativeKafkaBroker as JNativeKafkaBroker
from iotml_torch.core import schema as t_schema
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.ops import avro as t_avro
from iotml_torch.ops import framing as t_framing
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker, SchemaIdMismatchError
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.native_kafka import (KafkaProtocolError,
                                             NativeKafkaBroker)

TIMEOUT_S = 5.0
TOPIC = "SENSOR_DATA_S_AVRO"
CREDS = ("svc", "pw")
SERVERS = {"port": (tkw.KafkaWireServer, Broker),
           "jax": (jkw.KafkaWireServer, JBroker)}
CLIENTS = {"port_native": lambda a, **kw: NativeKafkaBroker(
               a, timeout_s=TIMEOUT_S, **kw),
           "port_wire": lambda a, **kw: tkw.KafkaWireBroker(
               a, timeout_s=TIMEOUT_S, **kw),
           "jax_native": lambda a, **kw: JNativeKafkaBroker(
               a, timeout_s=TIMEOUT_S, **kw)}


def setup_module(_):
    assert j_native.available(), "the JAX package's native engine must build"


def _fleet(n_ticks=20, cars=30, failure_rate=0.2, partitions=2):
    """(key, framed value, ts, partition) of a generated fleet."""
    b = Broker()
    FleetGenerator(FleetScenario(num_cars=cars,
                                 failure_rate=failure_rate)).publish(
        b, TOPIC, n_ticks=n_ticks, partitions=partitions)
    return [(m.key, m.value, m.timestamp_ms, p) for p in range(partitions)
            for m in b.fetch(TOPIC, p, 0, b.end_offset(TOPIC, p))]


def _backing(kind, msgs=(), partitions=2):
    backing = SERVERS[kind][1]()
    backing.create_topic(TOPIC, partitions=partitions)
    for key, value, ts, p in msgs:
        backing.produce(TOPIC, value, key=key, partition=p, timestamp_ms=ts)
    return backing


def _serve(kind, backing, **kw):
    return SERVERS[kind][0](backing, **kw)


# ---------------------------------------------------------- round trips
def _roundtrip(client) -> dict:
    """Every Broker duck-type call of the scenario; what each returned."""
    out = {}
    client.create_topic("t", partitions=3)
    out["parts"] = client.topic("t").partitions
    out["offsets"] = [client.produce("t", b"hello", key=b"car-1"),
                      client.produce("t", b"world", key=b"car-1",
                                     timestamp_ms=7)]
    p = [p for p in range(3) if client.end_offset("t", p) == 2][0]
    out["p"] = p
    out["fetch"] = [(m.offset, m.value, m.key, m.timestamp_ms)
                    for m in client.fetch("t", p, 0)]
    out["fetch_from_1"] = [m.value for m in client.fetch("t", p, 1)]
    out["end_begin"] = (client.end_offset("t", p), client.begin_offset("t", p))
    client.create_topic("raw", partitions=1)
    # NUL bytes, an empty value, an empty key, a null key, a tombstone
    client.produce("raw", b"\x00\x01\xffdata\x00", partition=0)
    client.produce_many("raw", [(None, b"", 0), (b"", b"ek", 3),
                                (None, b"nk", 4), (b"k", None, 5)],
                        partition=0)
    out["raw"] = [(m.offset, m.value, m.key, m.timestamp_ms)
                  for m in client.fetch("raw", 0, 0)]
    out["raw_capped"] = [m.offset for m in client.fetch("raw", 0, 1,
                                                        max_messages=2)]
    client.create_topic("mp", partitions=4)
    out["mp_last"] = client.produce_many(
        "mp", [(f"car-{i % 4}".encode(), f"v{i}".encode(), i)
               for i in range(20)])
    out["mp"] = {p: [(m.key, m.value) for m in client.fetch("mp", p, 0)]
                 for p in range(4)}
    out["committed_none"] = client.committed("g", "t", 0)
    client.commit("g", "t", 0, 5)
    client.commit_many("g", "mp", [(p, p + 1) for p in range(4)])
    out["committed"] = [client.committed("g", "t", 0)] + \
        [client.committed("g", "mp", p) for p in range(4)]
    out["committed_many"] = client.committed_many(
        "g", [("mp", 1), ("mp", 3), ("t", 2)])
    # idempotent create, unknown topic
    out["recreate"] = client.create_topic("t", partitions=3).partitions
    with pytest.raises(KeyError):
        client.topic("missing")
    with pytest.raises(KeyError):
        client.fetch("missing", 0, 0)
    return out


@pytest.mark.parametrize("server", list(SERVERS))
def test_roundtrip_answers_equal_across_clients(server):
    got = {}
    for name, make in CLIENTS.items():
        with _serve(server, SERVERS[server][1]()) as srv:
            client = make(f"127.0.0.1:{srv.port}")
            try:
                got[name] = _roundtrip(client)
            finally:
                client.close()
    want = got["port_wire"]
    assert want["raw"][-1] == (4, None, b"k", 5)  # the tombstone stays None
    assert got["port_native"] == want
    assert got["jax_native"] == want


@pytest.mark.parametrize("server", list(SERVERS))
def test_sasl_plain_good_and_bad(server):
    backing = SERVERS[server][1]()
    backing.produce("t", b"secret")
    with _serve(server, backing, credentials=CREDS) as srv:
        addr = f"127.0.0.1:{srv.port}"
        for make in CLIENTS.values():
            ok = make(addr, sasl_username=CREDS[0], sasl_password=CREDS[1])
            assert [m.value for m in ok.fetch("t", 0, 0)] == [b"secret"]
            ok.close()
            with pytest.raises(ConnectionError):
                make(addr, sasl_username=CREDS[0], sasl_password="wrong")


def test_unreachable_server_raises_oserror():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    with pytest.raises(OSError):
        NativeKafkaBroker(f"127.0.0.1:{port}", timeout_s=1.0)


@pytest.mark.parametrize("server", list(SERVERS))
def test_two_threads_share_one_client(server):
    """One socket and one staging area a handle: concurrent produce and
    fetch from two threads are serialized by the client's lock."""
    with _serve(server, SERVERS[server][1]()) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        client.create_topic("cc", partitions=1)
        n, errors = 200, []

        def producer():
            try:
                for i in range(n):
                    client.produce("cc", f"m{i}".encode(), partition=0)
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        def consumer():
            try:
                seen = off = 0
                while seen < n:
                    msgs = client.fetch("cc", 0, off)
                    for m in msgs:
                        assert m.value == f"m{m.offset}".encode()
                    seen += len(msgs)
                    off += len(msgs)
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        threads = [threading.Thread(target=producer),
                   threading.Thread(target=consumer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        assert client.end_offset("cc", 0) == n
        client.close()


def test_commit_many_is_one_request(monkeypatch):
    backing = Broker()
    backing.create_topic("T", partitions=4)
    for p in range(4):
        for i in range(5):
            backing.produce("T", f"v{p}{i}".encode(), partition=p)
    seen = []
    real = tkw._KafkaConn._offset_commit

    def spy(self, broker, r, w):
        seen.append(1)
        return real(self, broker, r, w)

    monkeypatch.setattr(tkw._KafkaConn, "_offset_commit", spy)
    with tkw.KafkaWireServer(backing) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        c = StreamConsumer(client, [f"T:{p}:0" for p in range(4)],
                           group="gc")
        while c.poll(100):
            pass
        c.commit()
        assert len(seen) == 1
        assert [client.committed("gc", "T", p) for p in range(4)] == \
            [5, 5, 5, 5]
        client.close()


# ------------------------------------------------------------ fused decode
def _decode_loop(client, codec, p, keys: bool, max_rows: int):
    """Every row of partition p through fetch_decode(_keys), and through
    fetch + NativeCodec, in fetches of at most max_rows."""
    fused, ref, off_f, off_r = [], [], 0, 0
    while True:
        if keys:
            num, lab, ks, nxt = client.fetch_decode_keys(
                TOPIC, p, off_f, codec, max_rows=max_rows)
        else:
            (num, lab, nxt), ks = client.fetch_decode(
                TOPIC, p, off_f, codec, max_rows=max_rows), None
        msgs = client.fetch(TOPIC, p, off_r, max_messages=max_rows)
        if not msgs:
            assert len(num) == 0 and nxt == off_f
            return fused, ref
        rnum, rlab = codec.decode_batch([m.value for m in msgs], strip=5)
        assert nxt == msgs[-1].offset + 1
        fused.append((num, lab, ks))
        ref.append((rnum, rlab, [m.key for m in msgs]))
        off_f, off_r = nxt, msgs[-1].offset + 1


@pytest.mark.parametrize("server", list(SERVERS))
@pytest.mark.parametrize("keys", [False, True])
@pytest.mark.parametrize("max_rows", [7, 4096])
def test_fetch_decode_equals_per_message_decode(server, keys, max_rows):
    codec = native.NativeCodec(t_schema.KSQL_CAR_SCHEMA)
    msgs = _fleet()
    with _serve(server, _backing(server, msgs)) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        for p in range(2):
            fused, ref = _decode_loop(client, codec, p, keys, max_rows)
            assert sum(len(f[0]) for f in fused) == \
                sum(1 for m in msgs if m[3] == p)
            for (num, lab, ks), (rnum, rlab, rkeys) in zip(fused, ref):
                np.testing.assert_array_equal(num, rnum)
                assert num.dtype == np.float64
                np.testing.assert_array_equal(lab, rlab)
                if keys:
                    assert list(ks) == rkeys
        assert client.keys_maybe_truncated == 0
        client.close()


@pytest.mark.parametrize("cut_back", [1, 7, 25, 40])
def test_fetch_decode_across_a_fetch_cut_mid_entry(monkeypatch, cut_back):
    """A server that cuts its fetch answer inside the last entry (as a
    max_bytes cut does): both legs drop the partial entry and resume from
    it, and the rows over the whole partition equal the log's."""
    real = tkw.encode_message_set
    monkeypatch.setattr(tkw, "encode_message_set",
                        lambda ents: real(ents)[:-cut_back]
                        if len(ents) > 1 else real(ents))
    codec = native.NativeCodec(t_schema.KSQL_CAR_SCHEMA)
    msgs = _fleet(partitions=1)
    with tkw.KafkaWireServer(_backing("port", msgs, 1)) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        fused, ref = _decode_loop(client, codec, 0, True, 4096)
        client.close()
    assert len(fused) > 1  # the cut made the loop fetch again
    want, _ = codec.decode_batch([m[1] for m in msgs], strip=5)
    np.testing.assert_array_equal(np.concatenate([f[0] for f in fused]),
                                  want)
    np.testing.assert_array_equal(np.concatenate([r[0] for r in ref]), want)
    assert [k for f in fused for k in f[2]] == [m[0] for m in msgs]


@pytest.mark.parametrize("kw", [
    {"batch_size": 32, "keep_labels": True, "keep_keys": True},
    {"batch_size": 32, "only_normal": True, "keep_keys": True},
    {"batch_size": 50, "skip": 1, "take": 4, "keep_labels": True,
     "keep_keys": True},
    {"batch_size": 100},
])
def test_sensor_batches_fused_equal_message_list_and_jax(kw):
    """SensorBatches over the native client (the fused leg) equals the
    port's over the in-process broker and over the pure wire client (the
    message-list leg) and JAX's over its native client: rows, labels,
    keys, valid counts, indices and cursors."""
    msgs = _fleet(partitions=3)
    specs = [f"{TOPIC}:{p}:0" for p in range(3)]
    runs = {"inproc": list(SensorBatches(
        StreamConsumer(_backing("port", msgs, 3), specs), **kw))}
    with tkw.KafkaWireServer(_backing("port", msgs, 3)) as srv:
        for name, make in (("native", NativeKafkaBroker),
                           ("wire", tkw.KafkaWireBroker)):
            client = make(f"127.0.0.1:{srv.port}")
            batches = SensorBatches(StreamConsumer(client, specs), **kw)
            assert batches._fused() == (name == "native")
            runs[name] = list(batches)
            client.close()
    with jkw.KafkaWireServer(_backing("jax", msgs, 3)) as srv:
        client = JNativeKafkaBroker(f"127.0.0.1:{srv.port}")
        runs["jax"] = list(JSensorBatches(JStreamConsumer(client, specs),
                                          **kw))
        client.close()
    want = runs["inproc"]
    assert len(want) > 0
    for name, got in runs.items():
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.x, w.x)
            assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
            if kw.get("keep_labels"):
                assert list(g.labels) == list(w.labels)
            if kw.get("keep_keys"):
                assert g.keys.dtype == np.dtype("S64")
                assert list(g.keys) == list(w.keys), name


def test_keys_fit_the_stride_and_long_keys_are_cut_alike():
    """Car ids fit KEY_STRIDE - 1 bytes; a longer key is cut there on
    both legs, counted, and warned about once."""
    assert native.KEY_STRIDE == 64
    car = FleetScenario(num_cars=100).car_id(99).encode()
    assert len(car) < native.KEY_STRIDE - 1
    msgs = _fleet(partitions=1)
    long_key = b"k" * 100
    msgs = [(long_key if i % 5 == 0 else k, v, t, p)
            for i, (k, v, t, p) in enumerate(msgs)]
    kw = {"batch_size": 32, "keep_keys": True}
    spec = [f"{TOPIC}:0:0"]
    want = list(SensorBatches(StreamConsumer(_backing("port", msgs, 1),
                                             spec), **kw))
    with tkw.KafkaWireServer(_backing("port", msgs, 1)) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = list(SensorBatches(StreamConsumer(client, spec), **kw))
        assert client.keys_maybe_truncated == len(msgs[::5])
        assert sum(issubclass(w.category, RuntimeWarning)
                   for w in caught) == 1
        client.close()
    for g, w in zip(got, want):
        assert list(g.keys) == list(w.keys)
    assert got[0].keys[0] == long_key[:native.KEY_STRIDE - 1]
    assert got[0].keys[1] == msgs[1][0]


# ------------------------------------------------------------ schema guard
def _to_v2(value: bytes) -> bytes:
    rec = t_avro.AvroCodec(t_schema.KSQL_CAR_SCHEMA).decode(value[5:])
    rec["REGION"] = "eu-central"
    return t_framing.frame(t_avro.AvroCodec(
        t_schema.KSQL_CAR_SCHEMA_V2).encode(rec), t_schema.CAR_SCHEMA_V2_ID)


@pytest.mark.parametrize("every", [3, 100])
def test_schema_id_guard_takes_one_chunk_and_resumes(monkeypatch, every):
    msgs = [(k, _to_v2(v) if i % every == 1 else v, t, p)
            for i, (k, v, t, p) in enumerate(_fleet(partitions=1))]
    codec = native.NativeCodec(t_schema.KSQL_CAR_SCHEMA)
    with tkw.KafkaWireServer(_backing("port", msgs, 1)) as srv:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        # the fused decode stops BEFORE the first v2 frame (offset 1)
        num, _, nxt = client.fetch_decode(TOPIC, 0, 0, codec)
        assert (len(num), nxt) == (1, 1)
        with pytest.raises(SchemaIdMismatchError):
            client.fetch_decode(TOPIC, 0, 1, codec)
        consumer = StreamConsumer(client, [f"{TOPIC}:0:0"])
        polls, errors = [], []
        real_poll, real_fused = consumer.poll, consumer.poll_decoded

        def poll(limit):
            polls.append(real_poll(limit))
            return polls[-1]

        def fused(*a, **kw):
            try:
                return real_fused(*a, **kw)
            except SchemaIdMismatchError as e:
                errors.append(e)
                raise

        monkeypatch.setattr(consumer, "poll", poll)
        monkeypatch.setattr(consumer, "poll_decoded", fused)
        kw = {"batch_size": 40, "keep_labels": True, "keep_keys": True}
        got = list(SensorBatches(consumer, **kw))
        client.close()
    assert errors and len(polls) == len(errors)
    assert all(polls)  # each detour took one non-empty chunk
    want = list(SensorBatches(StreamConsumer(_backing("port", msgs, 1),
                                             [f"{TOPIC}:0:0"]), **kw))
    with jkw.KafkaWireServer(_backing("jax", msgs, 1)) as srv:
        jclient = JNativeKafkaBroker(f"127.0.0.1:{srv.port}")
        jgot = list(JSensorBatches(JStreamConsumer(jclient, [f"{TOPIC}:0:0"]),
                                   **kw))
        jclient.close()
    assert len(got) == len(want) == len(jgot) > 0
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.x, j.x)
        assert list(g.labels) == list(w.labels) == list(j.labels)
        assert list(g.keys) == list(w.keys) == list(j.keys)
    assert consumer.positions() == [(TOPIC, 0, len(msgs))]


# ------------------------------------------------- entry sizes under 14
class _FakeFetchServer:
    """Answers every request with one Fetch v2 response carrying ``ms``
    as partition 0's message set (the client under test asks nothing
    else after connecting without SASL)."""

    def __init__(self, ms: bytes):
        self.ms = ms
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(1)
        self.port = self.sock.getsockname()[1]
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        conn, _ = self.sock.accept()
        with conn:
            while True:
                head = conn.recv(4, socket.MSG_WAITALL)
                if len(head) < 4:
                    return
                (size,) = struct.unpack(">i", head)
                req = conn.recv(size, socket.MSG_WAITALL)
                corr = struct.unpack(">i", req[4:8])[0]
                topic = TOPIC.encode()
                body = (struct.pack(">ii", corr, 0) + struct.pack(">i", 1)
                        + struct.pack(">h", len(topic)) + topic
                        + struct.pack(">iihq", 1, 0, 0, 100)
                        + struct.pack(">i", len(self.ms)) + self.ms)
                conn.sendall(struct.pack(">i", len(body)) + body)

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("size", [-1, 0, 2, 3, 13])
def test_entry_size_under_14_raises(size):
    """The JAX client accepts any size >= 0 and, for 0-3, runs its CRC
    over ~2^64 bytes past the buffer; the port's refuses the set, and
    its pure decoder raises for the same bytes."""
    ms = struct.pack(">qi", 0, size) + b"\x00" * 40
    with pytest.raises(ValueError, match="message size"):
        tkw._decode_message_set_py(ms)
    codec = native.NativeCodec(t_schema.KSQL_CAR_SCHEMA)
    srv = _FakeFetchServer(ms)
    try:
        client = NativeKafkaBroker(f"127.0.0.1:{srv.port}",
                                   timeout_s=TIMEOUT_S)
        with pytest.raises(ValueError, match="under 14 bytes"):
            client.fetch(TOPIC, 0, 0)
        with pytest.raises(ValueError, match="under 14 bytes"):
            client.fetch_decode(TOPIC, 0, 0, codec)
        with pytest.raises(ValueError, match="under 14 bytes"):
            client.fetch_decode_keys(TOPIC, 0, 0, codec)
        client.close()
    finally:
        srv.close()


def test_protocol_errors_map_to_names():
    err = KafkaProtocolError(-1035, "x")
    assert (err.code, str(err)) == (35, "x: kafka error UNSUPPORTED_VERSION")
    assert KafkaProtocolError(-2, "y").code is None


def test_fused_leg_is_taken_only_over_fetch_decode():
    batches = SensorBatches(StreamConsumer(_backing("port", _fleet(), 2),
                                           [f"{TOPIC}:0:0"]))
    assert not batches._fused()  # the in-process broker has none
