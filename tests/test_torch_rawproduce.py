"""The port's raw produce plane (``iotml_torch``: the frame engine's
encode, restamp and validate; ``Broker.produce_raw``; RAW_PRODUCE on the
wire; ``RawBatchProducer``; the KSQL JSON leg's and the native MQTT
bridge's raw legs) held against the JAX package's on the CPU.

Every case of ``tests/test_rawproduce.py`` but the replication one and
the cluster one (in tests/test_torch_cluster.py) runs on the port with
the same records; the
bytes it frames, stamps, appends and serves must equal the JAX package's
byte for byte, and the JAX test's own assertions hold.  RAW_FETCH and
RAW_PRODUCE also run over every {port, JAX} client × {port, JAX} server
pair.
"""

import gc
import json
import os
import time
import tracemalloc

import numpy as np
import pytest

from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL
from iotml.ops import framing as j_framing
from iotml.stream import native as j_native
from iotml.stream.broker import Broker as JBroker
from iotml.stream.kafka_wire import KafkaWireBroker as JWireBroker
from iotml.stream.kafka_wire import KafkaWireServer as JWireServer
from iotml_torch.chaos import faults as chaos
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.ops import framing
from iotml_torch.stream import native as native_mod
from iotml_torch.stream.broker import Broker, CorruptMessageError
from iotml_torch.stream.kafka_wire import (IDEMPOTENT_APIS, RAW_PRODUCE,
                                           KafkaWireBroker, KafkaWireServer)
from iotml_torch.stream.producer import RawBatchProducer


def _entries(n=40, tombstones=()):
    return [(b"car-%d" % (i % 7), None if i in tombstones else
             b"payload-%d" % i, 1000 + i) for i in range(n)]


def _log_bytes(store_dir, topic, partition):
    root = os.path.join(store_dir, "segments", topic, str(partition))
    out = b""
    for name in sorted(os.listdir(root)):
        if name.endswith(".log"):
            with open(os.path.join(root, name), "rb") as fh:
                out += fh.read()
    return out


# ------------------------------------------------ native == python oracle
def test_frame_entries_native_matches_python_oracle():
    """Opaque-value framing in one engine call == the per-record codec ==
    JAX's framing, with null keys, tombstones and empty values."""
    entries = _entries(24, tombstones=(3, 17))
    entries[5] = (None, b"", 0)          # null key, empty value
    entries[9] = (b"", b"x" * 300, 5)    # empty (non-null) key
    native = framing.frame_entries(entries, base_offset=77)
    oracle = framing.encode_frame_batch(
        (77 + i, e[0], e[1], e[2], None) for i, e in enumerate(entries))
    assert native == oracle == j_framing.frame_entries(entries,
                                                       base_offset=77)


def test_encode_frames_columnar_matches_python_oracle():
    """Avro encode, Confluent header and store frame in one engine call
    == encode_batch + the per-record frame codec == JAX's encode_frames,
    with NaN, a null union and keys, as a list or an S-dtype block."""
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    rng = np.random.default_rng(7)
    n = 16
    numeric = rng.normal(size=(n, nc.n_numeric)).astype(np.float64)
    numeric[3, 2] = np.nan
    labels = np.array([["true" if i % 3 else "false"] for i in range(n)],
                      "S16")
    nulls = np.zeros((n, nc.n_fields), np.uint8)
    nulls[4, 0] = 1
    ts = np.arange(n, dtype=np.int64) + 500
    keys = [b"vehicles/sensor/data/car-%05d" % i for i in range(n)]
    blob = nc.encode_frames(numeric, labels, ts, keys=keys, nulls=nulls,
                            schema_id=1, base_offset=9)
    values = nc.encode_batch(numeric, labels, schema_id=1, nulls=nulls)
    oracle = framing.encode_frame_batch(
        (9 + i, keys[i], values[i], int(ts[i]), None) for i in range(n))
    assert blob == oracle
    assert nc.encode_frames(numeric, labels, ts,
                            keys=np.asarray(keys, "S64"), nulls=nulls,
                            schema_id=1, base_offset=9) == blob
    if j_native.available():
        jnc = j_native.NativeCodec(J_KSQL)
        assert jnc.encode_frames(numeric, labels, ts, keys=keys,
                                 nulls=nulls, schema_id=1,
                                 base_offset=9) == blob


def test_restamp_oracle_and_rejection_without_native(monkeypatch):
    """The plain restamp and validate (``*_py``) agree with JAX's oracles
    on the same frames; a flipped byte is rejected whole."""
    monkeypatch.setattr(j_framing, "_native_lib", lambda: None)
    entries = _entries(12, tombstones=(2,))
    frames = framing.frame_entries(entries)
    stamped, count, max_ts = framing.restamp_frame_batch_py(frames, 40)
    assert (count, max_ts) == (12, 1011)
    assert stamped == framing.encode_frame_batch(
        (40 + i, e[0], e[1], e[2], None) for i, e in enumerate(entries))
    assert (stamped, count, max_ts) == \
        j_framing.restamp_frame_batch(frames, 40)
    bad = bytearray(frames)
    bad[len(bad) // 2] ^= 0xFF
    for fn in (framing.restamp_frame_batch_py, framing.restamp_frame_batch,
               j_framing.restamp_frame_batch):
        with pytest.raises(ValueError):
            fn(bytes(bad), 0)
    v = framing.validate_frame_batch_py(stamped, start_offset=45)
    assert (v["count"], v["first"], v["last"]) == (7, 45, 51)
    assert stamped[v["start_pos"]:v["end_pos"]]
    assert v == j_framing.validate_frame_batch(stamped, start_offset=45)


@pytest.mark.parametrize("strict", [False, True])
def test_restamp_native_matches_oracle(strict):
    """The engine's restamp and validate == their plain versions == JAX's
    (its engine's and its oracle's), torn tails included."""
    frames = framing.frame_entries(_entries(9, tombstones=(1,)))
    native = framing.restamp_frame_batch(frames, 123)
    assert native == framing.restamp_frame_batch_py(frames, 123) == \
        j_framing.restamp_frame_batch(frames, 123)
    torn = native[0][:-7]
    for buf in (native[0], torn):
        try:
            want = framing.validate_frame_batch_py(buf, 125, strict)
        except framing.CorruptFrameError as e:
            with pytest.raises(framing.CorruptFrameError) as got:
                framing.validate_frame_batch(buf, 125, strict)
            assert got.value.index == e.index and strict
            continue
        assert framing.validate_frame_batch(buf, 125, strict) == want == \
            j_framing.validate_frame_batch(buf, 125, strict)


# ------------------------------------------------- segment byte parity
def test_raw_produce_segments_byte_identical_to_classic(tmp_path,
                                                        monkeypatch):
    """A topic ingested through produce_raw is segment-byte-identical to
    the same records through classic produce, and to JAX's produce_raw;
    both serve the same records (tombstones as None)."""
    entries = _entries(60, tombstones=(10, 44))
    frames = framing.frame_entries(entries)
    raw = Broker(store_dir=str(tmp_path / "raw"))
    jraw = JBroker(store_dir=str(tmp_path / "jraw"))
    for b in (raw, jraw):
        b.create_topic("t", partitions=1)
        assert b.produce_raw("t", 0, frames) == 0
        b.flush()
    monkeypatch.setenv("IOTML_RAW_PRODUCE", "off")
    classic = Broker(store_dir=str(tmp_path / "classic"))
    classic.create_topic("t", partitions=1)
    for key, value, ts in entries:
        classic.produce("t", value, key=key, partition=0, timestamp_ms=ts)
    classic.flush()
    try:
        logs = [_log_bytes(str(tmp_path / d), "t", 0)
                for d in ("raw", "classic", "jraw")]
        assert logs[0] == logs[1] == logs[2]
        a, b = raw.fetch("t", 0, 0, 100), classic.fetch("t", 0, 0, 100)
        assert a == b and a[10].value is None
    finally:
        for br in (raw, jraw, classic):
            br.close()


def test_fused_produce_many_byte_identical(tmp_path, monkeypatch):
    """The durable produce_many's one-call framing == the per-record
    encoder's segments == JAX's, on every partition."""
    entries = _entries(80)
    fused = Broker(store_dir=str(tmp_path / "fused"))
    jfused = JBroker(store_dir=str(tmp_path / "jfused"))
    for b in (fused, jfused):
        b.create_topic("t", partitions=3)
        b.produce_many("t", entries)
        b.flush()
    monkeypatch.setenv("IOTML_RAW_PRODUCE", "off")
    classic = Broker(store_dir=str(tmp_path / "classic"))
    classic.create_topic("t", partitions=3)
    classic.produce_many("t", entries)
    classic.flush()
    try:
        for p in range(3):
            assert _log_bytes(str(tmp_path / "fused"), "t", p) == \
                _log_bytes(str(tmp_path / "classic"), "t", p) == \
                _log_bytes(str(tmp_path / "jfused"), "t", p)
    finally:
        for b in (fused, jfused, classic):
            b.close()


# ------------------------------------------- corruption: whole-batch NAK
def test_corrupt_batch_rejected_whole_before_any_byte_lands(tmp_path):
    broker = Broker(store_dir=str(tmp_path / "store"))
    broker.create_topic("t", partitions=1)
    frames = framing.frame_entries(_entries(30))
    broker.produce_raw("t", 0, frames)
    end = broker.end_offset("t", 0)
    broker.flush()
    seg0 = os.path.join(str(tmp_path / "store"), "segments", "t", "0",
                        "00000000000000000000.log")
    size = os.path.getsize(seg0)
    try:
        for cut in (3, len(frames) // 2, len(frames) - 2):
            bad = bytearray(frames)
            bad[cut] ^= 0xFF
            with pytest.raises(CorruptMessageError):
                broker.produce_raw("t", 0, bytes(bad))
            assert broker.end_offset("t", 0) == end
        with pytest.raises(CorruptMessageError):
            broker.produce_raw("t", 0, frames[:-7])  # a torn tail
        broker.flush()
        assert os.path.getsize(seg0) == size
    finally:
        broker.close()


def test_chaos_corrupt_faultpoint_invariants(tmp_path):
    """Seeded corruption at broker.produce_raw: the batch is rejected
    whole (CORRUPT_MESSAGE over the wire), acked counts stay exact, and
    after the producer redelivers, replay and segments equal an
    unfaulted run's and JAX's."""
    frames = [framing.frame_entries(_entries(20)) for _ in range(5)]

    def run(store, with_chaos, pkg="port"):
        broker = (Broker if pkg == "port" else JBroker)(store_dir=store)
        broker.create_topic("t", partitions=1)
        server = (KafkaWireServer if pkg == "port" else JWireServer)(broker)
        acked = rejected = 0
        with server:
            client = KafkaWireBroker(f"127.0.0.1:{server.port}")
            if with_chaos:
                chaos.arm(chaos.ChaosEngine([chaos.FaultEvent(
                    at=3, point="broker.produce_raw", action="corrupt")]))
            try:
                for blob in frames:
                    for _attempt in range(2):
                        try:
                            client.produce_raw("t", 0, blob)
                            acked += 20
                            break
                        except CorruptMessageError:
                            rejected += 1  # nothing landed: redeliver
            finally:
                chaos.disarm()
                client.close()
        replay = [(m.offset, m.key, m.value, m.timestamp_ms)
                  for m in broker.fetch("t", 0, 0, 1000)]
        broker.flush()
        blob = _log_bytes(store, "t", 0)
        broker.close()
        return acked, rejected, replay, blob

    control = run(str(tmp_path / "ctl"), False)
    faulted = run(str(tmp_path / "flt"), True)
    jax = run(str(tmp_path / "jax"), False, "jax")
    assert control[:2] == (100, 0)
    assert faulted[:2] == (100, 1)
    assert faulted[2:] == control[2:] == jax[2:]


# --------------------------------------------------- the fallback ladder
@pytest.mark.parametrize("client_pkg", ["port", "jax"])
def test_raw_produce_less_server_pins_clients_back(monkeypatch, client_pkg):
    """A server without RAW_PRODUCE answers UNSUPPORTED_VERSION: either
    package's client raises NotImplementedError and the port's
    RawBatchProducer (auto) pins back to produce_many for good; under
    ``on`` the fallback is an error; the records are the same."""
    from iotml_torch.stream import kafka_wire as tkw

    broker = Broker()
    broker.create_topic("t", partitions=1)
    supported = dict(tkw._SUPPORTED)
    supported.pop(RAW_PRODUCE)
    monkeypatch.setattr(tkw, "_SUPPORTED", supported)
    entries = _entries(15)
    frames = framing.frame_entries(entries)
    cls = KafkaWireBroker if client_pkg == "port" else JWireBroker
    with KafkaWireServer(broker) as server:
        client = cls(f"127.0.0.1:{server.port}")
        try:
            with pytest.raises(NotImplementedError):
                client.produce_raw("t", 0, frames)
            producer = RawBatchProducer(client, "t", mode="auto")
            assert producer.produce_frames(0, frames, len(entries),
                                           entries=entries) == 0
            assert producer.engaged is False
            producer.produce_frames(0, frames, len(entries),
                                    entries=lambda: entries)
            assert producer.classic_records == 30
            with pytest.raises(NotImplementedError):
                RawBatchProducer(client, "t", mode="on").produce_frames(
                    0, frames, len(entries))
        finally:
            client.close()
    assert [(m.key, m.value, m.timestamp_ms)
            for m in broker.fetch("t", 0, 0, 100)] == entries * 2


def test_raw_produce_deliberately_not_idempotent():
    """RAW_PRODUCE mutates the log, so it is never retried blindly: in
    the served table, out of the retry table, as in JAX's tables."""
    from iotml.stream import kafka_wire as jkw
    from iotml_torch.stream import kafka_wire as tkw

    assert RAW_PRODUCE in tkw._SUPPORTED
    assert RAW_PRODUCE not in IDEMPOTENT_APIS
    assert (RAW_PRODUCE in jkw._SUPPORTED) and \
        RAW_PRODUCE not in jkw.IDEMPOTENT_APIS


def test_knobs_validated_and_not_config(monkeypatch):
    """IOTML_RAW_PRODUCE and IOTML_PRODUCE_BATCH_BYTES are process knobs
    (config NON_CONFIG), validated loudly, as JAX's are."""
    from iotml.data import pipeline as j_pl
    from iotml_torch.config import load_config
    from iotml_torch.data.pipeline import (produce_batch_bytes,
                                           raw_produce_mode, set_knobs)

    monkeypatch.setenv("IOTML_RAW_PRODUCE", "auto")
    monkeypatch.setenv("IOTML_PRODUCE_BATCH_BYTES", "65536")
    load_config([])  # no ValueError: both are NON_CONFIG
    assert (raw_produce_mode(), produce_batch_bytes()) == \
        (j_pl.raw_produce_mode(), j_pl.produce_batch_bytes()) == \
        ("auto", 65536)
    monkeypatch.setenv("IOTML_RAW_PRODUCE", "sometimes")
    with pytest.raises(ValueError):
        raw_produce_mode()
    monkeypatch.setenv("IOTML_PRODUCE_BATCH_BYTES", "12")
    with pytest.raises(ValueError):
        produce_batch_bytes()
    with pytest.raises(ValueError):
        set_knobs(raw_produce="maybe")
    with pytest.raises(ValueError):
        set_knobs(produce_batch_bytes=16)
    assert os.environ["IOTML_PRODUCE_BATCH_BYTES"] == "12"
    set_knobs(raw_produce="off", produce_batch_bytes=8192)
    assert (raw_produce_mode(), produce_batch_bytes()) == ("off", 8192)


# --------------------------------------- the four client × server pairs
@pytest.mark.parametrize("client_pkg", ["port", "jax", "native"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_raw_produce_and_fetch_over_every_pair(tmp_path, client_pkg,
                                               server_pkg):
    """RAW_PRODUCE then RAW_FETCH over {port, JAX, the port's native}
    client × {port, JAX} server on a durable broker: the base offsets,
    the segments and the fetched frames equal the classic produce_many's
    on the same records."""
    from iotml_torch.stream.native_kafka import NativeKafkaBroker

    entries = _entries(50, tombstones=(7,))
    broker = (Broker if server_pkg == "port" else JBroker)(
        store_dir=str(tmp_path / "raw"))
    classic = Broker(store_dir=str(tmp_path / "classic"))
    broker.create_topic("t", partitions=1)
    classic.create_topic("t", partitions=1)
    classic.produce_many("t", entries + entries[:20], partition=0)
    classic.flush()
    server = (KafkaWireServer if server_pkg == "port" else
              JWireServer)(broker)
    cls = {"port": KafkaWireBroker, "jax": JWireBroker,
           "native": NativeKafkaBroker}[client_pkg]
    try:
        with server:
            client = cls(f"127.0.0.1:{server.port}")
            try:
                assert client.produce_raw("t", 0, framing.frame_entries(
                    entries)) == 0
                assert client.produce_raw("t", 0, framing.frame_entries(
                    entries[:20])) == 50
                if client_pkg != "native":
                    raw = client.fetch_raw("t", 0, 30)
                    assert raw.data == classic.fetch_raw("t", 0, 30).data
                    assert client.fetch_raw("t", 0, 70) is None
            finally:
                client.close()
        broker.flush()
        assert _log_bytes(str(tmp_path / "raw"), "t", 0) == \
            _log_bytes(str(tmp_path / "classic"), "t", 0)
    finally:
        broker.close()
        classic.close()


# ------------------------------------------- the KSQL JSON leg, raw
def _pump(monkeypatch, mode, store, pkg="port"):
    """The reference DDL over a durable broker of 4 partitions, 8 ticks of
    16 cars' JSON pumped; every output topic's records."""
    if pkg == "port":
        from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
        from iotml_torch.stream.registry import SchemaRegistry
        from iotml_torch.streamproc import SqlEngine
        from iotml_torch.streamproc.sql import install_reference_pipeline
        broker_cls = Broker
    else:
        from iotml.gen.simulator import FleetGenerator, FleetScenario
        from iotml.stream import SchemaRegistry
        from iotml.streamproc import SqlEngine
        from iotml.streamproc.sql import install_reference_pipeline
        broker_cls = JBroker
    monkeypatch.setenv("IOTML_RAW_PRODUCE", mode)
    broker = broker_cls(store_dir=store)
    broker.create_topic("sensor-data", partitions=4)
    engine = SqlEngine(broker, registry=SchemaRegistry())
    install_reference_pipeline(engine)
    gen = FleetGenerator(FleetScenario(num_cars=16, failure_rate=0.05,
                                       seed=5))
    for tick in range(8):
        cols = gen.step_columns()
        broker.produce_many("sensor-data", [
            (b"vehicles/sensor/data/car-%05d" % i,
             json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA)).encode(),
             1000 + tick) for i in range(16)])
    engine.pump()
    out = {}
    for topic in ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY"):
        spec = broker.topic(topic)
        out[topic] = [[(m.offset, m.key, m.value, m.timestamp_ms)
                       for m in broker.fetch(topic, p, 0, 10000)]
                      for p in range(spec.partitions)]
    broker.close()
    return out


def test_pump_raw_leg_output_identical_to_classic(tmp_path, monkeypatch):
    """The AVRO CSAS's raw JSON→frames leg writes the same topics as the
    classic leg and as JAX's raw leg: keys, bytes, timestamps,
    partitions, offsets."""
    from iotml.stream.producer import raw_produce_records as j_records
    from iotml_torch.stream.producer import raw_produce_records

    before = raw_produce_records.value()
    got_raw = _pump(monkeypatch, "auto", str(tmp_path / "raw"))
    assert raw_produce_records.value() - before == 128
    got_classic = _pump(monkeypatch, "off", str(tmp_path / "classic"))
    jbefore = j_records.value()
    got_jax = _pump(monkeypatch, "auto", str(tmp_path / "jax"), "jax")
    assert j_records.value() - jbefore == 128
    assert got_raw == got_classic == got_jax
    assert sum(len(p) for p in got_raw["SENSOR_DATA_S_AVRO"]) == 128


# --------------------------------------- zero per-record allocation path
def test_zero_per_record_python_objects_on_fused_produce_path(tmp_path):
    """16x the records through columnar frames → produce_raw allocate
    about as many Python objects, not 16x."""
    broker = Broker(store_dir=str(tmp_path / "store"))
    broker.create_topic("t", partitions=1)
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    rng = np.random.default_rng(3)
    numeric = rng.normal(size=(2048, nc.n_numeric)).astype(np.float64)
    labels = np.full((2048, nc.n_strings), b"false", "S16")
    ts = np.arange(2048, dtype=np.int64)
    keys = np.asarray([b"car-%04d" % (i % 50) for i in range(2048)], "S64")

    def count_allocs(rows):
        blob = nc.encode_frames(numeric[:8], labels[:8], ts[:8],
                                keys=keys[:8], schema_id=1)
        broker.produce_raw("t", 0, blob)  # warm everything
        gc.collect()
        tracemalloc.start()
        blob = nc.encode_frames(numeric[:rows], labels[:rows], ts[:rows],
                                keys=keys[:rows], schema_id=1)
        broker.produce_raw("t", 0, blob)
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        return sum(s.count for s in snap.statistics("filename"))

    try:
        small = count_allocs(128)
        big = count_allocs(2048)
        assert big < small * 2 + 64, (small, big)
    finally:
        broker.close()


# -------------------------------------------------- engine-owned topics
def test_raw_produce_respects_topic_ownership():
    for cls in (Broker, JBroker):
        broker = cls()
        broker.create_topic("OWNED_TOPIC", partitions=1)
        token = broker.restrict_topic("OWNED_")
        frames = framing.frame_entries(_entries(5))
        with pytest.raises(PermissionError):
            broker.produce_raw("OWNED_TOPIC", 0, frames)
        with broker.producer_grant(token):
            assert broker.produce_raw("OWNED_TOPIC", 0, frames) == 0


def test_fetch_raw_jumps_compaction_emptied_head_segment(tmp_path):
    """A compaction pass that empties the head segment must not read as
    the log end on the raw path: fetch_raw jumps to the successor, as
    JAX's does, with the same bytes."""
    from iotml.store.log import StorePolicy as JStorePolicy
    from iotml_torch.store.log import StorePolicy

    out = []
    for cls, pol, d in ((Broker, StorePolicy, "port"),
                        (JBroker, JStorePolicy, "jax")):
        broker = cls(store_dir=str(tmp_path / d),
                     store_policy=pol(segment_bytes=256))
        broker.create_topic("C", cleanup_policy="compact")
        for rnd in range(8):
            for k in range(4):
                broker.produce("C", b"v%d" % rnd, key=b"k%d" % k,
                               partition=0, timestamp_ms=1000 + rnd)
        broker.store.log_for("C", 0).roll()
        broker.run_compaction(force=True)
        survivors = broker.fetch("C", 0, 0, 1000)
        raw = broker.fetch_raw("C", 0, 0)
        assert raw is not None
        v = framing.validate_frame_batch(raw.data, start_offset=0)
        assert v["first"] == survivors[0].offset and v["count"] >= 1
        out.append((raw.start_offset, raw.data))
        broker.close()
    assert out[0] == out[1]


def test_wire_raw_produce_tombstones_roundtrip():
    """Tombstones framed into a raw batch land as value-None records over
    the wire (the compaction delete-marker contract)."""
    broker = Broker()
    broker.create_topic("t", partitions=1)
    frames = framing.frame_entries(_entries(6, tombstones=(2, 5)))
    with KafkaWireServer(broker) as server:
        client = KafkaWireBroker(f"127.0.0.1:{server.port}")
        client.produce_raw("t", 0, frames)
        client.close()
    msgs = broker.fetch("t", 0, 0, 10)
    assert msgs[2].value is None and msgs[5].value is None
    assert msgs[0].value == b"payload-0"


def test_raw_produce_families_equal_jax():
    """The four iotml_raw_produce_* families sit in the port's registry,
    described as JAX's."""
    from iotml.obs import metrics as j_metrics
    from iotml.stream import producer as j_producer
    from iotml_torch.obs import metrics as t_metrics
    from iotml_torch.stream import producer as t_producer

    def describe(m):
        return (type(m).__name__, m.name, m.help,
                getattr(m, "buckets", None))

    names = ("raw_produce_records", "raw_produce_fallbacks",
             "raw_produce_append_seconds", "raw_produce_convert_seconds")
    for name in names:
        t, j = getattr(t_producer, name), getattr(j_producer, name)
        assert describe(t) == describe(j)
        assert t_metrics.default_registry._metrics[t.name] is t
        assert j_metrics.default_registry._metrics[j.name] is j


# ------------------------------------------ the native MQTT bridge, raw
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_native_bridge_raw_leg_into_a_wire_client(pkg):
    """The native MQTT bridge into a wire client takes its raw leg
    (frames once, RAW_PRODUCE a partition) as JAX's does, and the
    records land as the classic bridge into an in-process broker lays
    them down: keys, values, partitions and offsets."""
    import iotml.mqtt.native_ingest as j_ni
    import iotml_torch.mqtt.native_ingest as t_ni
    from iotml_torch.mqtt.wire import MqttClient

    def publish(port):
        for i in range(6):  # one connection at a time: a defined order
            c = MqttClient("127.0.0.1", port, f"car-{i}")
            try:
                for k in range(5):
                    c.publish(f"vehicles/sensor/data/car-{i}",
                              b'{"k": %d}' % k, qos=k % 2)
                c.ping()
            finally:
                c.disconnect()

    def bridged(mod, stream):
        bridge = mod.NativeIngestBridge(stream, partitions=3).start()
        try:
            publish(bridge.port)
            deadline = 100
            while bridge.forwarded() < 30 and deadline:
                deadline -= 1
                time.sleep(0.05)
        finally:
            bridge.stop()
        return bridge

    def records(broker):
        return [[(m.offset, m.key, m.value)
                 for m in broker.fetch("sensor-data", p, 0, 1000)]
                for p in range(3)]

    classic = Broker()
    plain = bridged(t_ni, classic)
    assert plain._raw is None  # an in-process broker: produce_many
    backing = Broker() if pkg == "port" else JBroker()
    server = (KafkaWireServer if pkg == "port" else JWireServer)(backing)
    with server:
        client = (KafkaWireBroker if pkg == "port" else JWireBroker)(
            f"127.0.0.1:{server.port}")
        try:
            bridge = bridged(t_ni if pkg == "port" else j_ni, client)
        finally:
            client.close()
    assert bridge._raw is not None and bridge._raw.engaged is True
    assert bridge._raw.raw_batches > 0
    assert records(backing) == records(classic)
    assert sum(len(p) for p in records(classic)) == 30
