"""The port's columnar frame ring (``iotml_torch``: ``FrameDecoder``,
``DecodeRing``, ``StreamConsumer.poll_into``, ``Broker.fetch_raw``,
RAW_FETCH, ``SensorBatches``' columnar leg) held against the JAX
package's data plane on the CPU.

Every case of ``tests/test_dataplane.py`` runs on the port from the same
seeded frames; what it decodes, batches and serves must equal what the
JAX package does with the same bytes, exactly (values bit for bit, NaN
included; labels, keys, cursors, stop flags, tombstone counts, batch
boundaries, frame bytes), and the JAX test's own assertions hold.  The
JAX test's lint case (R14) runs JAX's own lint over the port's tree.
"""

import gc
import tracemalloc
import zlib
from pathlib import Path

import numpy as np
import pytest

from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.ops import framing as j_framing
from iotml.stream import native as j_native
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.kafka_wire import KafkaWireBroker as JWireBroker
from iotml.stream.kafka_wire import KafkaWireServer as JWireServer
from iotml_torch.core.schema import (CAR_SCHEMA_V2_ID, KSQL_CAR_SCHEMA,
                                     KSQL_CAR_SCHEMA_V2)
from iotml_torch.data import pipeline as pl
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.obs import tracing
from iotml_torch.ops import framing
from iotml_torch.ops.avro import AvroCodec
from iotml_torch.store import segment as seg
from iotml_torch.stream import native as native_mod
from iotml_torch.stream.broker import Broker, SchemaIdMismatchError
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer

CODEC = AvroCodec(KSQL_CAR_SCHEMA)
V2_CODEC = AvroCodec(KSQL_CAR_SCHEMA_V2)
TOPIC = "SENSOR_DATA_S_AVRO"
J_NATIVE = j_native.available()


def _record(rng, label="false", with_nulls=False, nan_field=None):
    rec = {}
    for f in KSQL_CAR_SCHEMA.fields:
        if f.name == "FAILURE_OCCURRED":
            rec[f.name] = label
        elif f.avro_type in ("int", "long"):
            rec[f.name] = int(rng.integers(0, 40))
        else:
            rec[f.name] = float(rng.normal())
    if with_nulls:
        rec["SPEED"] = None
        rec["COOLANT_TEMP"] = None
    if nan_field:
        rec[nan_field] = float("nan")
    return rec


def _v2_record(rng, region="eu-west", label="true"):
    rec = _record(rng, label=label)
    rec["REGION"] = region
    return rec


def _seeded_frames(rng, n=64, base_offset=0, schema_id=1,
                   tombstone_at=(), v2_at=(), keyfn=None):
    """Seeded store frames: v1 payloads with nulls and NaN, optional
    tombstones and evolved-writer (v2) frames (``test_dataplane.py``'s)."""
    frames, truth = [], []
    off = base_offset
    for i in range(n):
        key = keyfn(i) if keyfn else f"car-{i % 7}".encode()
        if i in tombstone_at:
            frames.append(seg.encode_record(off, key, None, 1000 + i, None))
            truth.append(("tombstone", None))
        elif i in v2_at:
            rec = _v2_record(rng)
            payload = framing.frame(V2_CODEC.encode(rec), CAR_SCHEMA_V2_ID)
            frames.append(seg.encode_record(off, key, payload, 1000 + i,
                                            None))
            truth.append(("v2", rec))
        else:
            rec = _record(rng, label="true" if i % 9 == 0 else "false",
                          with_nulls=i % 11 == 0,
                          nan_field="THROTTLE_POS" if i % 13 == 0 else None)
            payload = framing.frame(CODEC.encode(rec), schema_id)
            frames.append(seg.encode_record(off, key, payload, 1000 + i,
                                            None))
            truth.append(("v1", rec))
        off += 1
    return b"".join(frames), truth


def _buffers(nc, rows=256, keys=True):
    return (np.zeros((rows, nc.n_numeric), np.float32),
            np.zeros((rows, nc.n_strings), f"S{native_mod.LABEL_STRIDE}"),
            np.zeros((rows,), f"S{native_mod.KEY_STRIDE}") if keys else None)


def _jax_decode(buf, start, cap=256):
    """JAX's native decoder over the same bytes (its Python oracle when
    its engine is not built here)."""
    if not J_NATIVE:
        return j_framing.decode_frames_columnar_py(
            buf, start, J_KSQL, with_keys=True, want_ts=True)
    nc = j_native.NativeCodec(J_KSQL)
    dec = nc.frame_decoder()
    x = np.zeros((cap, nc.n_numeric), np.float32)
    lab = np.zeros((cap, nc.n_strings), "S16")
    keys = np.zeros((cap,), "S64")
    rows, nxt, flags, skipped = dec.decode_into(buf, start, x, lab, keys)
    return (x[:rows], lab[:rows], keys[:rows], nxt, flags, skipped,
            dec.last_ts_min, dec.last_ts_max)


# --------------------------------------------------------- parity oracle
@pytest.mark.parametrize("start", [5, 9, 30])
def test_frame_decoder_matches_python_oracle_bit_exact(start):
    """The native decode == the port's plain version == JAX's decoder and
    JAX's oracle, bit for bit: values (NaN and nulls), labels, keys,
    cursor, stop flags, tombstone skips and event-time bounds, over a v1
    chunk with tombstones and an evolved frame."""
    rng = np.random.default_rng(7)
    buf, _ = _seeded_frames(rng, n=96, base_offset=5,
                            tombstone_at={10, 40}, v2_at={77})
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    dec = nc.frame_decoder()
    x, lab, keys = _buffers(nc)
    rows, nxt, flags, skipped = dec.decode_into(buf, start, x, lab, keys)
    got = (x[:rows], lab[:rows], keys[:rows], nxt, flags, skipped,
           dec.last_ts_min, dec.last_ts_max)
    plain = framing.decode_frames_columnar_py(
        buf, start, KSQL_CAR_SCHEMA, with_keys=True, want_ts=True)
    jax_py = j_framing.decode_frames_columnar_py(
        buf, start, J_KSQL, with_keys=True, want_ts=True)
    for want in (plain, jax_py, _jax_decode(buf, start)):
        assert got[3:] == tuple(want[3:])
        assert np.array_equal(got[0], want[0], equal_nan=True)
        assert np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2])
    assert flags & framing.FRAMES_STOP_SCHEMA  # parked at the v2 frame
    assert rows > 0


def test_frame_decoder_matches_full_python_codec():
    """Ground truth: the float32 columns equal the pure codec's float64
    decode cast to float32 (one rounding either way), labels equal."""
    rng = np.random.default_rng(11)
    buf, truth = _seeded_frames(rng, n=50)
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    x, lab, _ = _buffers(nc, 64, keys=False)
    rows, _, _, _ = nc.frame_decoder().decode_into(buf, 0, x, lab)
    assert rows == 50
    payloads = [framing.strip_frame(v) for _p, _e, _o, _k, v, _t, _h
                in seg.scan_records(buf)]
    want = CODEC.sensor_matrix(CODEC.decode_batch(payloads)) \
        .astype(np.float32)
    assert np.array_equal(x[:rows], want, equal_nan=True)
    col = [f.name for f in KSQL_CAR_SCHEMA.fields
           if f.avro_type == "string"].index("FAILURE_OCCURRED")
    assert [s.decode() for s in lab[:rows, col]] == \
        [r["FAILURE_OCCURRED"] for _k, r in truth]


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.97])
def test_torn_tail_ends_batch_like_recovery(cut):
    rng = np.random.default_rng(3)
    buf, _ = _seeded_frames(rng, n=20)
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    x, lab, _ = _buffers(nc, 32, keys=False)
    torn = buf[: int(len(buf) * cut)]
    rows, nxt, flags, _ = nc.frame_decoder().decode_into(torn, 0, x, lab)
    for o in (framing.decode_frames_columnar_py(torn, 0, KSQL_CAR_SCHEMA),
              j_framing.decode_frames_columnar_py(torn, 0, J_KSQL)):
        assert (rows, nxt, flags) == (o[0].shape[0], o[3], o[4])
        assert np.array_equal(x[:rows], o[0], equal_nan=True)
    assert flags & framing.FRAMES_STOP_TORN
    assert 0 < rows < 20


# ------------------------------------------------ end-to-end batch parity
def _fill(broker, gen_cls=FleetGenerator, scen_cls=FleetScenario,
          n_ticks=40, num_cars=25, partitions=10):
    gen = gen_cls(scen_cls(num_cars=num_cars, failure_rate=0.08))
    return gen.publish(broker, TOPIC, n_ticks=n_ticks,
                       partitions=partitions)


def _batches(broker, consumer_cls=StreamConsumer, batcher=SensorBatches,
             parts=1, group="g", **kw):
    consumer = consumer_cls(broker, [f"{TOPIC}:{p}:0" for p in range(parts)],
                            group=group)
    sb = batcher(consumer, batch_size=100, keep_labels=True,
                 keep_keys=True, **kw)
    return list(sb), sb


def _same(a, b):
    assert len(a) == len(b) and len(a) > 5
    for x, y in zip(a, b):
        assert x.n_valid == y.n_valid and x.first_index == y.first_index
        assert np.array_equal(x.x, y.x, equal_nan=True)
        assert list(x.labels) == list(y.labels)
        assert np.array_equal(x.keys, y.keys)


def test_columnar_batches_equal_python_codec_batches(tmp_path):
    """The acceptance oracle at 10 partitions: the port's columnar
    batches over a durable broker == its per-record batches over an
    in-memory broker of the same records == JAX's columnar batches over
    its durable broker, in order (values, labels, keys, boundaries)."""
    durable = Broker(store_dir=str(tmp_path / "port"))
    memory = Broker()
    jdurable = JBroker(store_dir=str(tmp_path / "jax"))
    for b in (durable, memory):
        _fill(b)
    _fill(jdurable, JFleetGenerator, JFleetScenario)
    try:
        cols, sb = _batches(durable, parts=10, group="columnar")
        assert isinstance(sb._ring, pl.DecodeRing)
        per_record, sb2 = _batches(memory, parts=10, group="records")
        assert sb2._ring is None  # never tried: in memory
        jcols, jsb = _batches(jdurable, JStreamConsumer, JSensorBatches,
                              parts=10, group="jax")
        _same(cols, per_record)
        _same(cols, jcols)
    finally:
        durable.close()
        jdurable.close()


def test_columnar_skips_tombstones(tmp_path):
    broker = Broker(store_dir=str(tmp_path / "store"))
    rng = np.random.default_rng(5)
    for i in range(30):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       key=b"car-1", timestamp_ms=i)
    broker.produce(TOPIC, None, key=b"car-1", timestamp_ms=31)
    for i in range(10):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       key=b"car-2", timestamp_ms=40 + i)
    try:
        batches, sb = _batches(broker, pad_tail=True)
        assert isinstance(sb._ring, pl.DecodeRing)
        assert sum(b.n_valid for b in batches) == 40  # tombstone skipped
    finally:
        broker.close()


# --------------------------------------------------------- the v1 guard
def test_v2_writer_never_misread_on_columnar_path(tmp_path):
    """Evolved (v2) frames on the topic: the ring detours those chunks
    through name resolution, labels stay labels; the same as JAX's."""
    broker = Broker(store_dir=str(tmp_path / "port"))
    jbroker = JBroker(store_dir=str(tmp_path / "jax"))
    rng = np.random.default_rng(9)
    labels = []
    for i in range(260):
        if 100 <= i < 140:  # a rolling upgrade's window of v2 frames
            rec = _v2_record(rng, label="true" if i % 2 else "false")
            payload = framing.frame(V2_CODEC.encode(rec), CAR_SCHEMA_V2_ID)
        else:
            rec = _record(rng, label="true" if i % 5 == 0 else "false")
            payload = framing.frame(CODEC.encode(rec), 1)
        labels.append(rec["FAILURE_OCCURRED"])
        for b in (broker, jbroker):
            b.produce(TOPIC, payload, key=b"car", timestamp_ms=i)
    try:
        batches, sb = _batches(broker)
        assert isinstance(sb._ring, pl.DecodeRing)
        got = [lab for b in batches for lab in b.labels[: b.n_valid]]
        assert got == labels
        assert sum(b.n_valid for b in batches) == 260
        jbatches, _ = _batches(jbroker, JStreamConsumer, JSensorBatches)
        for a, b in zip(batches, jbatches):
            assert np.array_equal(a.x, b.x, equal_nan=True)
    finally:
        broker.close()
        jbroker.close()


def test_v2_guard_fused_wire_path():
    """The native client's fused decode raises SchemaIdMismatchError at
    an evolved frame instead of stripping it blindly, and SensorBatches
    decodes the mixed topic right anyway (the port's server and
    client)."""
    from iotml_torch.stream.native_kafka import NativeKafkaBroker

    broker = Broker()
    rng = np.random.default_rng(13)
    labels = []
    for i in range(60):
        if 20 <= i < 30:
            rec = _v2_record(rng, label="true")
            payload = framing.frame(V2_CODEC.encode(rec), CAR_SCHEMA_V2_ID)
        else:
            rec = _record(rng, label="false")
            payload = framing.frame(CODEC.encode(rec), 1)
        labels.append(rec["FAILURE_OCCURRED"])
        broker.produce(TOPIC, payload, timestamp_ms=i)
    with KafkaWireServer(broker) as srv:
        nb = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        try:
            nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
            with pytest.raises(SchemaIdMismatchError):
                nb.fetch_decode(TOPIC, 0, 20, nc, strip=5)
            num, _lab, nxt = nb.fetch_decode(TOPIC, 0, 0, nc, strip=5)
            assert len(num) == 20 and nxt == 20
            sb = SensorBatches(StreamConsumer(nb, [f"{TOPIC}:0:0"],
                                              group="wire"),
                               batch_size=10, keep_labels=True)
            assert [lab for b in sb for lab in b.labels[: b.n_valid]] == \
                labels
        finally:
            nb.close()


# ------------------------------------------- replay == live, one decoder
def test_replay_and_live_share_one_decoder(tmp_path, monkeypatch):
    """Timestamp-replay backfill and live consume give the same batches,
    and both enter through FrameDecoder.decode_into."""
    broker = Broker(store_dir=str(tmp_path / "store"))
    rng = np.random.default_rng(17)
    for i in range(300):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       key=b"car", timestamp_ms=1_000 + i)
    calls = []
    orig = native_mod.FrameDecoder.decode_into

    def counted(self, *a, **kw):
        calls.append(1)
        return orig(self, *a, **kw)

    monkeypatch.setattr(native_mod.FrameDecoder, "decode_into", counted)
    try:
        live = list(SensorBatches(StreamConsumer(
            broker, [f"{TOPIC}:0:0"], group="live"), batch_size=50))
        live_calls = len(calls)
        assert live_calls > 0
        replay_consumer = StreamConsumer(broker, [f"{TOPIC}:0:0"],
                                         group="replay")
        replay_consumer.seek_to_timestamp(1_100)
        replay = list(SensorBatches(replay_consumer, batch_size=50))
        assert len(calls) > live_calls
        live_rows = np.concatenate([b.x[: b.n_valid] for b in live])
        replay_rows = np.concatenate([b.x[: b.n_valid] for b in replay])
        assert np.array_equal(replay_rows, live_rows[100:], equal_nan=True)
    finally:
        broker.close()


# ------------------------------------------ zero per-record allocations
def test_zero_per_record_python_objects_on_fast_path(tmp_path):
    """Decoding 16x the records through the ring allocates about as many
    Python objects, not 16x: the cost of a chunk is O(1) buffers."""
    broker = Broker(store_dir=str(tmp_path / "store"))
    rng = np.random.default_rng(23)
    broker.produce_many(TOPIC, [
        (b"car", framing.frame(CODEC.encode(_record(rng)), 1), i)
        for i in range(2048)])
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    dec = nc.frame_decoder()
    x, lab, _ = _buffers(nc, 2048, keys=False)

    def count_allocs(rows):
        consumer = StreamConsumer(broker, [f"{TOPIC}:0:0"],
                                  group=f"alloc-{rows}")
        consumer.poll_into(dec, x, lab, max_rows=8)  # warm caches
        gc.collect()
        tracemalloc.start()
        got, _ = consumer.poll_into(dec, x, lab, max_rows=rows)
        snap = tracemalloc.take_snapshot()
        tracemalloc.stop()
        assert got == rows
        return sum(s.count for s in snap.statistics("filename"))

    try:
        small = count_allocs(128)
        big = count_allocs(2040)
        assert big < small * 2 + 64, (small, big)
    finally:
        broker.close()


def test_traced_sessions_keep_the_header_path_in_process(tmp_path,
                                                         monkeypatch):
    """Record headers (the trace carrier) exist only in the in-process
    broker: traced, a durable in-process consumer stays on the message
    leg (no ring), as JAX's does; untraced it takes the ring."""
    from iotml.obs import tracing as j_tracing

    broker = Broker(store_dir=str(tmp_path / "port"))
    jbroker = JBroker(store_dir=str(tmp_path / "jax"))
    _fill(broker, n_ticks=4, partitions=1)
    _fill(jbroker, JFleetGenerator, JFleetScenario, n_ticks=4, partitions=1)
    try:
        monkeypatch.setattr(tracing, "ENABLED", True)
        monkeypatch.setattr(j_tracing, "ENABLED", True)
        _, sb = _batches(broker, group="traced")
        _, jsb = _batches(jbroker, JStreamConsumer, JSensorBatches,
                          group="traced")
        assert sb._ring in (None, False) and jsb._ring in (None, False)
        monkeypatch.setattr(tracing, "ENABLED", False)
        _, sb2 = _batches(broker, group="untraced")
        assert isinstance(sb2._ring, pl.DecodeRing)
    finally:
        broker.close()
        jbroker.close()


# ------------------------------------------------- raw fetch + the wire
@pytest.mark.parametrize("durable", [False, True], ids=["memory", "durable"])
def test_fetch_raw_contract_in_memory_and_durable(tmp_path, durable):
    """fetch_raw hands back real store frames, byte-identical to JAX's
    broker's from the same produces; None at the log end."""
    rng = np.random.default_rng(29)
    brokers = [Broker(store_dir=str(tmp_path / "p") if durable else None),
               JBroker(store_dir=str(tmp_path / "j") if durable else None)]
    values = [framing.frame(CODEC.encode(_record(rng)), 1)
              for _ in range(20)]
    try:
        for b in brokers:
            b.create_topic("T", retention_messages=None)
            for i, v in enumerate(values):
                b.produce("T", v, key=b"k", timestamp_ms=i)
        raw, jraw = (b.fetch_raw("T", 0, 0) for b in brokers)
        assert raw is not None and raw.start_offset == 0
        assert (raw.topic, raw.partition, raw.start_offset, raw.data) == \
            tuple(jraw)
        offs = [off for _p, _e, off, _k, _v, _t, _h
                in seg.scan_records(raw.data)]
        assert offs == list(range(20))
        assert brokers[0].fetch_raw("T", 0, 20) is None
        mid = brokers[0].fetch_raw("T", 0, 7)
        assert mid.data == brokers[1].fetch_raw("T", 0, 7).data
    finally:
        for b in brokers:
            b.close()


@pytest.mark.parametrize("client_pkg", ["port", "jax"])
@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_fetch_raw_wire_out_of_range(client_pkg, server_pkg):
    """RAW_FETCH over each client × server pair: below the retained base
    it raises OffsetOutOfRangeError with the earliest offset; from it,
    the broker's frames come back as they are."""
    from iotml.stream.broker import OffsetOutOfRangeError as JOutOfRange
    from iotml_torch.stream.broker import OffsetOutOfRangeError

    broker = Broker() if server_pkg == "port" else JBroker()
    broker.create_topic("T", retention_messages=5)
    rng = np.random.default_rng(31)
    for i in range(20):
        broker.produce("T", framing.frame(CODEC.encode(_record(rng)), 1),
                       timestamp_ms=i)
    server = (KafkaWireServer if server_pkg == "port" else
              JWireServer)(broker)
    client_cls = KafkaWireBroker if client_pkg == "port" else JWireBroker
    with server as srv:
        wb = client_cls(f"127.0.0.1:{srv.port}")
        try:
            with pytest.raises((OffsetOutOfRangeError, JOutOfRange)) as ei:
                wb.fetch_raw("T", 0, 0)
            assert ei.value.earliest == 15
            raw = wb.fetch_raw("T", 0, 15)
            assert raw is not None and raw.start_offset == 15
            assert raw.data == broker.fetch_raw("T", 0, 15).data
            assert wb.fetch_raw("T", 0, 20) is None
            assert wb.last_hwm("T", 0) == 20
        finally:
            wb.close()


def test_poll_into_autoresets_after_retention_trim():
    """A ring cursor below the retained base resets to the earliest and
    still returns the data in the same poll."""
    rng = np.random.default_rng(37)
    broker = Broker()
    broker.create_topic("T", retention_messages=8)
    for i in range(30):
        broker.produce("T", framing.frame(CODEC.encode(_record(rng)), 1),
                       timestamp_ms=i)
    assert broker.begin_offset("T", 0) == 22
    nc = native_mod.NativeCodec(KSQL_CAR_SCHEMA)
    consumer = StreamConsumer(broker, ["T:0:0"], group="trim")
    x, lab, _ = _buffers(nc, 64, keys=False)
    rows, fb = consumer.poll_into(nc.frame_decoder(), x, lab)
    assert rows == 8 and not fb
    assert consumer.positions() == [("T", 0, 30)]
    assert consumer.autoresets == 1


def test_tombstone_at_cursor_on_fused_wire_path():
    """A tombstone at the cursor of the fused leg: the message-list
    fallback skips it (no payload), never fails on it."""
    from iotml_torch.stream.native_kafka import NativeKafkaBroker

    rng = np.random.default_rng(41)
    broker = Broker()
    for i in range(15):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       key=b"car-1", timestamp_ms=i)
    broker.produce(TOPIC, None, key=b"car-1", timestamp_ms=16)
    for i in range(10):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       key=b"car-2", timestamp_ms=20 + i)
    with KafkaWireServer(broker) as srv:
        nb = NativeKafkaBroker(f"127.0.0.1:{srv.port}")
        try:
            consumer = StreamConsumer(nb, [f"{TOPIC}:0:0"], group="tomb")
            batches = list(SensorBatches(consumer, batch_size=10,
                                         keep_keys=True))
            assert sum(b.n_valid for b in batches) == 25
        finally:
            nb.close()


def test_relay_server_without_raw_downgrades_cleanly():
    """A server whose broker raises NotImplementedError from fetch_raw (a
    relay to an upstream without the extension) answers
    UNSUPPORTED_VERSION: the client pins back to FETCH for good and the
    batches keep flowing."""
    rng = np.random.default_rng(43)
    broker = Broker()
    for i in range(30):
        broker.produce(TOPIC, framing.frame(CODEC.encode(_record(rng)), 1),
                       timestamp_ms=i)

    class Relay:
        def __getattr__(self, name):
            return getattr(broker, name)

        def fetch_raw(self, *a, **kw):
            raise NotImplementedError("upstream lacks RAW_FETCH")

    with KafkaWireServer(Relay()) as srv:
        wb = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        try:
            with pytest.raises(NotImplementedError):
                wb.fetch_raw(TOPIC, 0, 0)
            consumer = StreamConsumer(wb, [f"{TOPIC}:0:0"], group="relay")
            sb = SensorBatches(consumer, batch_size=10)
            assert sum(b.n_valid for b in sb) == 30
            assert consumer._raw_unsupported is True and sb._ring is False
        finally:
            wb.close()


def test_poll_into_none_without_raw_support():
    """A broker without fetch_raw keeps consumers on the other legs."""

    class NoRaw:
        pass

    consumer = StreamConsumer(NoRaw(), ["T:0:0"])
    assert consumer.poll_into(None, None, None) is None


# ------------------------------------------------------- pipeline knobs
def test_pipeline_knobs_never_leak_into_config_tree():
    """The ring's knobs are process toggles (config's NON_CONFIG): the
    resolver neither rejects nor applies them, as JAX's does not."""
    from iotml_torch.config import load_config

    env = {"IOTML_PREFETCH_DEPTH": "3", "IOTML_DECODE_RING_BUFFERS": "8",
           "IOTML_RAW_BATCH_BYTES": "65536"}
    cfg, _ = load_config(argv=[], env=env)
    clean, _ = load_config(argv=[], env={})
    assert cfg.as_dict() == clean.as_dict()
    assert cfg.applied == set()


def test_pipeline_knob_validation(monkeypatch):
    from iotml.data import pipeline as j_pl

    monkeypatch.setenv("IOTML_PREFETCH_DEPTH", "4")
    monkeypatch.setenv("IOTML_DECODE_RING_BUFFERS", "2")
    monkeypatch.setenv("IOTML_RAW_BATCH_BYTES", "8192")
    for mod in (pl, j_pl):
        assert (mod.prefetch_depth(), mod.decode_ring_buffers(),
                mod.raw_batch_bytes()) == (4, 2, 8192)
    for name, bad in (("IOTML_PREFETCH_DEPTH", "0"),
                      ("IOTML_DECODE_RING_BUFFERS", "1"),
                      ("IOTML_RAW_BATCH_BYTES", "nope"),
                      ("IOTML_RAW_BATCH_BYTES", "4095")):
        monkeypatch.setenv(name, bad)
        fn = {"IOTML_PREFETCH_DEPTH": "prefetch_depth",
              "IOTML_DECODE_RING_BUFFERS": "decode_ring_buffers",
              "IOTML_RAW_BATCH_BYTES": "raw_batch_bytes"}[name]
        for mod in (pl, j_pl):
            with pytest.raises(ValueError):
                getattr(mod, fn)()
        monkeypatch.delenv(name)
    with pytest.raises(ValueError):
        pl.DecodeRing(8, 18, 1, n_buffers=1)


@pytest.mark.parametrize("ring", [2, 3])
def test_minimal_ring_still_correct(tmp_path, monkeypatch, ring):
    """The smallest rings with small fetches and an odd chunk must not
    corrupt carried tails: batch parity against the per-record leg and
    JAX's ring holds."""
    monkeypatch.setenv("IOTML_DECODE_RING_BUFFERS", str(ring))
    monkeypatch.setenv("IOTML_RAW_BATCH_BYTES", "16384")
    broker = Broker(store_dir=str(tmp_path / "port"))
    jbroker = JBroker(store_dir=str(tmp_path / "jax"))
    memory = Broker()
    for b in (broker, memory):
        _fill(b, n_ticks=30, partitions=1)
    _fill(jbroker, JFleetGenerator, JFleetScenario, n_ticks=30, partitions=1)
    try:
        cols, sb = _batches(broker, group="ring", poll_chunk=37)
        assert isinstance(sb._ring, pl.DecodeRing) and len(sb._ring) == ring
        per_record, _ = _batches(memory, group="records", poll_chunk=37)
        jcols, _ = _batches(jbroker, JStreamConsumer, JSensorBatches,
                            group="ring", poll_chunk=37)
        _same(cols, per_record)
        _same(cols, jcols)
    finally:
        broker.close()
        jbroker.close()


# ----------------------------------------------------------- lint (R14)
def test_r14_confines_frame_parsing():
    """JAX's own lint rule R14 (frame parsing and encoding only in the
    store, ``ops/framing.py`` and ``stream/native.py``'s binding) holds
    on the port's tree, and still convicts its fixture."""
    from iotml.analysis.lint import lint_file, lint_paths

    fixture = Path(__file__).parent / "fixtures" / "analysis" / "bad_frame.py"
    r14 = [f for f in lint_file(str(fixture), "fixtures/bad_frame.py")
           if f.rule == "R14"]
    assert len(r14) >= 4
    port = Path(__file__).resolve().parent.parent / "iotml_torch"
    assert [f for f in lint_paths([str(port)], rules={"R14"})
            if f.rule == "R14"] == []


@pytest.mark.parametrize("raw_batch_bytes", [65536, 1 << 20])
def test_ring_past_the_sparse_index_gap_falls_back_as_jax(
        tmp_path, monkeypatch, raw_batch_bytes):
    """A produce_many batch leaves one sparse-index entry, so in JAX a
    raw fetch smaller than the batch, from a cursor deep inside it, holds
    only frames below the cursor and the ring falls back one chunk to the
    message-list leg.  The port's read starts at the cursor's own frame
    there, so its ring never falls back; the batches of both stay the
    per-record leg's, and a fetch past the batch falls back in neither."""
    from iotml.stream import consumer as j_consumer
    from iotml_torch.stream import consumer as t_consumer

    monkeypatch.setenv("IOTML_RAW_BATCH_BYTES", str(raw_batch_bytes))
    rng = np.random.default_rng(47)

    def record():
        # float32 sensor values, as a car sends them: the ring's float32
        # columns then hold them exactly, as the per-record leg does
        return {k: float(np.float32(v)) if isinstance(v, float) else v
                for k, v in _record(rng).items()}

    entries = [(b"car-%d" % i, framing.frame(CODEC.encode(record()), 1), i)
               for i in range(2000)]  # ~390 KB: one index entry
    got = {}
    for name, broker, mod, batcher in (
            ("port", Broker(store_dir=str(tmp_path / "p")), t_consumer,
             SensorBatches),
            ("jax", JBroker(store_dir=str(tmp_path / "j")), j_consumer,
             JSensorBatches)):
        broker.create_topic(TOPIC)
        broker.produce_many(TOPIC, entries)
        polls = []
        real = mod.StreamConsumer.poll

        def poll(self, *a, real=real, polls=polls, **kw):
            polls.append(1)
            return real(self, *a, **kw)

        monkeypatch.setattr(mod.StreamConsumer, "poll", poll)
        try:
            consumer = mod.StreamConsumer(broker, [f"{TOPIC}:0:0"],
                                          group="gap")
            got[name] = (list(batcher(consumer, batch_size=100,
                                      keep_keys=True, poll_chunk=256)),
                         len(polls))
        finally:
            broker.close()
    memory = Broker()
    memory.produce_many(TOPIC, entries)
    records, _ = _batches(memory, group="records", poll_chunk=256)
    assert got["port"][1] == 0
    assert (got["jax"][1] > 0) == (raw_batch_bytes < 390_000)
    for a, b in zip(got["port"][0], got["jax"][0]):
        assert np.array_equal(a.x, b.x) and np.array_equal(a.keys, b.keys)
    for a, b in zip(got["port"][0], records):
        assert np.array_equal(a.x, b.x) and np.array_equal(a.keys, b.keys)
    assert len(got["port"][0]) == len(records) == 20


def test_ring_interleaving_across_segment_ends_equals_jax(tmp_path):
    """Over 10 cursors on logs of small segments the ring's fetches end
    at each segment's end, so its interleaving of partitions is its own:
    the port's batches equal JAX's ring's exactly, and hold the
    per-record leg's rows in the same order a partition."""
    from iotml.store.log import StorePolicy as JStorePolicy
    from iotml_torch.store.log import StorePolicy

    port = Broker(store_dir=str(tmp_path / "port"),
                  store_policy=StorePolicy(segment_bytes=16384))
    jax = JBroker(store_dir=str(tmp_path / "jax"),
                  store_policy=JStorePolicy(segment_bytes=16384))
    memory = Broker()
    for b in (port, memory):
        _fill(b, n_ticks=20, num_cars=50)
    _fill(jax, JFleetGenerator, JFleetScenario, n_ticks=20, num_cars=50)
    try:
        cols, sb = _batches(port, parts=10, group="ring", poll_chunk=300)
        assert isinstance(sb._ring, pl.DecodeRing)
        jcols, _ = _batches(jax, JStreamConsumer, JSensorBatches, parts=10,
                            group="ring", poll_chunk=300)
        _same(cols, jcols)
        records, _ = _batches(memory, parts=10, group="records",
                              poll_chunk=300)

        def by_partition(batches):
            x = np.concatenate([b.x[:b.n_valid] for b in batches])
            keys = np.concatenate([b.keys[:b.n_valid] for b in batches])
            part = np.array([zlib.crc32(k) % 10 for k in keys])
            return [(x[part == p], keys[part == p]) for p in range(10)]

        for (xa, ka), (xb, kb) in zip(by_partition(cols),
                                      by_partition(records)):
            assert np.array_equal(xa, xb) and np.array_equal(ka, kb)
    finally:
        port.close()
        jax.close()
