"""The port's data plane held against the JAX package: framing, the Avro
codec (pure and native), the broker and consumer, the generator's
publish, and ``SensorBatches`` over a consumer.

Tolerance: none.  Wire bytes, decoded columns, offsets, partitions,
committed cursors and batches (``x``, ``n_valid``, ``first_index``,
labels) must be equal: both packages run the same numpy arithmetic and
the same byte layouts.
"""

import shutil
import zlib

import numpy as np
import pytest

from iotml.core import schema as j_schema
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.ops import avro as j_avro
from iotml.ops import framing as j_framing
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml_torch.core import schema as t_schema
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.ops import avro as t_avro
from iotml_torch.ops import framing as t_framing
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker, OffsetOutOfRangeError
from iotml_torch.stream.consumer import StreamConsumer, parse_spec
from iotml_torch.stream.producer import OutputSequence

SCHEMAS = {"ksql": (t_schema.KSQL_CAR_SCHEMA, j_schema.KSQL_CAR_SCHEMA),
           "producer": (t_schema.CAR_SCHEMA, j_schema.CAR_SCHEMA)}


def _records(schema, n=32, seed=0, nulls=False):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        r = {}
        for f in schema.fields:
            if nulls and f.nullable and (i + len(r)) % 5 == 0:
                r[f.name] = None
            elif f.avro_type == "string":
                r[f.name] = ["false", "true", ""][i % 3]
            elif f.avro_type in ("int", "long"):
                r[f.name] = int(rng.integers(-50, 3000))
            else:
                r[f.name] = float(np.float32(rng.uniform(-100, 8000)))
        recs.append(r)
    return recs


# ------------------------------------------------------------- framing
@pytest.mark.parametrize("schema_id", [0, 1, 1002, 2**31 - 1])
def test_framing_matches_jax(schema_id):
    payload = bytes(range(40))
    framed = t_framing.frame(payload, schema_id)
    assert framed == j_framing.frame(payload, schema_id)
    assert t_framing.unframe(framed) == j_framing.unframe(framed) == \
        (schema_id, payload)
    assert t_framing.strip_frame(framed) == j_framing.strip_frame(framed)
    with pytest.raises(ValueError, match="magic"):
        t_framing.unframe(b"\x01" + framed[1:])
    assert str(t_framing.CorruptFrameError(3, "crc")) == \
        str(j_framing.CorruptFrameError(3, "crc"))


# ---------------------------------------------------------------- avro
def test_zigzag_matches_jax():
    for n in [0, 1, -1, 63, -64, 64, 2**31 - 1, -2**31, 2**62, -2**63]:
        enc = t_avro.zigzag_encode(n)
        assert enc == j_avro.zigzag_encode(n)
        assert t_avro.zigzag_decode(enc, 0) == (n, len(enc))


@pytest.mark.parametrize("which,nulls", [("ksql", False), ("ksql", True),
                                         ("producer", False)])
def test_pure_codec_matches_jax(which, nulls):
    t_sch, j_sch = SCHEMAS[which]
    recs = _records(t_sch, nulls=nulls)
    tc, jc = t_avro.AvroCodec(t_sch), j_avro.AvroCodec(j_sch)
    msgs = [tc.encode(r) for r in recs]
    assert msgs == [jc.encode(r) for r in recs]
    assert [tc.decode(m) for m in msgs] == [jc.decode(m) for m in msgs]
    got, want = tc.decode_batch(msgs), jc.decode_batch(msgs)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert list(got[name]) == list(want[name])
    np.testing.assert_array_equal(tc.sensor_matrix(got),
                                  jc.sensor_matrix(want))


@pytest.mark.parametrize("which", sorted(SCHEMAS))
def test_native_codec_matches_pure(which):
    t_sch, _ = SCHEMAS[which]
    py, nat = t_avro.AvroCodec(t_sch), native.NativeCodec(t_sch)
    recs = _records(t_sch, n=64, seed=3)
    framed = [t_framing.frame(py.encode(r)) for r in recs]
    num, lab = nat.decode_batch(framed, strip=5)
    cols = py.decode_batch([t_framing.strip_frame(m) for m in framed])
    np.testing.assert_array_equal(num, py.sensor_matrix(cols))
    if t_sch.label_field:
        assert [v.decode() for v in lab[:, 0]] == \
            list(cols[t_sch.label_field])
    # encode: byte parity with the pure codec, framed and bare
    assert nat.encode_batch(num, lab, schema_id=1) == framed
    assert nat.encode_batch(num, lab) == \
        [t_framing.strip_frame(m) for m in framed]


def test_native_decode_nulls_and_malformed_rows():
    sch = t_schema.KSQL_CAR_SCHEMA
    py, nat = t_avro.AvroCodec(sch), native.NativeCodec(sch)
    num, lab = nat.decode_batch([py.encode({f.name: None
                                            for f in sch.fields})])
    assert np.all(num == 0.0) and lab[0, 0] == b""
    good = t_framing.frame(py.encode(_records(sch, 1)[0]))
    with pytest.raises(ValueError, match="row 1"):
        nat.decode_batch([good, b"\x00\x00\x00\x00\x01\xff"], strip=5)
    # a 10-byte varint with payload past bit 63 is malformed, not wrapped
    with pytest.raises(ValueError, match="row 0"):
        nat.decode_batch([b"\x00\x00\x00\x00\x01" + b"\x80" * 9 + b"\x7e"],
                         strip=5)


def test_native_build_failure_raises_with_compiler_output(tmp_path):
    for name in native.SOURCES + native.HEADERS:
        shutil.copy(native.CPP / name, tmp_path / name)
    good = native.library_path(tmp_path)
    (tmp_path / "fmt_engine.cc").write_text(
        (tmp_path / "fmt_engine.cc").read_text() + "\nnot C++ at all;\n")
    # an edited source is a new library name: a stale build never loads
    assert native.library_path(tmp_path) != good
    with pytest.raises(RuntimeError, match="build failed") as ei:
        native.build(tmp_path)
    assert "fmt_engine.cc" in str(ei.value)
    assert not native.library_path(tmp_path).exists()


def test_native_library_name_covers_the_target_machine(monkeypatch):
    here = native.library_path()
    monkeypatch.setattr(native, "_target_machine",
                        lambda: b"12.2.0\n  -march=  znver4\n")
    # a library built for another CPU or compiler is another name
    assert native.library_path() != here


# --------------------------------------------------- broker and consumer
def test_produce_fetch_offsets():
    b = Broker()
    b.create_topic("t", partitions=2)
    offs = [b.produce("t", f"m{i}".encode(), partition=0) for i in range(5)]
    assert offs == [0, 1, 2, 3, 4]
    assert [m.value for m in b.fetch("t", 0, 0)] == \
        [f"m{i}".encode() for i in range(5)]
    assert (b.end_offset("t", 0), b.end_offset("t", 1)) == (5, 0)
    assert b.fetch("t", 0, 3)[0].offset == 3
    assert b.produce_batch("t", [b"x", b"y"], partition=1) == 1
    assert b.topics() == ["t"] and b.topic("t").partitions == 2
    b.produce("auto", b"v")  # a missing topic is created, 1 partition
    assert b.topic("auto").partitions == 1


def test_keyed_partitioning_matches_jax():
    t, j = Broker(), JBroker()
    for br in (t, j):
        br.create_topic("t", partitions=10)
    for i in range(40):
        key = f"car{i % 7}".encode()
        t.produce("t", b"v", key=key, timestamp_ms=i)
        j.produce("t", b"v", key=key, timestamp_ms=i)
    for p in range(10):
        assert [(m.key, m.offset, m.timestamp_ms)
                for m in t.fetch("t", p, 0, 100)] == \
            [(m.key, m.offset, m.timestamp_ms)
             for m in j.fetch("t", p, 0, 100)]
        assert all(zlib.crc32(m.key) % 10 == p for m in t.fetch("t", p, 0))


@pytest.mark.parametrize("kw", [
    {"retention_messages": 1},
    {"retention_messages": 10},
    {"retention_messages": 29},
])
def test_retention_matches_jax(kw):
    t, j = Broker(), JBroker()
    for br in (t, j):
        br.create_topic("t", **kw)
        for i in range(30):
            br.produce("t", b"x" * 10, partition=0,
                       timestamp_ms=1000 + i * 100)
    assert (t.begin_offset("t", 0), t.end_offset("t", 0)) == \
        (j.begin_offset("t", 0), j.end_offset("t", 0))
    base = t.begin_offset("t", 0)
    assert base > 0
    with pytest.raises(OffsetOutOfRangeError) as ei:
        t.fetch("t", 0, 0)
    assert ei.value.earliest == base
    assert t.fetch("t", 0, base)[0].offset == base


def test_retention_edges():
    b = Broker()
    with pytest.raises(ValueError):
        b.create_topic("bad", retention_messages=-2)
    assert "bad" not in b.topics()
    b.create_topic("t0", retention_messages=0)  # 0: unbounded
    for i in range(5):
        b.produce("t0", str(i).encode(), partition=0)
    assert (b.begin_offset("t0", 0), b.end_offset("t0", 0)) == (0, 5)


def test_consumer_auto_resets_to_earliest_after_trim():
    b = Broker()
    b.create_topic("t", retention_messages=5)
    for i in range(3):
        b.produce("t", str(i).encode(), partition=0)
    c = StreamConsumer(b, ["t:0:0"], group="g", eof=False)
    assert [m.value for m in c.poll()] == [b"0", b"1", b"2"]
    lagging = StreamConsumer(b, ["t:0:0"], group="g2", eof=False)
    for i in range(3, 20):
        b.produce("t", str(i).encode(), partition=0)
    assert [m.offset for m in lagging.poll()] == [15, 16, 17, 18, 19]
    assert lagging.autoresets == 1


def test_parse_spec():
    assert parse_spec("topic:3:500") == ("topic", 3, 500)
    assert parse_spec("topic:3") == ("topic", 3, 0)
    assert parse_spec("topic") == ("topic", 0, 0)


def test_consumer_eof_seek_and_positions():
    b = Broker()
    for i in range(7):
        b.produce("t", str(i).encode(), partition=0)
    c = StreamConsumer(b, ["t:0:2"])
    assert [m.value for m in c] == [b"2", b"3", b"4", b"5", b"6"]
    assert c.at_end() and c.positions() == [("t", 0, 7)]
    c.seek_to_start()
    assert [m.value for m in c][0] == b"2"
    c.seek("t", 0, 5)
    assert [m.value for m in c.poll()] == [b"5", b"6"]
    with pytest.raises(KeyError):
        c.seek("t", 1, 0)


def test_consumer_round_robin_matches_jax():
    t, j = Broker(), JBroker()
    for br in (t, j):
        br.create_topic("t", partitions=3)
        for p in range(3):
            for i in range(4 + p):
                br.produce("t", f"p{p}m{i}".encode(), partition=p)
    specs = [f"t:{p}:0" for p in range(3)]
    tc, jc = StreamConsumer(t, specs), JStreamConsumer(j, specs)
    for n in (2, 5, 100, 100):
        assert [(m.partition, m.value) for m in tc.poll(n)] == \
            [(m.partition, m.value) for m in jc.poll(n)]
    assert tc.positions() == jc.positions()


def test_commit_resume_and_rewind_match_jax():
    t, j = Broker(), JBroker()
    out = []
    for br, cls in ((t, StreamConsumer), (j, JStreamConsumer)):
        for i in range(10):
            br.produce("t", str(i).encode(), partition=0)
        c = cls(br, ["t:0:0"], group="g")
        c.poll(4)
        c.commit()
        c.poll(3)
        c.rewind_to_committed()
        resumed = cls.from_committed(br, "t", [0], group="g")
        fresh = cls.from_committed(br, "t", [0], group="other",
                                   fallback_offset=2)
        out.append((br.committed("g", "t", 0), br.committed("x", "t", 0),
                    c.positions(), resumed.poll(1)[0].value,
                    fresh.positions()))
    assert out[0] == out[1] == (4, None, [("t", 0, 4)], b"4",
                                [("t", 0, 2)])


@pytest.mark.parametrize("to_broker", [True, False])
def test_output_sequence_orders_and_detects_gaps(to_broker):
    b = Broker()
    seq = OutputSequence(b, "out", partition=0) if to_broker \
        else OutputSequence()

    def published():
        if to_broker:
            return [m.value for m in b.fetch("out", 0, 0)]
        return [m for _, m in seq.published]

    seq.setitem(2, "two")
    seq.setitem(0, "zero")
    seq[1] = b"one"
    assert seq.flush() == 3
    assert published() == [b"zero", b"one", b"two"]
    seq.setitem(5, "five")
    seq.setitem(7, "seven")
    with pytest.raises(ValueError, match="gaps"):
        seq.flush()
    assert seq.flush(allow_gaps=True) == 2
    assert published()[-2:] == [b"five", b"seven"]
    seq.setitem(9, "x")
    with pytest.raises(ValueError, match="duplicate"):
        seq.setitem(9, "again")
    with pytest.raises(ValueError):
        OutputSequence(b)


# ------------------------------------------------------------- publish
@pytest.mark.parametrize("seed", [11, 23])
@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("which", sorted(SCHEMAS))
def test_publish_matches_jax(which, partitions, seed):
    t_sch, j_sch = SCHEMAS[which]
    t, j = Broker(), JBroker()
    scen = dict(num_cars=30, failure_rate=0.3, seed=seed)
    n_t = FleetGenerator(FleetScenario(**scen)).publish(
        t, "T", n_ticks=4, schema=t_sch, partitions=partitions)
    n_j = JFleetGenerator(JFleetScenario(**scen)).publish(
        j, "T", n_ticks=4, schema=j_sch, partitions=partitions)
    assert n_t == n_j == 120
    for p in range(partitions):
        assert [(m.offset, m.key, m.value, m.timestamp_ms)
                for m in t.fetch("T", p, 0, 1000)] == \
            [(m.offset, m.key, m.value, m.timestamp_ms)
             for m in j.fetch("T", p, 0, 1000)]


def test_car_id_matches_jax():
    for i in (0, 42, 99_999):
        assert FleetScenario().car_id(i) == JFleetScenario().car_id(i)


# ----------------------------------------------- SensorBatches over a topic
def _topics(partitions=1, num_cars=50, ticks=20, failure_rate=0.2):
    t, j = Broker(), JBroker()
    scen = dict(num_cars=num_cars, failure_rate=failure_rate)
    FleetGenerator(FleetScenario(**scen)).publish(
        t, "T", n_ticks=ticks, partitions=partitions)
    JFleetGenerator(JFleetScenario(**scen)).publish(
        j, "T", n_ticks=ticks, partitions=partitions)
    specs = [f"T:{p}:0" for p in range(partitions)]
    return StreamConsumer(t, specs), JStreamConsumer(j, specs)


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        assert g.x.dtype == w.x.dtype == np.float32
        np.testing.assert_array_equal(g.mask, w.mask)
        assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
        if w.labels is None:
            assert g.labels is None
        else:
            assert list(g.labels) == list(w.labels)


@pytest.mark.parametrize("kw", [
    {"batch_size": 100, "only_normal": True},                # train
    {"batch_size": 100, "skip": 3, "take": 4, "keep_labels": True},
    {"batch_size": 37, "only_normal": True, "keep_labels": True},
    {"batch_size": 64, "pad_tail": False, "take": 20},
    {"batch_size": 100, "skip": 2, "take": 5, "only_normal": True},
    {"batch_size": 30, "take": 7, "poll_chunk": 41, "only_normal": True},
    {"batch_size": 50, "partitions": 3, "keep_labels": True},
])
def test_sensor_batches_over_consumer_match_jax(kw):
    kw = dict(kw)
    tc, jc = _topics(partitions=kw.pop("partitions", 1))
    _assert_same_batches(list(SensorBatches(tc, **kw)),
                         list(JSensorBatches(jc, **kw)))
    assert tc.positions() == jc.positions()


def test_sensor_batches_epochs_cache_and_cursor_match_jax():
    for cache in (False, True):
        tc, jc = _topics()
        tb = SensorBatches(tc, batch_size=100, take=4, only_normal=True,
                           cache=cache)
        jb = JSensorBatches(jc, batch_size=100, take=4, only_normal=True,
                            cache=cache)
        for tit, jit in zip(tb.epochs(3), jb.epochs(3)):
            _assert_same_batches(list(tit), list(jit))
    # a second iter() continues where the first stopped; skip applies once
    tc, jc = _topics()
    tb = SensorBatches(tc, batch_size=100, skip=2, take=3)
    jb = JSensorBatches(jc, batch_size=100, skip=2, take=3)
    for _ in range(3):
        _assert_same_batches(list(tb), list(jb))
        assert tc.positions() == jc.positions()


def test_sensor_batches_reads_the_native_engine():
    tc, _ = _topics(ticks=3)
    before = native.stats["decode_rows"]
    assert sum(b.n_valid for b in SensorBatches(tc, batch_size=40)) == 150
    assert native.stats["decode_rows"] - before == 150
    with pytest.raises(TypeError):
        SensorBatches([1, 2, 3])
