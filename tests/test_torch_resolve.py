"""Two parity repairs of the port's data plane, held against the JAX
package on the CPU:

- schema resolution: a topic written partly under the evolved writer
  schema v2 (``KSQL_CAR_SCHEMA_V2``, frame id 1002: a REGION field before
  the label) is decoded by name through ``ResolvingCodec``, where a
  positional v1 decode would read REGION as the label;
- retention: by bytes and by age the broker trims to the JAX package's
  base offsets, and a consumer outrun by retention on every reset gets an
  empty batch with its cursor parked, as JAX's does, instead of an
  ``OffsetOutOfRangeError``.

Tolerance: none.  Header tests, decoded columns, batches' rows and
labels, base offsets and cursors must be equal.
"""

import numpy as np
import pytest

from iotml.core import schema as j_schema
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.ops import avro as j_avro
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml_torch.core import schema as t_schema
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.ops import avro as t_avro
from iotml_torch.ops import framing as t_framing
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer

V2 = t_schema.CAR_SCHEMA_V2_ID
REGIONS = ("eu-central", None, "us-west", "false")


def _fleet_messages(n_ticks=6, seed_cars=50, failure_rate=0.2):
    """(key, framed v1 value, ts) of a generated fleet, in publish order."""
    b = Broker()
    FleetGenerator(FleetScenario(num_cars=seed_cars,
                                 failure_rate=failure_rate)).publish(
        b, "T", n_ticks=n_ticks)
    return [(m.key, m.value, m.timestamp_ms)
            for m in b.fetch("T", 0, 0, b.end_offset("T", 0))]


def _to_v2(value: bytes, region) -> bytes:
    rec = t_avro.AvroCodec(t_schema.KSQL_CAR_SCHEMA).decode(value[5:])
    rec["REGION"] = region
    return t_framing.frame(
        t_avro.AvroCodec(t_schema.KSQL_CAR_SCHEMA_V2).encode(rec), V2)


def _mixed(every=3, partitions=1):
    """Every ``every``-th record rewritten under writer schema v2."""
    out = []
    for i, (key, value, ts) in enumerate(_fleet_messages()):
        if every and i % every == 1:
            value = _to_v2(value, REGIONS[i % len(REGIONS)])
        out.append((key, value, ts))
    return out


def _topics(msgs, partitions=1):
    t, j = Broker(), JBroker()
    for br in (t, j):
        br.create_topic("T", partitions=partitions)
        for i, (key, value, ts) in enumerate(msgs):
            br.produce("T", value, key=key, partition=i % partitions,
                       timestamp_ms=ts)
    specs = [f"T:{p}:0" for p in range(partitions)]
    return StreamConsumer(t, specs), JStreamConsumer(j, specs)


# ------------------------------------------------------ schema evolution
def test_writer_schemas_match_jax():
    assert t_schema.CAR_SCHEMA_V2_ID == j_schema.CAR_SCHEMA_V2_ID == 1002
    for t, j in ((t_schema.KSQL_CAR_SCHEMA_V2, j_schema.KSQL_CAR_SCHEMA_V2),
                 (t_schema.KSQL_CAR_SCHEMA, j_schema.KSQL_CAR_SCHEMA)):
        assert [(f.name, f.avro_type, f.nullable, f.norm) for f in t.fields] \
            == [(f.name, f.avro_type, f.nullable, f.norm) for f in j.fields]
        assert (t.label_field, t.meta_fields, t.num_sensors) == \
            (j.label_field, j.meta_fields, j.num_sensors)
    assert sorted(t_schema.WRITER_SCHEMAS) == sorted(j_schema.WRITER_SCHEMAS)
    assert {v: sid for v, (_, sid) in t_schema.WRITER_VERSIONS.items()} == \
        {v: sid for v, (_, sid) in j_schema.WRITER_VERSIONS.items()}


@pytest.mark.parametrize("value", [
    b"", b"\x00", b"\x00\x00\x00\x00", b"\x00\x00\x00\x00\x01",
    b"\x00\x00\x00\x00\x01payload", b"\x00\x00\x00\x03\xeapayload",
    b"\x00\x00\x00\x03\xea", b"\x00\x00\x00\x00\x02x", b"\x00\x00\x00\x07\xd0x",
    b"\x01\x00\x00\x03\xeax", b"\xff\xff\xff\xff\xffx", b"{\"json\": 1}",
])
def test_needs_resolution_matches_jax(value):
    assert t_avro.needs_resolution(value) == j_avro.needs_resolution(value)


def test_needs_resolution_flags_only_evolved_frames():
    msgs = _mixed()
    flags = [t_avro.needs_resolution(v) for _, v, _ in msgs]
    assert flags == [i % 3 == 1 for i in range(len(msgs))]


@pytest.mark.parametrize("every", [0, 1, 3])
def test_resolving_codec_columns_match_jax(every):
    values = [v for _, v, _ in _mixed(every=every)]
    # nulls in the sensor fields of a v2 record resolve like v1's
    rec = {f.name: None for f in t_schema.KSQL_CAR_SCHEMA_V2.fields}
    rec["REGION"] = "eu"
    values.append(t_framing.frame(
        t_avro.AvroCodec(t_schema.KSQL_CAR_SCHEMA_V2).encode(rec), V2))
    got = t_avro.ResolvingCodec(t_schema.KSQL_CAR_SCHEMA) \
        .decode_batch_framed(values)
    want = j_avro.ResolvingCodec(j_schema.KSQL_CAR_SCHEMA) \
        .decode_batch_framed(values)
    assert list(got) == list(want)
    assert "REGION" not in got
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert list(got[name]) == list(want[name]), name


def test_incompatible_evolution_raises_like_jax():
    """A required reader field the writer lacks, and an unknown writer
    id, raise ValueError in both packages."""
    def reader(sch):
        return sch.RecordSchema(
            name="R", namespace="n",
            fields=sch.KSQL_CAR_SCHEMA.fields
            + (sch.Field("REQUIRED_NEW", "int"),),
            label_field="FAILURE_OCCURRED")

    value = _mixed(every=0)[0][1]
    for sch, avro in ((t_schema, t_avro), (j_schema, j_avro)):
        codec = avro.ResolvingCodec(reader(sch))
        with pytest.raises(ValueError, match="incompatible schema "
                                             "evolution.*REQUIRED_NEW"):
            codec.decode_batch_framed([value])
        with pytest.raises(ValueError, match="unknown writer schema id 7"):
            avro.ResolvingCodec(sch.KSQL_CAR_SCHEMA).decode_framed(
                b"\x00\x00\x00\x00\x07" + value[5:])


@pytest.mark.parametrize("kw", [
    {"batch_size": 40, "keep_labels": True},
    {"batch_size": 40, "only_normal": True, "keep_labels": True},
    {"batch_size": 64, "skip": 1, "take": 3, "keep_labels": True,
     "partitions": 3},
])
def test_sensor_batches_over_a_mixed_topic_match_jax(kw):
    """The v2 misread: rows and labels of a topic where every third record
    is v2 equal the JAX package's (a positional decode takes REGION for
    the label, so the labels and the normal-only rows differ)."""
    kw = dict(kw)
    tc, jc = _topics(_mixed(), partitions=kw.pop("partitions", 1))
    got, want = list(SensorBatches(tc, **kw)), list(JSensorBatches(jc, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x)
        assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
        assert list(g.labels) == list(w.labels)
    assert tc.positions() == jc.positions()


def test_v1_chunks_keep_the_native_decode(monkeypatch):
    """A poll with no evolved frame never builds the resolving codec; a
    poll with one decodes the whole chunk by name."""
    tc, _ = _topics(_mixed(every=0))
    before = native.stats["decode_rows"]
    batches = SensorBatches(tc, batch_size=100)
    assert sum(b.n_valid for b in batches) == 300
    assert native.stats["decode_rows"] - before == 300
    assert batches._resolving is None
    tc, _ = _topics(_mixed(every=100))
    before = native.stats["decode_rows"]
    batches = SensorBatches(tc, batch_size=100)
    assert sum(b.n_valid for b in batches) == 300
    assert native.stats["decode_rows"] == before
    assert batches._resolving is not None


# ------------------------------------------------------------- retention
@pytest.mark.parametrize("kw", [
    {"retention_bytes": 1},
    {"retention_bytes": 100},
    {"retention_bytes": 255},
    {"retention_ms": 1},
    {"retention_ms": 450},
    {"retention_ms": 2000},
    {"retention_ms": 300, "retention_bytes": 120},
    {"retention_messages": 20, "retention_bytes": 150, "retention_ms": 500},
])
@pytest.mark.parametrize("keyed", [False, True])
def test_retention_by_bytes_and_age_matches_jax(kw, keyed):
    t, j = Broker(), JBroker()
    bases = {"torch": [], "jax": []}
    for name, br in (("torch", t), ("jax", j)):
        br.create_topic("t", partitions=2, **kw)
        for i in range(60):
            # sizes and timestamps that do not grow in step
            br.produce("t", b"x" * (5 + (i * 7) % 13),
                       key=f"k{i % 5}".encode() if keyed else None,
                       partition=i % 2,
                       timestamp_ms=1000 + 37 * i - (200 if i % 9 == 4 else 0))
            bases[name].append([br.begin_offset("t", p) for p in range(2)])
    assert bases["torch"] == bases["jax"]
    for p in range(2):
        assert t.end_offset("t", p) == j.end_offset("t", p)
        base = t.begin_offset("t", p)
        assert [(m.offset, m.value, m.key, m.timestamp_ms)
                for m in t.fetch("t", p, base, 100)] == \
            [(m.offset, m.value, m.key, m.timestamp_ms)
             for m in j.fetch("t", p, base, 100)]


def test_untimestamped_records_never_age_out_and_bounds_validate():
    b = Broker()
    b.create_topic("t", retention_ms=1)
    for i in range(5):
        b.produce("t", b"v", partition=0)
    assert (b.begin_offset("t", 0), b.end_offset("t", 0)) == (0, 5)
    for kw in ({"retention_bytes": -1}, {"retention_ms": -5}):
        with pytest.raises(ValueError, match="must be >= 0"):
            b.create_topic("bad", **kw)
        with pytest.raises(ValueError, match="must be >= 0"):
            JBroker().create_topic("bad", **kw)
    assert "bad" not in b.topics()


def _trimming(base):
    class TrimsOnEveryFetch(base):
        """Retention trims past any cursor between each fetch and the
        next: ten records land before every fetch of a 5-record log."""

        def fetch(self, topic, partition, offset, max_messages=1024):
            for i in range(10):
                self.produce(topic, str(i).encode(), partition=partition)
            return super().fetch(topic, partition, offset, max_messages)

    return TrimsOnEveryFetch


def test_consumer_outrun_by_retention_parks_like_jax():
    """The retention chase: four resets, then an empty batch with the
    cursor parked at the earliest offset, never a raise (JAX
    ``_fetch_autoreset``)."""
    got = {}
    for name, (broker_cls, consumer_cls) in {
            "torch": (_trimming(Broker), StreamConsumer),
            "jax": (_trimming(JBroker), JStreamConsumer)}.items():
        b = broker_cls()
        b.create_topic("t", retention_messages=5)
        c = consumer_cls(b, ["t:0:0"], group="g", eof=False)
        polls = [[m.offset for m in c.poll()] for _ in range(3)]
        got[name] = (polls, c.positions(), b.begin_offset("t", 0))
        if name == "torch":
            assert c.autoresets == 12
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [[], [], []]
    assert got["torch"][1] == [("t", 0, 115)]
