"""The port's synthetic e2e canary (``iotml_torch.obs.canary``) and the
canary firewall of ``SensorBatches(exclude_key_marker=)`` held against
the JAX package's on the same streams.

- The marker, ``is_canary_key``, ``default_slo_rules`` and the probes'
  published payloads are equal to JAX's; a probe's round trip through
  MQTT → bridge → the KSQL stage → its consumer is counted alike
  (sent / ok / lost / inflight), and so are the timeouts and the loop.
- The firewall drops exactly the reserved-id records on every leg: the
  per-message leg (in-process broker, pure wire client, a group
  consumer), the fused ``fetch_decode_keys`` / ``poll_decoded`` leg (the
  native client) and the schema guard's detour; its batches equal JAX's
  and the batches of the same stream without its canaries.

Tolerance: none; rows, labels, keys, counts and cursors are exact.
Every server binds 127.0.0.1:0.
"""

import json

import numpy as np
import pytest

from iotml.cli.up import Platform as JPlatform
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.mqtt.broker import QueueClient as JQueueClient
from iotml.obs import canary as j_canary
from iotml.stream import kafka_wire as jkw
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.native_kafka import NativeKafkaBroker as JNativeKafkaBroker
from iotml_torch.cli.up import Platform
from iotml_torch.core import schema as t_schema
from iotml_torch.data.dataset import RowSource, SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mqtt.broker import QueueClient
from iotml_torch.obs import canary
from iotml_torch.ops import avro as t_avro
from iotml_torch.ops import framing as t_framing
from iotml_torch.stream import kafka_wire as tkw
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.group import GroupConsumer, GroupCoordinator
from iotml_torch.stream.native_kafka import NativeKafkaBroker

TOPIC = "SENSOR_DATA_S_AVRO"
PARTS = 3


def test_marker_and_rules_equal_jax():
    assert canary.CANARY_CAR_PREFIX == j_canary.CANARY_CAR_PREFIX
    assert canary.CANARY_KEY_MARKER == j_canary.CANARY_KEY_MARKER
    for key in (None, b"", b"vehicles/sensor/data/canary-00000001",
                b"vehicles/sensor/data/electric-vehicle-00001",
                b"canary-1", b"x/canary-", b"/CANARY-1"):
        assert canary.is_canary_key(key) == j_canary.is_canary_key(key)
    for scale in (1.0, 0.01):
        assert canary.default_slo_rules(scale) == \
            j_canary.default_slo_rules(scale)


# ----------------------------------------------------------- the firewall
def _to_v2(value: bytes) -> bytes:
    rec = t_avro.AvroCodec(t_schema.KSQL_CAR_SCHEMA).decode(value[5:])
    rec["REGION"] = "eu-central"
    return t_framing.frame(t_avro.AvroCodec(
        t_schema.KSQL_CAR_SCHEMA_V2).encode(rec), t_schema.CAR_SCHEMA_V2_ID)


def _stream(with_canaries=True, v2_every=None):
    """(key, framed value, ts, partition) of a fleet keyed by the bridge's
    MQTT topics, with a canary record after every 7th fleet record."""
    b = Broker()
    sc = FleetScenario(num_cars=30, failure_rate=0.2)
    FleetGenerator(sc).publish(b, TOPIC, n_ticks=15, partitions=PARTS)
    out, seq = [], 0
    for p in range(PARTS):
        for i, m in enumerate(b.fetch(TOPIC, p, 0, b.end_offset(TOPIC, p))):
            value = _to_v2(m.value) if v2_every and i % v2_every == 1 \
                else m.value
            out.append((b"vehicles/sensor/data/" + m.key, value,
                        m.timestamp_ms, p))
            if with_canaries and i % 7 == 3:
                seq += 1
                out.append((b"vehicles/sensor/data/canary-%08d" % seq,
                            m.value, m.timestamp_ms, p))
    return out


def _backing(cls, msgs):
    b = cls()
    b.create_topic(TOPIC, partitions=PARTS)
    for key, value, ts, p in msgs:
        b.produce(TOPIC, value, key=key, partition=p, timestamp_ms=ts)
    return b


SPECS = [f"{TOPIC}:{p}:0" for p in range(PARTS)]


def marker_kw():
    return {"exclude_key_marker": canary.CANARY_KEY_MARKER}
KWARGS = [
    {"batch_size": 32},
    {"batch_size": 32, "keep_keys": True, "keep_labels": True},
    {"batch_size": 32, "only_normal": True},
    {"batch_size": 50, "skip": 1, "take": 4, "keep_keys": True},
]


def _runs(msgs, kw):
    marker = marker_kw()
    runs = {"inproc": list(SensorBatches(StreamConsumer(
        _backing(Broker, msgs), SPECS), **kw, **marker))}
    with tkw.KafkaWireServer(_backing(Broker, msgs)) as srv:
        for name, make in (("native", NativeKafkaBroker),
                           ("wire", tkw.KafkaWireBroker)):
            client = make(f"127.0.0.1:{srv.port}")
            try:
                batches = SensorBatches(StreamConsumer(client, SPECS),
                                        **kw, **marker)
                assert batches._fused() == (name == "native")
                runs[name] = list(batches)
            finally:
                client.close()
    runs["jax_inproc"] = list(JSensorBatches(
        JStreamConsumer(_backing(JBroker, msgs), SPECS), **kw, **marker))
    with jkw.KafkaWireServer(_backing(JBroker, msgs)) as srv:
        for name, make in (("jax_native", JNativeKafkaBroker),
                           ("jax_wire", jkw.KafkaWireBroker)):
            client = make(f"127.0.0.1:{srv.port}")
            try:
                runs[name] = list(JSensorBatches(
                    JStreamConsumer(client, SPECS), **kw, **marker))
            finally:
                client.close()
    return runs


def _same(got, want, kw, name):
    assert len(got) == len(want) > 0, name
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.x, w.x, err_msg=name)
        assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index), \
            name
        if kw.get("keep_labels"):
            assert list(g.labels) == list(w.labels), name
        if kw.get("keep_keys"):
            assert list(g.keys) == list(w.keys), name
        else:
            assert g.keys is None, name


@pytest.mark.parametrize("v2_every", [None, 5], ids=["v1", "schema-mix"])
@pytest.mark.parametrize("kw", KWARGS, ids=["plain", "keys-labels",
                                            "only-normal", "skip-take"])
def test_firewall_equal_jax_on_every_leg(kw, v2_every):
    msgs = _stream(v2_every=v2_every)
    runs = _runs(msgs, kw)
    # each leg against JAX's: the message-list leg (in process), the
    # columnar ring over RAW_FETCH (the pure wire client) and the fused
    # leg (native); with evolved frames the legs order partitions apart,
    # in both packages
    _same(runs["inproc"], runs["jax_inproc"], kw, "inproc")
    _same(runs["wire"], runs["jax_wire"], kw, "wire")
    _same(runs["native"], runs["jax_native"], kw, "native")
    for b in runs["native"]:
        if b.keys is not None:
            assert not any(canary.is_canary_key(k) for k in b.keys)
    if "take" in kw:
        return  # a bounded read cuts polls elsewhere once canaries go
    # the firewall removes exactly the canaries: the same batches as the
    # stream published without them
    clean = list(SensorBatches(StreamConsumer(
        _backing(Broker, _stream(False, v2_every)), SPECS), **kw))
    _same(runs["inproc"], clean, kw, "without canaries")
    # a group consumer (the message-list leg) drops them too
    group = SensorBatches(GroupConsumer(GroupCoordinator(
        _backing(Broker, msgs), "g"), [TOPIC]), **kw, **marker_kw())
    clean_group = SensorBatches(GroupConsumer(GroupCoordinator(
        _backing(Broker, _stream(False, v2_every)), "g"), [TOPIC]), **kw)
    _same(list(group), list(clean_group), kw, "group")


def test_firewall_needs_a_consumer():
    with pytest.raises(ValueError, match="exclude_key_marker"):
        SensorBatches(RowSource(), exclude_key_marker=b"/canary-")


# ----------------------------------------------------------- the probe
class _Unit:
    def __init__(self, beats):
        self.beats = beats
        self.n = 0

    def should_stop(self):
        return self.n >= self.beats

    def heartbeat(self):
        self.n += 1


def _probe_run(plat_cls, probe_mod, qclient_cls, device_kw):
    plat = plat_cls(partitions=2, **device_kw).start()
    try:
        tap = qclient_cls(plat.mqtt_broker, "tap")
        tap.subscribe("vehicles/sensor/data/#")
        probe = probe_mod.CanaryProbe(plat.mqtt_broker, plat.broker,
                                      timeout_s=60.0)
        seqs = [probe.probe_once() for _ in range(3)]
        before = probe.report()
        done_early = probe.observe()  # not pumped yet: nothing arrived
        plat.pump()
        done = probe.observe()
        probe.loop(_Unit(beats=2))  # one more probe, observed
        plat.pump()
        probe.observe()
        late = probe_mod.CanaryProbe(plat.mqtt_broker, plat.broker,
                                     timeout_s=0.0, group="late")
        late.probe_once()
        lost = late.observe()  # no pump: times out at once
        rep, late_rep = probe.report(), late.report()
        for r in (rep, late_rep):
            r.pop("last_e2e_s")
        return (seqs, before, done_early, done, rep, late_rep, lost,
                [(t, json.loads(p)) for t, p, _q, _r in tap.messages])
    finally:
        plat.stop()


def test_probe_round_trip_equal_jax():
    got = _probe_run(Platform, canary, QueueClient, {"device": "cpu"})
    want = _probe_run(JPlatform, j_canary, JQueueClient, {})
    assert got == want
    seqs, _before, early, done, rep, late_rep, _lost, taps = got
    assert (early, done) == (0, 3)
    assert rep == {"sent": 4, "ok": 4, "lost": 0, "trace_sourced": 0,
                   "inflight": 0}
    assert late_rep["lost"] == 1 and late_rep["ok"] == 0
    assert [t for t, _ in taps][:3] == [
        f"vehicles/sensor/data/canary-{s:08d}" for s in seqs]
