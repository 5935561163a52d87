"""The port's KSQL-equivalent tasks (``iotml_torch.streamproc.tasks``), the
dead-letter queue (``streamproc.dlq``) and ``python -m iotml_torch.obs
dlq``, the fleet's JSON leg (``FleetGenerator.publish(encoding="json")``),
the CSV replay source (``stream.csv_source``) and topic ownership
(``Broker.restrict_topic`` / ``producer_grant``, the wire's error 29)
held against the JAX package's on the CPU.

Tolerances: exact.  Every output topic's (partition, offset, key, value,
timestamp) equal JAX's on the same input; the dead-letter envelopes and
the ``iotml_dlq_*`` counter deltas equal; the records replayed from a
CSV written by the fleet generator equal in both encodings; the obs CLI's output equal
JAX's CLI's on one dead-letter topic; a produce to an owned topic
refused the same way by both brokers, and over the wire with error 29
to the port's client and JAX's, the end offsets unmoved.  Every server
binds 127.0.0.1:0 and is stopped by the test that starts it.
"""

import contextlib
import io
import json

import pytest

from iotml.core.schema import CAR_SCHEMA as J_CAR_SCHEMA
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.gen.simulator import write_csv_fixture
from iotml.obs import metrics as j_metrics
from iotml.obs.__main__ import main as j_obs_main
from iotml.stream.broker import Broker as JBroker
from iotml.stream.broker import TopicOwnershipError as JTopicOwnershipError
from iotml.stream.csv_source import replay_csv as j_replay_csv
from iotml.stream.kafka_wire import KafkaWireBroker as JKafkaWireBroker
from iotml.streamproc import dlq as j_dlq
from iotml.streamproc import tasks as j_tasks
from iotml_torch.core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs.__main__ import main as t_obs_main
from iotml_torch.stream.broker import Broker, TopicOwnershipError
from iotml_torch.stream.csv_source import replay_csv
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.streamproc import dlq as t_dlq
from iotml_torch.streamproc import tasks as t_tasks

SIDES = {"port": (Broker, t_tasks, t_dlq, t_metrics),
         "jax": (JBroker, j_tasks, j_dlq, j_metrics)}


def _records(broker, topic):
    if topic not in broker.topics():
        return None
    return [(p, m.offset, m.key, m.value, m.timestamp_ms)
            for p in range(broker.topic(topic).partitions)
            for m in broker.fetch(topic, p, broker.begin_offset(topic, p),
                                  100_000)]


def _fleet_json(broker_cls, gen_cls, scen_cls, partitions=1, **scen):
    b = broker_cls()
    n = gen_cls(scen_cls(**scen)).publish(b, "sensor-data", n_ticks=6,
                                          encoding="json",
                                          partitions=partitions)
    return b, n


@pytest.mark.parametrize("partitions", [1, 3])
def test_json_publish_equals_jax(partitions):
    scen = dict(num_cars=20, failure_rate=0.2, interval_s=100.0, seed=3)
    t, nt = _fleet_json(Broker, FleetGenerator, FleetScenario, partitions,
                        **scen)
    j, nj = _fleet_json(JBroker, JFleetGenerator, JFleetScenario, partitions,
                        **scen)
    assert nt == nj == 120
    assert _records(t, "sensor-data") == _records(j, "sensor-data")
    doc = json.loads(t.fetch("sensor-data", 0, 0, 1)[0].value)
    assert set(doc) == {f.name for f in CAR_SCHEMA.fields} | {
        "failure_occurred"}
    with pytest.raises(ValueError, match="encoding"):
        FleetGenerator(FleetScenario()).publish(t, "x", encoding="xml")


def _chain(side, poison: bool):
    """sensor-data (JSON, 3 partitions) → JsonToAvro → RekeyByCar (4
    partitions) → TumblingCounter, with poisoned records among the JSON
    when asked; every topic and the counter's table."""
    broker_cls, tasks, _, _ = SIDES[side]
    gen_cls, scen_cls = ((FleetGenerator, FleetScenario) if side == "port"
                         else (JFleetGenerator, JFleetScenario))
    b, _ = _fleet_json(broker_cls, gen_cls, scen_cls, partitions=3,
                       num_cars=12, failure_rate=0.25, interval_s=100.0)
    if poison:
        for i, raw in enumerate([b"{not json", b'["array"]',
                                 json.dumps({"coolant_temp": "x"}).encode(),
                                 b"\xff\xfe", b"null"]):
            b.produce("sensor-data", raw, key=f"car{i}".encode(),
                      timestamp_ms=1000 * i)
    conv = tasks.JsonToAvro(b)
    rekey = tasks.RekeyByCar(b, "SENSOR_DATA_S_AVRO",
                             "SENSOR_DATA_S_AVRO_REKEY", partitions=4)
    count = tasks.TumblingCounter(b)
    emitted = [conv.process_available(), rekey.process_available(),
               count.process_available(), conv.process_available()]
    topics = {t: _records(b, t) for t in (
        "SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY",
        "SENSOR_DATA_EVENTS_PER_5MIN_T", "sensor-data_DLQ")}
    return emitted, topics, count.table()


@pytest.mark.parametrize("poison", [False, True], ids=["clean", "poisoned"])
def test_task_chain_equals_jax(poison):
    got, want = _chain("port", poison), _chain("jax", poison)
    assert got == want
    emitted, topics, table = got
    assert emitted[:3] == [72, 72, len(table)] and emitted[3] == 0
    assert sum(table.values()) == 72
    assert (topics["sensor-data_DLQ"] is not None) == poison


@pytest.mark.parametrize("version", [1, 2])
def test_json_to_avro_schema_versions_equal_jax(version):
    outs = []
    for side in ("port", "jax"):
        broker_cls, tasks, _, _ = SIDES[side]
        gen_cls, scen_cls = ((FleetGenerator, FleetScenario)
                             if side == "port"
                             else (JFleetGenerator, JFleetScenario))
        b, _ = _fleet_json(broker_cls, gen_cls, scen_cls, num_cars=5)
        b.produce("sensor-data", json.dumps(
            {"speed": 3, "region": "eu", "FAILURE_OCCURRED": None}).encode())
        tasks.JsonToAvro(b, schema_version=version).process_available()
        outs.append(_records(b, "SENSOR_DATA_S_AVRO"))
    assert outs[0] == outs[1]
    b = Broker()
    b.create_topic("sensor-data")
    with pytest.raises(ValueError, match="unknown writer schema version"):
        t_tasks.JsonToAvro(b, schema_version=3)


def test_task_restart_resumes_from_commit_as_jax():
    outs = []
    for side in ("port", "jax"):
        broker_cls, tasks, _, _ = SIDES[side]
        gen_cls, scen_cls = ((FleetGenerator, FleetScenario)
                             if side == "port"
                             else (JFleetGenerator, JFleetScenario))
        b, n = _fleet_json(broker_cls, gen_cls, scen_cls, num_cars=6)
        first = tasks.JsonToAvro(b, group="conv").process_available()
        again = tasks.JsonToAvro(b, group="conv").process_available()
        outs.append((n, first, again, b.end_offset("SENSOR_DATA_S_AVRO", 0)))
    assert outs[0] == outs[1] == (36, 36, 0, 36)


def _csv_lines(n_cols):
    header = ",".join(["time", "car"] + ["c"] * (n_cols - 2))
    good = ",".join(["1", "car9"] + ["1.5"] * (n_cols - 2))
    return [header.encode(), good.encode(), b"\xff\xfe\xff",
            b"1,car1,too,short",
            ",".join(["1", "car2"] + ["xyz"] * (n_cols - 2)).encode(),
            ",".join(["2", "car3"] + ["7"] * (n_cols - 2)).encode()]


def test_delimited_to_avro_equals_jax():
    outs = []
    for side in ("port", "jax"):
        broker_cls, tasks, _, _ = SIDES[side]
        b = broker_cls()
        b.create_topic("car-data-csv")
        task = tasks.DelimitedToAvro(b, label="true")
        for i, line in enumerate(_csv_lines(2 + len(CAR_SCHEMA.fields))):
            b.produce("car-data-csv", line, timestamp_ms=i)
        outs.append((task.process_available(),
                     _records(b, "SENSOR_DATA_S_AVRO"),
                     [(p, o, k, json.loads(v), ts) for p, o, k, v, ts in
                      _records(b, "car-data-csv_DLQ")]))
    assert outs[0] == outs[1]
    assert outs[0][0] == 2 and len(outs[0][2]) == 3


def test_dead_letters_and_counters_equal_jax():
    outs = []
    for side in ("port", "jax"):
        broker_cls, tasks, dlq, metrics = SIDES[side]
        b = broker_cls()
        b.create_topic("sensor-data")
        task = tasks.JsonToAvro(b, src="sensor-data", dst="J2A_OUT")
        before = (metrics.dlq_total.value(source="sensor-data"),
                  metrics.dlq_route_errors.value())
        b.produce("sensor-data", json.dumps({"coolant_temp": 1.0}).encode(),
                  key=b"car1")
        b.produce("sensor-data", b"{not json", key=b"car2")
        b.produce("sensor-data", b'["array", "not", "object"]')
        b.produce("sensor-data",
                  json.dumps({"coolant_temp": "NaN-ish-text"}).encode())
        n = task.process_available()
        letters = [(m.key, m.value, dlq.decode_envelope(m.value))
                   for m in b.fetch(dlq.dlq_topic("sensor-data"), 0, 0, 100)]
        # a routing failure degrades to the plain drop, counted apart
        broken = broker_cls()
        broken.produce = None  # any use raises TypeError
        msg = b.fetch("sensor-data", 0, 1, 1)[0]
        routed = dlq.route(broken, msg, "boom", task="X")
        after = (metrics.dlq_total.value(source="sensor-data"),
                 metrics.dlq_route_errors.value())
        outs.append((n, letters, routed,
                     tuple(a - b for a, b in zip(after, before))))
    assert outs[0] == outs[1]
    n, letters, routed, deltas = outs[0]
    assert n == 1 and len(letters) == 3 and routed is False
    assert deltas == (3, 1)
    assert {d["task"] for _, _, d in letters} == {"JsonToAvro"}
    assert t_dlq.DLQ_SUFFIX == j_dlq.DLQ_SUFFIX == "_DLQ"


@pytest.mark.parametrize("value", [
    b"[1]", b"not even json", b'{"raw_b64": null}', b'"s"',
    json.dumps({"source": "t", "raw_b64": "aGVsbG8="}).encode()])
def test_decode_envelope_equals_jax(value):
    def outcome(mod):
        try:
            return mod.decode_envelope(value)
        except ValueError as e:
            return ("raise", type(e).__name__)

    assert outcome(t_dlq) == outcome(j_dlq)


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_obs_dlq_cli_output_equals_jax():
    broker = Broker()
    broker.create_topic("sensor-data")
    task = t_tasks.JsonToAvro(broker, src="sensor-data", dst="J2A_OUT2")
    broker.produce("sensor-data", b"not json at all", key=b"carX")
    broker.produce("sensor-data", b'{"speed": "fast"}')
    task.process_available()
    # non-envelope garbage on the open DLQ topic renders as a fallback row
    broker.produce("sensor-data_DLQ", b"[1]")
    broker.produce("sensor-data_DLQ", b"not even json")
    srv = KafkaWireServer(broker).start()
    try:
        boot = f"127.0.0.1:{srv.port}"
        for extra in ([], ["--json"], ["--limit", "2"],
                      ["--topic", "sensor-data_DLQ"],
                      ["--topic", "never-poisoned"]):
            argv = ["dlq", "--bootstrap", boot] + extra
            got, want = _cli(t_obs_main, argv), _cli(j_obs_main, argv)
            assert got == want, extra
        rc, out = _cli(t_obs_main, ["dlq", "--bootstrap", boot])
        assert rc == 0 and "sensor-data_DLQ: showing 4 dead letter(s)" in out
        assert "JsonToAvro" in out and "not json at all" in out
        assert "unparseable DLQ envelope" in out
    finally:
        srv.shutdown()
        srv.server_close()
    assert _cli(t_obs_main, ["dlq", "--bootstrap", "127.0.0.1:1"])[0] == 2


# ------------------------------------------------------------------ CSV
@pytest.mark.parametrize("encoding", ["avro", "json"])
def test_replay_csv_equals_jax(tmp_path, encoding):
    t_path = tmp_path / "fleet.csv"
    assert write_csv_fixture(str(t_path), n_rows=200, scenario=JFleetScenario(
        num_cars=30, failure_rate=0.1, seed=5)) == 200
    outs = []
    for broker_cls, replay in ((Broker, replay_csv), (JBroker, j_replay_csv)):
        b = broker_cls()
        n = replay(b, "T", str(t_path), encoding=encoding, label="true",
                   limit=150, partitions=3)
        n2 = replay(b, "U", str(t_path), schema=(
            CAR_SCHEMA if broker_cls is Broker else J_CAR_SCHEMA),
            encoding=encoding)
        outs.append((n, n2, _records(b, "T"), _records(b, "U")))
    assert outs[0] == outs[1]
    assert outs[0][0] == 150 and outs[0][1] == 200


# ------------------------------------------------------------ ownership
def _ownership(broker_cls, err_cls):
    import threading

    b = broker_cls()
    b.create_topic("SENSOR_DATA_S_AVRO", partitions=2)
    out = [b.produce("SENSOR_DATA_S_AVRO", b"pre", key=b"k")]
    token = b.restrict_topic("SENSOR_DATA_S_AVRO")
    for call in (lambda: b.produce("SENSOR_DATA_S_AVRO", b"external"),
                 lambda: b.produce_many("SENSOR_DATA_S_AVRO_REKEY",
                                        [(None, b"external", 0)]),
                 lambda: b.produce_batch("SENSOR_DATA_S_AVRO", [b"x"])):
        try:
            call()
            out.append("accepted")
        except err_cls as e:
            out.append(("refused", str(e)))
    with b.producer_grant(token):
        with b.producer_grant(token):  # re-entrant
            out.append(b.produce("SENSOR_DATA_S_AVRO", b"engine",
                                 key=b"k"))
        out.append(b.produce("SENSOR_DATA_S_AVRO_REKEY", b"engine"))
        seen = []

        def other():
            try:
                b.produce("SENSOR_DATA_S_AVRO", b"sneak")
                seen.append("accepted")
            except err_cls:
                seen.append("refused")

        th = threading.Thread(target=other)
        th.start()
        th.join(5)
        out.append(seen)
    out.append(b.produce("sensor-data", b"anyone"))
    b.commit("g", "SENSOR_DATA_S_AVRO", 0, 1)
    out.append(b.committed("g", "SENSOR_DATA_S_AVRO", 0))
    out.append(_records(b, "SENSOR_DATA_S_AVRO"))
    return out


def test_restrict_topic_and_grant_semantics_equal_jax():
    got = _ownership(Broker, TopicOwnershipError)
    assert got == _ownership(JBroker, JTopicOwnershipError)
    assert issubclass(TopicOwnershipError, PermissionError)
    assert [x[0] for x in got[1:4]] == ["refused"] * 3
    assert got[6] == ["refused"]


@pytest.mark.parametrize("client", ["port", "jax"])
def test_wire_produce_to_owned_topic_is_error_29(client):
    b = Broker()
    b.create_topic("SENSOR_DATA_S_AVRO", partitions=2)
    b.create_topic("open", partitions=1)
    token = b.restrict_topic("SENSOR_DATA_S_AVRO")
    with b.producer_grant(token):
        b.produce("SENSOR_DATA_S_AVRO", b"engine", key=b"k")
    ends = [b.end_offset("SENSOR_DATA_S_AVRO", p) for p in range(2)]
    srv = KafkaWireServer(b).start()
    cli = (KafkaWireBroker if client == "port" else JKafkaWireBroker)(
        f"127.0.0.1:{srv.port}")
    try:
        with pytest.raises(PermissionError, match="restricted to its "
                                                  "owning engine"):
            cli.produce("SENSOR_DATA_S_AVRO", b"external", key=b"k")
        with pytest.raises(PermissionError):
            cli.produce_many("SENSOR_DATA_S_AVRO_REKEY",
                             [(b"k", b"x", 0)], partition=0)
        assert [b.end_offset("SENSOR_DATA_S_AVRO", p)
                for p in range(2)] == ends
        assert "SENSOR_DATA_S_AVRO_REKEY" not in b.topics() or \
            b.end_offset("SENSOR_DATA_S_AVRO_REKEY", 0) == 0
        # other topics stay open over the same connection
        assert cli.produce("open", b"fine", partition=0) == 0
    finally:
        cli.close()
        srv.shutdown()
        srv.server_close()


def test_raw_produce_leg_names_its_roadmap_item():
    b = Broker()
    b.create_topic("sensor-data")
    task = t_tasks.JsonToAvro(b)
    assert task.process_raw([]) is None
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        task.raw_producer()
    assert KSQL_CAR_SCHEMA.field("FAILURE_OCCURRED").avro_type == "string"
