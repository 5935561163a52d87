"""The port's KSQL-equivalent engine (``iotml_torch.streamproc.sql``) and
its REST server (``streamproc.server``) held against the JAX package's on
the CPU.

Tolerances: exact.  Under the reference DDL every output topic's
(partition, offset, key, value, timestamp), the dead-letter topic, the
CTAS table, the statements' results and the registry's subjects and ids
equal JAX's engine's on the same input: the KSQL-named fleet, the
generator's producer-named JSON (whose underscore-digit columns are
null), hostile and malformed rows, and a poisoned AVRO record.  The
native legs equal the port's all-Python leg (``process_plain``) byte for
byte, and the rows they hand to Python are counted.  ``SHOW``,
``DESCRIBE``, ``PRINT`` and transient ``SELECT`` results equal; bad
statements raise the same class and message; a poisoned query is
isolated alike; CTAS state survives a restart and a recreate does not
double count; trusted pass-through and its sampling forward the same
bytes; a parser fuzz (hypothesis) gives the same result or the same
error class; the trace spans across the KSQL hops count alike.  The REST
server answers as JAX's (one request sequence).
"""

import http.client
import json

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL_CAR_SCHEMA
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.obs import tracing as j_tracing
from iotml.ops.avro import AvroCodec as JAvroCodec
from iotml.ops.framing import frame as j_frame
from iotml.stream.broker import Broker as JBroker
from iotml.streamproc import server as j_server
from iotml.streamproc import sql as j_sql
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.obs import tracing as t_tracing
from iotml_torch.ops.avro import AvroCodec
from iotml_torch.ops.framing import frame
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
from iotml_torch.streamproc import server as t_server
from iotml_torch.streamproc import sql as t_sql

OUT_TOPICS = ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY",
              "SENSOR_DATA_EVENTS_PER_5MIN_T", "sensor-data_DLQ",
              "SENSOR_DATA_S_AVRO_DLQ", "SENSOR_DATA_S_AVRO_REKEY_DLQ")
SIDES = {"port": (Broker, t_sql), "jax": (JBroker, j_sql)}


def _records(broker, topic):
    if topic not in broker.topics():
        return None
    return [(p, m.offset, m.key, m.value, m.timestamp_ms)
            for p in range(broker.topic(topic).partitions)
            for m in broker.fetch(topic, p, broker.begin_offset(topic, p),
                                  100_000)]


def _fleet_records(n=40, cars=4, seed=7):
    gen = JFleetGenerator(JFleetScenario(num_cars=cars, seed=seed))
    out = []
    while len(out) < n:
        cols = gen.step_columns()
        out += [gen.row_record(cols, i, J_KSQL_CAR_SCHEMA)
                for i in range(cars)]
    return out[:n]


def _produce_json(broker, values, partitions=2, keys=None):
    broker.create_topic("sensor-data", partitions=partitions)
    for i, v in enumerate(values):
        raw = v if isinstance(v, bytes) else json.dumps(v).encode()
        key = keys[i] if keys else f"vehicles/sensor/data/car{i % 3}".encode()
        broker.produce("sensor-data", raw, key=key, timestamp_ms=i * 60_000)


def _pipeline(side, values, partitions=2, extra=None, trusted=False,
              sample=0, owned=False, pumps=2, statements=()):
    """The reference DDL over ``values`` on one side; every output topic,
    the CTAS table, the statements' results and the registry."""
    broker_cls, sql = SIDES[side]
    b = broker_cls()
    _produce_json(b, values, partitions)
    token = b.restrict_topic("SENSOR_DATA_S_AVRO") if owned else None
    engine = sql.SqlEngine(b, trusted_passthrough=trusted, owner_token=token,
                           passthrough_sample=sample)
    results = sql.install_reference_pipeline(engine)
    if extra is not None:
        extra(b, token, side)
    emitted = [engine.pump() for _ in range(pumps)]
    results += [engine.execute(s) for s in statements]
    return {"results": results, "emitted": emitted,
            "topics": {t: _records(b, t) for t in OUT_TOPICS},
            "table": engine.table("SENSOR_DATA_EVENTS_PER_5MIN_T"),
            "subjects": [(s, engine.registry.latest(s).schema_id,
                          engine.registry.latest(s).version)
                         for s in engine.registry.subjects()],
            "queries": engine.execute("SHOW QUERIES")}


def _equal_jax(**kw):
    got, want = _pipeline("port", **kw), _pipeline("jax", **kw)
    assert got == want
    return got


@pytest.mark.parametrize("partitions", [1, 4])
@pytest.mark.parametrize("trusted", [False, True])
def test_reference_ddl_topics_equal_jax(partitions, trusted):
    got = _equal_jax(values=_fleet_records(60), partitions=partitions,
                     trusted=trusted, owned=trusted)
    assert len(got["topics"]["SENSOR_DATA_S_AVRO"]) == 60
    assert len(got["topics"]["SENSOR_DATA_S_AVRO_REKEY"]) == 60
    assert got["topics"]["sensor-data_DLQ"] is None
    assert got["emitted"][1] == 0
    assert all(q["state"] == "RUNNING"
               for q in got["queries"][0]["queries"])


def test_reference_ddl_on_producer_named_json_equals_jax():
    """The generator's own JSON leg: producer names, whose underscore-digit
    columns (``tire_pressure_1_1``) match no KSQL column and decode null."""
    outs = []
    for side, gen_cls, scen_cls in (("port", FleetGenerator, FleetScenario),
                                    ("jax", JFleetGenerator,
                                     JFleetScenario)):
        broker_cls, sql = SIDES[side]
        b = broker_cls()
        gen_cls(scen_cls(num_cars=15, failure_rate=0.2)).publish(
            b, "sensor-data", n_ticks=4, encoding="json", partitions=3)
        engine = sql.SqlEngine(b)
        sql.install_reference_pipeline(engine)
        engine.pump()
        outs.append(({t: _records(b, t) for t in OUT_TOPICS},
                     engine.table("SENSOR_DATA_EVENTS_PER_5MIN_T"),
                     engine.execute("SELECT TIRE_PRESSURE11, COOLANT_TEMP, "
                                    "FAILURE_OCCURRED FROM "
                                    "SENSOR_DATA_S_AVRO LIMIT 5")))
    assert outs[0] == outs[1]
    rows = outs[0][2][0]["rows"]
    assert len(rows) == 5 and all(r[0] is None and r[1] is not None
                                  for r in rows)


def _hostile(nested=False):
    base = _fleet_records(6)
    # a nested value fails the pure codec's encode (struct.error), which
    # no leg catches: the AVRO query stays in ERROR, in both packages
    return base + ([{**base[5], "SPEED": {"nested": 1}}] if nested else []) + [
        {"tire_pressure_1_1": 30, "coolant_temp": 90.0,
         "failure_occurred": "false"},
        {**base[0], "FAILURE_OCCURRED": "esc\"aped\nnewline"},
        {**base[1], "FAILURE_OCCURRED": "x" * 200},
        {**base[2], "TIRE_PRESSURE11": 2 ** 60},
        {**base[3], "TIRE_PRESSURE11": 1.5},
        {**base[4], "COOLANT_TEMP": None},
        {**base[5], "SPEED": 1e999},
        {**base[5], "SPEED": "12.5"},
        {**base[5], "FAILURE_OCCURRED": "café"},
        {**base[5], "FAILURE_OCCURRED": "nul\x00byte"},
        b"not json at all", b"[1,2,3]", b"\xff\xfe", b"null",
        json.dumps(base[0]).encode() + b" trailing",
    ]


@pytest.mark.parametrize("nested", [False, True])
def test_hostile_and_malformed_rows_equal_jax(nested):
    got = _equal_jax(values=_hostile(nested), partitions=2)
    states = {q["sink"]: q["state"] for q in got["queries"][0]["queries"]}
    if nested:
        assert states["SENSOR_DATA_S_AVRO"] == "ERROR"
    else:
        assert set(states.values()) == {"RUNNING"}
        assert len(got["topics"]["sensor-data_DLQ"]) == 5


def _poison_avro(b, token, side):
    """A non-canonical AVRO record (trailing junk) written straight to the
    AVRO leg, under the owner's grant."""
    codec = AvroCodec(KSQL_CAR_SCHEMA) if side == "port" \
        else JAvroCodec(J_KSQL_CAR_SCHEMA)
    fr = frame if side == "port" else j_frame
    rec = _fleet_records(1)[0]
    with b.producer_grant(token):
        b.produce("SENSOR_DATA_S_AVRO", fr(codec.encode(rec), 3)
                  + b"TRAILING", key=b"carX", timestamp_ms=5)


@pytest.mark.parametrize("trusted,sample", [(False, 0), (True, 0), (True, 1),
                                            (True, 2)])
def test_poisoned_avro_and_trusted_sampling_equal_jax(trusted, sample):
    got = _equal_jax(values=_fleet_records(30), partitions=2,
                     extra=_poison_avro, trusted=trusted, sample=sample,
                     owned=True)
    rekey = got["topics"]["SENSOR_DATA_S_AVRO_REKEY"]
    junk = [v for _, _, _, v, _ in rekey if v.endswith(b"TRAILING")]
    # untrusted or sampled: validated and canonicalized; trusted without a
    # sample: passed through as written (the engine owns the topic)
    assert bool(junk) == (trusted and sample != 1)


def _statements():
    return ["SHOW STREAMS", "SHOW TABLES", "SHOW QUERIES", "SHOW TOPICS",
            "LIST STREAMS",
            "DESCRIBE SENSOR_DATA_S", "DESCRIBE EXTENDED SENSOR_DATA_S_AVRO",
            "DESCRIBE SENSOR_DATA_EVENTS_PER_5MIN_T",
            "PRINT 'sensor-data' FROM BEGINNING LIMIT 3",
            "PRINT 'SENSOR_DATA_EVENTS_PER_5MIN_T' LIMIT 2",
            "PRINT sensor_data_events_per_5min_t FROM BEGINNING",
            "SELECT * FROM SENSOR_DATA_S_AVRO LIMIT 2",
            "SELECT ROWKEY, SPEED, SPEED * 2 AS S2, ABS(COOLANT_TEMP - 50), "
            "UCASE(FAILURE_OCCURRED) FROM SENSOR_DATA_S_AVRO "
            "WHERE SPEED > 10 AND NOT FAILURE_OCCURRED = 'true' LIMIT 7",
            "SELECT CAR, ROWTIME, LEN(CAR) FROM SENSOR_DATA_S_AVRO_REKEY "
            "WHERE TIRE_PRESSURE11 IS NOT NULL",
            "SELECT FLOOR(SPEED), CEIL(SPEED), ROUND(SPEED), LCASE(ROWKEY) "
            "FROM SENSOR_DATA_S WHERE SPEED >= 0 OR SPEED IS NULL LIMIT 5",
            "SELECT SPEED / 0 FROM SENSOR_DATA_S_AVRO LIMIT 3",
            "SELECT * FROM SENSOR_DATA_S WHERE SPEED <> 1 LIMIT 4"]


def test_show_describe_print_select_equal_jax():
    got = _equal_jax(values=_fleet_records(24), partitions=2,
                     statements=_statements())
    assert got["results"][-5][0]["header"][0] == "ROWKEY"


def test_print_avro_topic_renders_the_registered_record():
    """PRINT of an AVRO topic whose frame id the registry knows renders
    the decoded record as JSON.  JAX's engine raises TypeError there (it
    calls the ``record_schema`` property); the port reads the property."""
    b = Broker()
    _produce_json(b, _fleet_records(6))
    engine = t_sql.SqlEngine(b)
    t_sql.install_reference_pipeline(engine)
    engine.pump()
    got = engine.execute("PRINT SENSOR_DATA_S_AVRO FROM BEGINNING LIMIT 4;"
                         "PRINT sensor_data_s_avro_rekey")
    schema = engine.sources["SENSOR_DATA_S_AVRO"].record_schema()
    msgs = b.fetch("SENSOR_DATA_S_AVRO", 0, 0, 4)
    assert [r["value"] for r in got[0]["rows"]][:len(msgs)] == [
        json.dumps(AvroCodec(schema).decode(m.value[5:])) for m in msgs]
    assert len(got[0]["rows"]) == 4 and len(got[1]["rows"]) == 6
    jb = JBroker()
    _produce_json(jb, _fleet_records(6))
    je = j_sql.SqlEngine(jb)
    j_sql.install_reference_pipeline(je)
    je.pump()
    with pytest.raises(TypeError):
        je.execute("PRINT SENSOR_DATA_S_AVRO FROM BEGINNING LIMIT 4")


BAD = ["FROB THE STREAM;", "CREATE STREAM X AS SELECT * FROM NOPE;",
       "SELECT * FROM MISSING;", "TERMINATE NOPE;", "DESCRIBE NOPE",
       "CREATE STREAM SENSOR_DATA_S (A DOUBLE)",
       "CREATE STREAM Y (A WIDGET)", "CREATE VIEW V AS SELECT 1",
       "CREATE STREAM Z (A DOUBLE) WITH (VALUE_FORMAT='PROTOBUF')",
       "CREATE STREAM Z2 WITH (VALUE_FORMAT='XML') AS SELECT * FROM "
       "SENSOR_DATA_S",
       "CREATE TABLE T2 AS SELECT SPEED FROM SENSOR_DATA_S",
       "SELECT COUNT(*) FROM SENSOR_DATA_S",
       "SELECT * FROM SENSOR_DATA_S WINDOW TUMBLING (SIZE 5 FORTNIGHTS)",
       "SHOW WIDGETS", "PRINT 'no-such-topic'", "DROP VIEW X",
       "DROP STREAM NOPE", "DROP TABLE SENSOR_DATA_S",
       "DROP STREAM SENSOR_DATA_S", "DROP STREAM SENSOR_DATA_S_AVRO",
       "SELECT 'unterminated FROM S", "SELECT ( FROM S", "SELECT $ FROM S",
       "CREATE", "SELECT * FROM", "DESCRIBE"]


@pytest.mark.parametrize("stmt", BAD)
def test_bad_statements_raise_as_jax(stmt):
    outs = []
    for side in ("port", "jax"):
        broker_cls, sql = SIDES[side]
        b = broker_cls()
        b.create_topic("sensor-data")
        engine = sql.SqlEngine(b)
        sql.install_reference_pipeline(engine)
        try:
            outs.append(("ok", engine.execute(stmt)))
        except Exception as e:  # noqa: BLE001 - the class is compared
            outs.append((type(e).__name__, str(e)))
    assert outs[0] == outs[1]
    assert outs[0][0] == "SqlError"


def test_where_expressions_and_auto_names_equal_jax():
    outs = []
    for side in ("port", "jax"):
        broker_cls, sql = SIDES[side]
        b = broker_cls()
        b.create_topic("t", partitions=1)
        for i in range(10):
            b.produce("t", json.dumps({"v": i, "label": "odd" if i % 2
                                       else "even"}).encode(), key=b"k")
        e = sql.SqlEngine(b)
        res = e.execute(
            "CREATE STREAM S (V DOUBLE, LABEL STRING) WITH "
            "(KAFKA_TOPIC='t', VALUE_FORMAT='JSON');"
            "CREATE STREAM EVENS AS SELECT V, V * 2 AS DOUBLED FROM S "
            "WHERE LABEL = 'even' AND V >= 2;"
            "CREATE STREAM D WITH (VALUE_FORMAT='DELIMITED') AS "
            "SELECT V + 1, V - 1, LABEL FROM S;"
            "CREATE STREAM A WITH (VALUE_FORMAT='AVRO', PARTITIONS=2) AS "
            "SELECT ROWKEY AS K, V, LABEL FROM S PARTITION BY K;"
            "CREATE TABLE AGG AS SELECT LABEL, COUNT(*), SUM(V) AS S, "
            "MIN(V) AS LO, MAX(V) AS HI, AVG(V) AS MEAN FROM S "
            "GROUP BY LABEL;")
        e.pump()
        res += e.execute("SELECT V, DOUBLED FROM EVENS; DESCRIBE D; "
                         "SELECT * FROM A")
        outs.append((res, {t: _records(b, t)
                           for t in ("EVENS", "D", "A", "AGG")},
                     e.table("AGG")))
    assert outs[0] == outs[1]
    assert [r[0] for r in outs[0][0][5]["rows"]] == [2, 4, 6, 8]


def _isolation(side):
    broker_cls, sql = SIDES[side]
    b = broker_cls()
    _produce_json(b, _fleet_records(6))
    e = sql.SqlEngine(b)
    e.execute("CREATE STREAM S (SPEED DOUBLE, FAILURE_OCCURRED VARCHAR) "
              "WITH (KAFKA_TOPIC='sensor-data', VALUE_FORMAT='JSON');"
              "CREATE STREAM A AS SELECT SPEED FROM S;"
              "CREATE STREAM B AS SELECT SPEED FROM S;")
    qa, qb = list(e.queries.values())
    real = qa.task.process

    def poisoned(messages):
        raise RuntimeError("avro encode type mismatch")

    qa.task.process = poisoned
    out = [e.pump(), e.execute("SHOW QUERIES"), e.pump(),
           e.execute("SHOW QUERIES")]
    qa.task.process = real
    out += [e.pump(), e.execute("SHOW QUERIES"), _records(b, "A"),
            _records(b, "B")]
    return out


def test_poisoned_query_is_isolated_as_jax():
    got = _isolation("port")
    assert got == _isolation("jax")
    assert got[1][0]["queries"][0]["state"] == "ERROR"
    assert len(got[6]) == 6


def _restart(side, recreate_sql=None):
    broker_cls, sql = SIDES[side]
    b = broker_cls()
    _produce_json(b, _fleet_records(8), keys=[b"car0", b"car1"] * 4)
    e1 = sql.SqlEngine(b)
    sql.install_reference_pipeline(e1)
    e1.pump()
    out = [e1.table("SENSOR_DATA_EVENTS_PER_5MIN_T")]
    if recreate_sql is not None:
        qid = next(q for q in e1.queries if q.startswith("CTAS"))
        e1.execute(f"TERMINATE {qid}; DROP TABLE "
                   "SENSOR_DATA_EVENTS_PER_5MIN_T;")
        out.append(e1.execute(recreate_sql))
        e1.pump()
        out.append(e1.table("SENSOR_DATA_EVENTS_PER_5MIN_T"))
        return out
    for i in range(3):
        b.produce("sensor-data", json.dumps(_fleet_records(1)[0]).encode(),
                  key=b"car0", timestamp_ms=i * 60_000)
    e2 = sql.SqlEngine(b)  # a fresh process over the same broker
    sql.install_reference_pipeline(e2)
    e2.pump()
    out.append(e2.table("SENSOR_DATA_EVENTS_PER_5MIN_T"))
    out.append(_records(b, "SENSOR_DATA_EVENTS_PER_5MIN_T"))
    return out


CTAS_SAME = ("CREATE TABLE SENSOR_DATA_EVENTS_PER_5MIN_T AS SELECT ROWKEY "
             "AS CAR, COUNT(*) AS EVENT_COUNT FROM SENSOR_DATA_S_AVRO_REKEY "
             "WINDOW TUMBLING (SIZE 5 MINUTES) GROUP BY ROWKEY;")
CTAS_SUM = ("CREATE TABLE SENSOR_DATA_EVENTS_PER_5MIN_T WITH "
            "(KAFKA_TOPIC='T2') AS SELECT ROWKEY AS CAR, SUM(SPEED) AS "
            "TOTAL_SPEED, AVG(SPEED) AS MEAN FROM SENSOR_DATA_S_AVRO_REKEY "
            "WINDOW TUMBLING (SIZE 5 MINUTES) GROUP BY ROWKEY;")


@pytest.mark.parametrize("recreate", [None, CTAS_SAME, CTAS_SUM],
                         ids=["restart", "recreate-same", "recreate-other"])
def test_ctas_state_restart_and_recreate_equal_jax(recreate):
    got = _restart("port", recreate)
    assert got == _restart("jax", recreate)
    # car0 at minutes 0, 2, 4 and 6: three in the first window
    assert got[0][("car0", 0)]["EVENT_COUNT"] == 3
    if recreate is None:
        assert got[1][("car0", 0)]["EVENT_COUNT"] == 6  # 3 restored + 3
    elif recreate is CTAS_SAME:
        assert got[2][("car0", 0)]["EVENT_COUNT"] == 3  # not double counted


def test_native_legs_equal_the_python_leg_and_count_fallbacks():
    """The port alone: each persistent query's ``process`` (native legs)
    against ``process_plain`` (pure codecs) on the same input chunk, and
    the rows handed to Python counted in ``native.stats``."""
    b = Broker()
    _produce_json(b, _hostile(), partitions=1)
    engine = t_sql.SqlEngine(b)
    t_sql.install_reference_pipeline(engine)
    tasks = {q.sink: q.task for q in engine.queries.values()}
    assert tasks["SENSOR_DATA_S_AVRO"]._fused_json is not None
    assert tasks["SENSOR_DATA_S_AVRO_REKEY"]._rekey_fast
    assert tasks["SENSOR_DATA_EVENTS_PER_5MIN_T"]._fast_count
    native.reset_stats()
    src = b.fetch("sensor-data", 0, 0, 1000)
    conv = tasks["SENSOR_DATA_S_AVRO"]
    fast = conv.process(src)
    assert native.stats["json_fallback_rows"] == sum(
        1 for v in _hostile() if isinstance(v, bytes)) + 8
    assert fast == conv.process_plain(src)
    b.produce_many("SENSOR_DATA_S_AVRO", fast)
    avro = b.fetch("SENSOR_DATA_S_AVRO", 0, 0, 1000)
    rekey = tasks["SENSOR_DATA_S_AVRO_REKEY"]
    native.reset_stats()
    fast = rekey.process(avro)
    # a null and a long label in the batch: the whole batch is validated,
    # and passes; its rows are passed through natively
    assert fast == rekey.process_plain(avro)
    b.produce_many("SENSOR_DATA_S_AVRO_REKEY", fast)
    ctas = tasks["SENSOR_DATA_EVENTS_PER_5MIN_T"]
    rk = [m for p in range(b.topic("SENSOR_DATA_S_AVRO_REKEY").partitions)
          for m in b.fetch("SENSOR_DATA_S_AVRO_REKEY", p, 0, 1000)]
    assert ctas.process(rk) == ctas.process_plain(rk)
    # process_plain leaves the table's state as it was
    assert sum(v["EVENT_COUNT"] for v in ctas.table().values()) == len(rk)
    # an unframed row sends the rekey batch and the COUNT batch to Python
    bad = avro[:3] + [avro[0]._replace(value=b"\x07unframed")]
    native.reset_stats()
    assert rekey.process(bad) == rekey.process_plain(bad)
    assert native.stats["rekey_fallback_rows"] == 4
    native.reset_stats()
    ctas.process(bad)
    assert native.stats["count_fallback_rows"] == 4


def test_native_decode_exactness_fallbacks_equal_jax():
    outs = []
    for side in ("port", "jax"):
        broker_cls, sql = SIDES[side]
        b = broker_cls()
        b.create_topic("src", partitions=1)
        e = sql.SqlEngine(b)
        e.execute("CREATE STREAM S (BIGNUM BIGINT, NOTE STRING, OK BOOLEAN) "
                  "WITH (KAFKA_TOPIC='src', VALUE_FORMAT='AVRO');"
                  "CREATE STREAM OUT WITH (VALUE_FORMAT='AVRO') AS SELECT "
                  "BIGNUM, NOTE, OK FROM S;"
                  "CREATE TABLE N AS SELECT ROWKEY AS K, COUNT(*) AS C "
                  "FROM S GROUP BY ROWKEY;")
        codec = (AvroCodec if side == "port" else JAvroCodec)(
            e.sources["S"].record_schema())
        fr = frame if side == "port" else j_frame
        for big, note, ok in ((2 ** 53 + 1, "café", True), (7, "plain", None),
                              (2 ** 53 + 1, "plain", False),
                              (None, "x" * 70, True), (3, None, False)):
            b.produce("src", fr(codec.encode({"BIGNUM": big, "NOTE": note,
                                              "OK": ok}), 1), key=b"k")
        e.pump()
        outs.append((_records(b, "OUT"), _records(b, "N"), e.table("N")))
    assert outs[0] == outs[1]
    assert len(outs[0][0]) == 5


_WORDS = ["CREATE", "STREAM", "TABLE", "SELECT", "FROM", "WHERE", "AS",
          "GROUP", "BY", "WINDOW", "TUMBLING", "SIZE", "(", ")", ",", ";",
          "*", "+", "-", "/", "=", "'x'", "5", "5.5", "COUNT", "S", "V",
          "DOUBLE", "WITH", "KAFKA_TOPIC", "PARTITION", "DROP", "TERMINATE",
          "PRINT", "SHOW", "'q u o t e d'", "<>", "IS", "NULL", "NOT", "AND",
          "OR", "LIMIT", "EMIT", "CHANGES", "MINUTES", "ROWKEY", "SUM",
          "DESCRIBE", "STREAMS", "QUERIES", "TOPICS", "'t'", "ALL", "IF",
          "EXISTS", "VALUE_FORMAT", "'AVRO'", "ABS", "UCASE"]


def _fuzz_engine(side):
    broker_cls, sql = SIDES[side]
    b = broker_cls()
    b.create_topic("t", partitions=1)
    b.produce("t", json.dumps({"v": 2.0}).encode(), key=b"k")
    e = sql.SqlEngine(b)
    e.execute("CREATE STREAM S (V DOUBLE) WITH (KAFKA_TOPIC='t');")
    return e


def _fuzz_outcome(engine, stmt):
    try:
        return ("ok", json.dumps(engine.execute(stmt), sort_keys=True,
                                 default=str))
    except Exception as e:  # noqa: BLE001 - the class is compared
        return (type(e).__name__,)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.lists(st.sampled_from(_WORDS), min_size=1, max_size=14),
                min_size=1, max_size=4))
def test_parser_fuzz_equals_jax(stmts):
    t, j = _fuzz_engine("port"), _fuzz_engine("jax")
    for words in stmts:
        stmt = " ".join(words)
        got, want = _fuzz_outcome(t, stmt), _fuzz_outcome(j, stmt)
        assert got == want, stmt
    assert t.pump() == j.pump()


def _traced_run(side, tmp_path):
    tr = t_tracing if side == "port" else j_tracing
    gen_cls, scen_cls = ((FleetGenerator, FleetScenario) if side == "port"
                         else (JFleetGenerator, JFleetScenario))
    broker_cls, sql = SIDES[side]
    path = str(tmp_path / f"{side}.jsonl")
    tr.reset()
    tr.configure(enabled=True, sample=1.0, path=path)
    try:
        b = broker_cls()
        gen_cls(scen_cls(num_cars=10)).publish(b, "sensor-data", n_ticks=3,
                                               encoding="json",
                                               partitions=2)
        e = sql.SqlEngine(b)
        sql.install_reference_pipeline(e)
        e.pump()
        tr.flush()
        born = {}
        for m in b.fetch("sensor-data", 0, 0, 100) + \
                b.fetch("sensor-data", 1, 0, 100):
            born[m.key, m.timestamp_ms] = tr.from_headers(m.headers).trace_id
        carried = {}
        for topic in ("SENSOR_DATA_S_AVRO", "SENSOR_DATA_S_AVRO_REKEY"):
            for p in range(b.topic(topic).partitions):
                for m in b.fetch(topic, p, 0, 100):
                    ctx = tr.from_headers(m.headers) if m.headers else None
                    carried[topic, m.key, m.timestamp_ms] = \
                        ctx is not None and \
                        ctx.trace_id == born[m.key, m.timestamp_ms]
    finally:
        tr.configure(enabled=False, sample=1.0)
        tr.reset()
        tr._PATH = None
    stages = {}
    with open(path) as fh:
        for line in fh:
            doc = json.loads(line)
            k = (doc["kind"], doc.get("stage", doc.get("closer")))
            stages[k] = stages.get(k, 0) + 1
    return stages, carried


def test_trace_spans_across_the_ksql_hops_equal_jax(tmp_path):
    got = _traced_run("port", tmp_path)
    assert got == _traced_run("jax", tmp_path)
    stages, carried = got
    assert stages[("span", "devsim_publish")] == 30
    assert stages[("span", "streamproc")] == 60  # the AVRO and REKEY hops
    assert len(carried) == 60 and all(carried.values())


# ----------------------------------------------------------------- REST
def _post(conn, path, body):
    conn.request("POST", path, body if isinstance(body, str)
                 else json.dumps(body), {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, r.getheader("Content-Type"), r.read()


def _rest_run(side):
    broker_cls, sql = SIDES[side]
    srv_mod = t_server if side == "port" else j_server
    b = broker_cls()
    _produce_json(b, _fleet_records(12))
    engine = sql.SqlEngine(b)
    server = srv_mod.KsqlServer(engine, pump_interval_s=3600).start()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=5)
    try:
        out = [_post(conn, "/ksql", {"ksql": "SHOW TOPICS;"}),
               _post(conn, "/ksql", {"ksql": sql.REFERENCE_PIPELINE_DDL}),
               server.pump_now(), server.pump_now(),
               _post(conn, "/query", {"ksql": "SELECT ROWKEY, SPEED FROM "
                                              "SENSOR_DATA_S_AVRO WHERE "
                                              "SPEED >= 1 LIMIT 3;"}),
               _post(conn, "/query", {"ksql": "PRINT 'sensor-data' FROM "
                                              "BEGINNING LIMIT 2"}),
               _post(conn, "/query", {"ksql": "SHOW STREAMS"}),
               _post(conn, "/query", {"ksql": "BOGUS"}),
               _post(conn, "/ksql", {"sql": "BOGUS;"}),
               _post(conn, "/ksql", '"SHOW TABLES;"'),
               _post(conn, "/ksql", "[1, 2, 3]"),
               _post(conn, "/ksql", "42")]
        for path in ("/info", "/healthcheck", "/nowhere"):
            conn.request("GET", path)
            r = conn.getresponse()
            out.append((r.status, r.read()))
    finally:
        conn.close()
        server.stop()
    return out


def test_ksql_server_answers_equal_jax():
    got = _rest_run("port")
    assert got == _rest_run("jax")
    assert got[1][0] == 200 and len(json.loads(got[1][2])) == 4
    assert got[2] > 0 and got[3] == 0
    assert got[7][0] == got[8][0] == 400


def test_ksql_pump_thread_is_registered_and_advances():
    from iotml_torch.supervise import registry

    b = Broker()
    _produce_json(b, _fleet_records(8))
    engine = t_sql.SqlEngine(b)
    t_sql.install_reference_pipeline(engine)
    server = t_server.KsqlServer(engine, pump_interval_s=0.01).start()
    try:
        assert "iotml-ksql-pump" in {t.name for t in registry.threads()}
        import time

        deadline = time.monotonic() + 10
        while sum(b.end_offset("SENSOR_DATA_S_AVRO_REKEY", p)
                  for p in range(2)) < 8:
            assert time.monotonic() < deadline, "the pump did not advance"
            time.sleep(0.01)
    finally:
        server.stop()
