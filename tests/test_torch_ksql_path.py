"""The slice as a whole on the CPU: fleet JSON on ``sensor-data`` → the
reference's own DDL posted to the KSQL server over HTTP → Avro on
``SENSOR_DATA_S_AVRO`` → one ``fit_compiled`` (B1's plain version on the
CPU) → the scorer, for the port against the same pipeline in the JAX
package, set up as the platform does on loopback: a 4-partition
``sensor-data``, a schema registry with the two car subjects and its
REST server, a Kafka wire server, ``restrict_topic("SENSOR_DATA_S_AVRO")``
and a trusted engine holding the owner's token, sampling one batch in
32.  A tick of a 600-car fleet, keyed as the MQTT bridge keys it
(``vehicles/sensor/data/<car>``).

Tolerances:
- every output topic, the registry's subjects and ids (over REST too),
  the CTAS table and ``SHOW QUERIES``: equal, byte for byte;
- the decoded training batches: equal exactly to JAX's and to the
  batches of the same generator rows published straight as Avro under
  the same keys;
- the fit: losses at rtol 2e-4 / atol 1e-6, params at rtol 5e-3 /
  atol 2e-5 (the fused-fit bounds, tests/test_fused_train.py);
- the threshold (99th percentile of the training errors): rtol 1e-5;
- the payloads: printed values at atol 1e-6, the printed error at most
  one last digit apart, verdicts equal away from the threshold (1e-4);
- a produce to ``SENSOR_DATA_S_AVRO`` through either wire client:
  refused (error 29), the end offsets unmoved.
"""

import http.client
import json

import jax
import numpy as np
import pytest

from iotml.core.schema import CAR_SCHEMA as J_CAR_SCHEMA
from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL_CAR_SCHEMA
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.evaluate.anomaly import \
    reconstruction_errors as j_reconstruction_errors
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.kafka_wire import KafkaWireBroker as JKafkaWireBroker
from iotml.stream.kafka_wire import KafkaWireServer as JKafkaWireServer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.stream.registry import SchemaRegistry as JSchemaRegistry
from iotml.stream.registry import subject_for_topic
from iotml.stream.registry_server import \
    SchemaRegistryServer as JSchemaRegistryServer
from iotml.streamproc import KsqlServer as JKsqlServer
from iotml.streamproc import SqlEngine as JSqlEngine
from iotml.streamproc.sql import REFERENCE_PIPELINE_DDL as J_DDL
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.evaluate.anomaly import reconstruction_errors
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.stream.native import NativeCodec
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.stream.registry import SchemaRegistry
from iotml_torch.stream.registry_server import SchemaRegistryServer
from iotml_torch.streamproc import KsqlServer, SqlEngine
from iotml_torch.streamproc.sql import REFERENCE_PIPELINE_DDL
from iotml_torch.train.loop import Trainer, TrainState

N_CARS, PARTITIONS = 600, 4
AVRO = "SENSOR_DATA_S_AVRO"
TOPICS = (AVRO, "SENSOR_DATA_S_AVRO_REKEY", "SENSOR_DATA_EVENTS_PER_5MIN_T")
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
PAYLOAD_ATOL, VERDICT_MARGIN = 1e-6, 1e-4

SIDE = {
    "port": dict(broker=Broker, registry=SchemaRegistry,
                 registry_server=SchemaRegistryServer,
                 wire=KafkaWireServer, engine=SqlEngine, ksql=KsqlServer,
                 ddl=REFERENCE_PIPELINE_DDL, gen=FleetGenerator,
                 scen=FleetScenario, car=CAR_SCHEMA, ksql_schema=KSQL_CAR_SCHEMA),
    "jax": dict(broker=JBroker, registry=JSchemaRegistry,
                registry_server=JSchemaRegistryServer,
                wire=JKafkaWireServer, engine=JSqlEngine, ksql=JKsqlServer,
                ddl=J_DDL, gen=JFleetGenerator, scen=JFleetScenario,
                car=J_CAR_SCHEMA, ksql_schema=J_KSQL_CAR_SCHEMA),
}


def _http(server, method, path, body=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=10)
    try:
        conn.request(method, path, None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _bridge_key(scen, car: int) -> bytes:
    return f"vehicles/sensor/data/{scen.car_id(car)}".encode()


def _records(broker, topic):
    return [(p, m.offset, m.key, m.value, m.timestamp_ms)
            for p in range(broker.topic(topic).partitions)
            for m in broker.fetch(topic, p, 0, 10 ** 6)]


def _stage(side):
    """The KSQL stage of one package, fed one fleet tick of JSON; returns
    what the checks read.  Every server is stopped before returning."""
    k = SIDE[side]
    broker = k["broker"]()
    broker.create_topic("sensor-data", partitions=PARTITIONS)
    broker.create_topic("model-predictions", partitions=PARTITIONS)
    registry = k["registry"]()
    registry.register(subject_for_topic("sensor-data"), k["car"].avro_json())
    registry.register(subject_for_topic(AVRO), k["ksql_schema"].avro_json())
    reg_srv = k["registry_server"](registry).start()
    wire = k["wire"](broker).start()
    owner = broker.restrict_topic(AVRO)
    engine = k["engine"](broker, registry=registry, trusted_passthrough=True,
                         owner_token=owner, passthrough_sample=32)
    ksql = k["ksql"](engine, pump_interval_s=3600).start()
    try:
        status, ddl = _http(ksql, "POST", "/ksql", {"ksql": k["ddl"]})
        scen = k["scen"](num_cars=N_CARS, failure_rate=0.05)
        gen = k["gen"](scen)
        cols = gen.step_columns()
        ts = int(gen.t * 1000)
        broker.produce_many("sensor-data", [
            (_bridge_key(scen, i),
             json.dumps(gen.row_record(cols, i, k["ksql_schema"])).encode(),
             ts) for i in range(N_CARS)])
        rounds = []
        while True:
            n = ksql.pump_now()
            rounds.append(n)
            if n == 0:
                break
        subjects = _http(reg_srv, "GET", "/subjects")
        sid = registry.latest(subject_for_topic(AVRO)).schema_id
        ends = [broker.end_offset(AVRO, p) for p in range(PARTITIONS)]
        refused = []
        for client_cls in (KafkaWireBroker, JKafkaWireBroker):
            cli = client_cls(f"127.0.0.1:{wire.port}")
            try:
                cli.produce(AVRO, b"external", key=b"k")
                refused.append(False)
            except PermissionError:
                refused.append(True)
            finally:
                cli.close()
        unmoved = ends == [broker.end_offset(AVRO, p)
                           for p in range(PARTITIONS)]
        queries = engine.execute("SHOW QUERIES")
    finally:
        ksql.stop()
        reg_srv.stop()
        wire.shutdown()
        wire.server_close()
    return {"broker": broker, "ddl": (status, ddl), "rounds": rounds,
            "subjects": subjects, "sid": sid, "refused": refused,
            "unmoved": unmoved, "queries": queries,
            "table": engine.table("SENSOR_DATA_EVENTS_PER_5MIN_T"),
            "topics": {t: _records(broker, t) for t in TOPICS}}


@pytest.fixture(scope="module")
def stages():
    return _stage("port"), _stage("jax")


def test_stage_topics_registry_and_ownership_equal_jax(stages):
    t, j = stages
    for key in ("ddl", "rounds", "subjects", "sid", "refused", "unmoved",
                "queries", "table", "topics"):
        assert t[key] == j[key], key
    assert t["ddl"][0] == 200 and len(t["ddl"][1]) == 4
    assert all(len(t["topics"][x]) == N_CARS for x in TOPICS)
    assert len(t["table"]) == N_CARS and \
        {v["EVENT_COUNT"] for v in t["table"].values()} == {1}
    assert t["refused"] == [True, True] and t["unmoved"]
    assert t["subjects"] == (200, ["SENSOR_DATA_S_AVRO-value",
                                   "SENSOR_DATA_S_AVRO_REKEY-value",
                                   "sensor-data-value"])
    assert {v[:5] for *_, v, _ in t["topics"][AVRO]} == {
        b"\x00" + t["sid"].to_bytes(4, "big")}
    assert all("error" not in q for q in t["queries"][0]["queries"])


def _specs():
    return [f"{AVRO}:{p}:0" for p in range(PARTITIONS)]


def _batches(side, broker):
    cls, cons = ((SensorBatches, StreamConsumer) if side == "port"
                 else (JSensorBatches, JStreamConsumer))
    return list(next(cls(cons(broker, _specs(), group="fit"),
                         batch_size=100, take=4,
                         only_normal=True).epochs(1)))


def _straight_avro():
    """The same generator rows published straight as framed Avro (the
    generator's own encoder) under the bridge's keys."""
    scen = FleetScenario(num_cars=N_CARS, failure_rate=0.05)
    gen = FleetGenerator(scen)
    cols = gen.step_columns()
    msgs = NativeCodec(KSQL_CAR_SCHEMA).encode_batch(
        gen.sensor_matrix(cols),
        cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
    b = Broker()
    b.create_topic(AVRO, partitions=PARTITIONS)
    b.produce_many(AVRO, [(_bridge_key(scen, i), m, int(gen.t * 1000))
                          for i, m in enumerate(msgs)])
    return b


def test_decoded_batches_equal_jax_and_straight_avro(stages):
    t, j = stages
    got = _batches("port", t["broker"])
    want = _batches("jax", j["broker"])
    straight = _batches("port", _straight_avro())
    assert len(got) == len(want) == len(straight) == 4
    for g, w, s in zip(got, want, straight):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.x, s.x)
        np.testing.assert_array_equal(g.mask, w.mask)
        np.testing.assert_array_equal(g.mask, s.mask)


def test_fit_and_scoring_equal_jax(stages):
    t, j = stages
    tt, jt = Trainer(CAR_AUTOENCODER, device="cpu"), JTrainer(J_AE)
    jt._ensure_state(np.zeros((100, 18), np.float32))
    st = jt.state
    adam = st.opt_state[0]
    tt.state = TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))
    th = tt.fit_compiled(_batches("port", t["broker"]), epochs=5)
    jh = jt.fit_compiled(_batches("jax", j["broker"]), epochs=5)
    np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
    j_params = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for name, v in tt.state.params.items():
        np.testing.assert_allclose(v.numpy(), j_params[name].numpy(),
                                   err_msg=name, **STATE_TOL)

    # the threshold: the 99th percentile of the training rows' errors
    tx = np.concatenate([b.x[: b.n_valid] for b in _batches(
        "port", t["broker"])])
    jx = np.concatenate([b.x[: b.n_valid] for b in _batches(
        "jax", j["broker"])])
    t_thr = float(np.percentile(reconstruction_errors(
        CAR_AUTOENCODER, tt.state.params, tx, device="cpu"), 99.0))
    j_thr = float(np.percentile(np.asarray(j_reconstruction_errors(
        J_AE, jt.state.params, jx)), 99.0))
    np.testing.assert_allclose(t_thr, j_thr, rtol=1e-5)

    ts = StreamScorer(CAR_AUTOENCODER, tt.state.params,
                      SensorBatches(StreamConsumer(t["broker"], _specs(),
                                                   group="serve"),
                                    batch_size=100, keep_labels=True),
                      OutputSequence(t["broker"], "model-predictions",
                                     partition=0),
                      threshold=t_thr, device="cpu")
    js = JStreamScorer(J_AE, jt.state.params,
                       JSensorBatches(JStreamConsumer(j["broker"], _specs(),
                                                      group="serve"),
                                      batch_size=100, keep_labels=True),
                       JOutputSequence(j["broker"], "model-predictions",
                                       partition=0),
                       threshold=t_thr)
    assert ts.score_available() == js.score_available() == N_CARS
    got = [m.value.decode() for m in t["broker"].fetch(
        "model-predictions", 0, 0, 10 ** 6)]
    want = [m.value.decode() for m in j["broker"].fetch(
        "model-predictions", 0, 0, 10 ** 6)]
    assert len(got) == len(want) == N_CARS
    verdicts = set()
    for g, w in zip(got, want):
        g_row, g_verdict, g_err = g.split("|")
        w_row, w_verdict, w_err = w.split("|")
        np.testing.assert_allclose(
            np.array(g_row.strip("[]").split(), np.float64),
            np.array(w_row.strip("[]").split(), np.float64),
            rtol=0, atol=PAYLOAD_ATOL)
        assert abs(round(float(g_err) * 1e6) - round(float(w_err) * 1e6)) \
            <= 1
        if abs(float(w_err) - t_thr) > VERDICT_MARGIN:
            assert g_verdict == w_verdict
        verdicts.add(g_verdict)
    assert verdicts == {"normal", "anomaly"}
