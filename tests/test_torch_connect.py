"""The port's Kafka Connect (``iotml_torch.connect``), its Avro container
writer (``ops.avro_container``) and the CSV fixture held against the JAX
package: the six cases of tests/test_connect.py, each run through both
packages on the same inputs, and the Connect REST surface.

Tolerances: everything here is exact.  Topic records (keys, values,
offsets), sink documents and committed offsets are equal; the OCF files
and the CSV fixture are byte-equal (an OCF file's default sync marker is
``md5(path)``, so both packages write at the same path, one after the
other); the training slice's batches are equal array for array; the REST
answers are equal as JSON but the ``worker_id`` (each server's own URL).
"""

import http.client
import json
import os
import urllib.parse

import numpy as np
import pytest

from iotml import connect as j_connect
from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL_CAR_SCHEMA
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen import simulator as j_sim
from iotml.ops import avro_container as j_ocf
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.streamproc.tasks import DelimitedToAvro as JDelimitedToAvro
from iotml_torch import connect as t_connect
from iotml_torch.core.schema import CSV_COLUMNS, KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen import simulator as t_sim
from iotml_torch.ops import avro_container as t_ocf
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.streamproc.tasks import DelimitedToAvro

PKGS = {"port": (t_connect, Broker, t_sim, KSQL_CAR_SCHEMA),
        "jax": (j_connect, JBroker, j_sim, J_KSQL_CAR_SCHEMA)}


def _records(broker, topic):
    out = []
    for p in range(broker.topic(topic).partitions):
        out += [(m.partition, m.offset, m.key, m.value, m.timestamp_ms)
                for m in broker.fetch(topic, p, 0, 1 << 30)]
    return out


def _write_lines(path, lines, header=None):
    with open(path, "w") as fh:
        if header:
            fh.write(header + "\n")
        for line in lines:
            fh.write(line + "\n")


def test_csv_columns_and_field_names_equal_jax():
    from iotml.core.schema import CSV_COLUMNS as J_CSV_COLUMNS

    assert CSV_COLUMNS == J_CSV_COLUMNS
    assert KSQL_CAR_SCHEMA.field_names == J_KSQL_CAR_SCHEMA.field_names


def test_file_stream_source_replays_and_tails(tmp_path):
    got = {}
    for kind, (conn, broker_cls, _, _) in PKGS.items():
        path = str(tmp_path / f"{kind}.csv")
        _write_lines(path, ["r1", "r2"], header="h")
        broker = broker_cls()
        w = conn.ConnectWorker(broker)
        src = conn.FileStreamSource(path, "car-data-csv", skip_header=True)
        w.add_source("csv", src)
        first = w.run_once()
        with open(path, "a") as fh:
            fh.write("r3\n")
            fh.write("partial")  # no newline yet: must not flow
        second = w.run_once()
        got[kind] = (first, second, src.state(),
                     _records(broker, "car-data-csv"))
    assert got["port"] == got["jax"]
    first, second, state, recs = got["port"]
    assert first == {"csv": 2} and second == {"csv": 1}
    assert [r[3] for r in recs] == [b"r1", b"r2", b"r3"]
    # a restored source resumes at the saved position
    src = t_connect.FileStreamSource(str(tmp_path / "port.csv"), "t",
                                     skip_header=True)
    src.restore(state)
    with open(tmp_path / "port.csv", "a") as fh:
        fh.write("\n")
    assert [r.value for r in src.poll()] == [b"partial"]


def test_document_store_sink_digital_twin(tmp_path):
    """Latest state per car, keyed by the hoisted key; the persisted JSON
    file byte-equal to JAX's and reloaded by either package."""
    got = {}
    for kind, (conn, broker_cls, _, _) in PKGS.items():
        store_path = str(tmp_path / f"{kind}.json")
        broker = broker_cls()
        broker.create_topic("sensor-data", partitions=2)
        for car, speed in [("car-1", 10), ("car-2", 20), ("car-1", 30)]:
            broker.produce("sensor-data",
                           json.dumps({"speed": speed}).encode(),
                           key=car.encode())
        broker.produce("sensor-data", b"not json", key=b"car-3")
        broker.produce("sensor-data", b"[1, 2]", key=b"car-4")
        w = conn.ConnectWorker(broker)
        sink = conn.DocumentStoreSink(store_path)
        w.add_sink("mongo", sink, ["sensor-data"],
                   transforms=[conn.HoistFieldKey()])
        counts = w.run_once()
        with open(store_path, "rb") as fh:
            blob = fh.read()
        got[kind] = (counts, sink.docs, sink.count(), blob,
                     broker.committed("connect-mongo", "sensor-data", 0),
                     broker.committed("connect-mongo", "sensor-data", 1))
    assert got["port"] == got["jax"]
    sink = t_connect.DocumentStoreSink(str(tmp_path / "jax.json"))
    assert sink.find_one("car-1")["speed"] == 30
    assert sink.find_one("car-2")["_id"] == "car-2"
    assert sink.find_one("car-4") == {"value": [1, 2], "_id": "car-4"}


@pytest.mark.parametrize("flush_size", [120, 1000])
def test_object_store_sink_avro_lake(tmp_path, flush_size):
    """Framed Avro topic → .avro container files: the same names, and the
    same bytes written at the same paths; each package reads both."""
    lake = str(tmp_path / "lake")
    files = {}
    for kind, (conn, broker_cls, sim, schema) in PKGS.items():
        broker = broker_cls()
        sim.FleetGenerator(sim.FleetScenario(num_cars=10)).publish(
            broker, "SENSOR_DATA_S_AVRO", n_ticks=30, partitions=2)
        w = conn.ConnectWorker(broker)
        sink = conn.ObjectStoreSink(lake, schema, flush_size=flush_size)
        w.add_sink("gcs", sink, ["SENSOR_DATA_S_AVRO"])
        assert w.run_once() == {"gcs": 300}
        files[kind] = {}
        for f in sorted(os.listdir(lake)):
            path = os.path.join(lake, f)
            with open(path, "rb") as fh:
                files[kind][f] = fh.read()
            os.remove(path)
        assert sorted(os.path.basename(p) for p in sink.files_written) == \
            list(files[kind])
    assert files["port"] == files["jax"]
    names = list(files["port"])
    assert names[0] == "SENSOR_DATA_S_AVRO+0+0000000000.avro"
    total = []
    for name, blob in files["port"].items():
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            fh.write(blob)
        schema, records = t_ocf.read_container(path)
        assert schema.field_names == KSQL_CAR_SCHEMA.field_names
        assert records == j_ocf.read_container(path)[1]
        total.extend(records)
    assert len(total) == 300
    assert all(isinstance(r["SPEED"], float) for r in total[:5])


def _ocf_records(n):
    return [{f.name: (float(i) + 0.25 if f.avro_type == "double" else
                      i if f.avro_type == "int" else "false")
             for f in KSQL_CAR_SCHEMA.fields} for i in range(n)]


@pytest.mark.parametrize("sync", [None, bytes(range(16))])
def test_container_roundtrip_dicts(tmp_path, sync):
    path = str(tmp_path / "x.avro")
    recs = _ocf_records(7)
    blobs = {}
    for kind, ocf, schema in (("jax", j_ocf, J_KSQL_CAR_SCHEMA),
                              ("port", t_ocf, KSQL_CAR_SCHEMA)):
        with ocf.ContainerWriter(path, schema, sync=sync) as w:
            assert w.write_block(recs[:4]) == 4
            assert w.write_block([]) == 0
            w.write_block([w.codec.encode(r) for r in recs[4:]])
            assert w.records_written == 7
        with open(path, "rb") as fh:
            blobs[kind] = fh.read()
        # each package reads the file the other (or it) wrote
        assert t_ocf.read_container(path)[1] == recs
        assert j_ocf.read_container(path)[1] == recs
    assert blobs["port"] == blobs["jax"]
    with pytest.raises(ValueError, match="16 bytes"):
        t_ocf.ContainerWriter(str(tmp_path / "y.avro"), KSQL_CAR_SCHEMA,
                              sync=b"short")
    bad = str(tmp_path / "bad.avro")
    with open(bad, "wb") as fh:
        fh.write(b"nope")
    with pytest.raises(ValueError, match="not an Avro container"):
        t_ocf.read_container(bad)
    torn = blobs["port"][:-1] + bytes([blobs["port"][-1] ^ 1])
    with open(bad, "wb") as fh:
        fh.write(torn)
    with pytest.raises(ValueError, match="bad sync marker"):
        t_ocf.read_container(bad)


def test_sink_resumes_from_committed_offsets():
    got = {}
    for kind, (conn, broker_cls, _, _) in PKGS.items():
        broker = broker_cls()
        broker.create_topic("t")
        broker.produce("t", json.dumps({"a": 1}).encode(), key=b"k1")
        w = conn.ConnectWorker(broker)
        sink = conn.DocumentStoreSink()
        w.add_sink("s", sink, ["t"])
        first = w.run_once()
        # restart: a new worker + sink resumes after the commit, not at 0
        broker.produce("t", json.dumps({"a": 2}).encode(), key=b"k2")
        w2 = conn.ConnectWorker(broker)
        sink2 = conn.DocumentStoreSink()
        w2.add_sink("s", sink2, ["t"])
        second = w2.run_once()
        # from_committed=False replays the whole topic; remove() ends it
        w3 = conn.ConnectWorker(broker)
        sink3 = conn.DocumentStoreSink()
        w3.add_sink("s", sink3, ["t"], from_committed=False)
        third = w3.run_once()
        removed = (w3.remove("s"), w3.remove("s"), w3.run_once())
        got[kind] = (first, second, sink2.docs, third, sink3.docs, removed,
                     broker.committed("connect-s", "t", 0))
    assert got["port"] == got["jax"]
    assert got["port"][1] == {"s": 1}
    assert got["port"][2] == {"k2": {"a": 2, "_id": "k2"}}


def test_csv_fixture_to_training_slice(tmp_path):
    """The reference's offline fixture chain: CSV file → FileStreamSource
    → topic → KSQL-equivalent CSV→Avro → training batches (reference
    test_file_source_and _testdata.sh:41-66), through both packages."""
    blobs, batches = {}, {}
    for kind, (conn, broker_cls, sim, _) in PKGS.items():
        path = str(tmp_path / f"{kind}-car-sensor-data.csv")
        assert sim.write_csv_fixture(path, n_rows=250) == 250
        with open(path, "rb") as fh:
            blobs[kind] = fh.read()
        broker = broker_cls()
        w = conn.ConnectWorker(broker)
        w.add_source("csv", conn.FileStreamSource(path, "car-data-csv",
                                                  skip_header=True))
        w.run_once()
        task_cls, consumer_cls, batches_cls = \
            (DelimitedToAvro, StreamConsumer, SensorBatches) \
            if kind == "port" else \
            (JDelimitedToAvro, JStreamConsumer, JSensorBatches)
        task = task_cls(broker, src="car-data-csv",
                        dst="SENSOR_DATA_S_AVRO")
        assert task.process_available() == 250
        consumer = consumer_cls(broker, ["SENSOR_DATA_S_AVRO:0:0"],
                                group="g")
        batches[kind] = list(batches_cls(consumer, batch_size=25))
    assert blobs["port"] == blobs["jax"]
    assert blobs["port"].split(b"\n")[0].decode() == ",".join(CSV_COLUMNS)
    assert len(batches["port"]) == len(batches["jax"]) == 10
    for t, j in zip(batches["port"], batches["jax"]):
        assert t.x.shape == (25, 18) and t.n_valid == j.n_valid == 25
        np.testing.assert_array_equal(t.x, j.x)
        np.testing.assert_array_equal(t.mask, j.mask)


# ------------------------------------------------------------------ REST
def _call(url, method, path, body=None):
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=10)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        return r.status, (json.loads(data) if data else None)
    finally:
        conn.close()


def _answer(srv, method, path, body=None):
    """(status, JSON) of one call, the status's ``worker_id`` (the
    server's own URL) checked and taken out."""
    status, doc = _call(srv.url, method, path, body)
    if isinstance(doc, dict) and isinstance(doc.get("connector"), dict):
        assert doc["connector"].pop("worker_id") == srv.url
    return status, doc


def _rest_script(srv, tmp_path):
    """One script of connector CRUD and status calls; every answer (the
    configs name the same paths for both servers)."""
    csv = str(tmp_path / "rest.csv")
    _write_lines(csv, ["a", "b", "c"], header="h")
    lake = str(tmp_path / "rest-lake")
    calls = [
        ("GET", "/connector-plugins", None),
        ("GET", "/connectors", None),
        ("POST", "/connectors", {"name": "csv", "config": {
            "connector.class":
                "org.apache.kafka.connect.file.FileStreamSourceConnector",
            "file": csv, "topic": "car-data-csv", "skip.header": "true"}}),
        ("POST", "/connectors", {"name": "twin", "config": {
            "connector.class": "com.mongodb.kafka.connect.MongoSinkConnector",
            "topics": "car-data-csv", "hoist.key.field": "car"}}),
        ("POST", "/connectors", {"name": "lake", "config": {
            "connector.class": "io.confluent.connect.gcs.GcsSinkConnector",
            "topics": "SENSOR_DATA_S_AVRO", "directory": lake,
            "flush.size": "50"}}),
        ("POST", "/connectors", {"name": "csv", "config": {
            "connector.class": "FileStreamSource", "file": csv,
            "topic": "x"}}),
        ("POST", "/connectors", {"name": "bad", "config": {
            "connector.class": "NoSuchConnector"}}),
        ("POST", "/connectors", {"name": "nofile", "config": {
            "connector.class": "filestreamsource", "topic": "x"}}),
        ("POST", "/connectors", {"config": {}}),
        ("GET", "/connectors", None),
        ("GET", "/connectors/twin", None),
        ("GET", "/connectors/twin/config", None),
        ("GET", "/connectors/nope", None),
        ("GET", "/connectors/nope/status", None),
        ("PUMP", None, None),
        ("GET", "/connectors/csv/status", None),
        ("GET", "/connectors/twin/status", None),
        ("GET", "/connectors/lake/status", None),
        ("DELETE", "/connectors/lake", None),
        ("DELETE", "/connectors/lake", None),
        ("GET", "/connectors", None),
    ]
    out = []
    for method, path, body in calls:
        if method == "PUMP":
            out.append(("pump", srv.pump_now()))
            continue
        out.append((method, path) + _answer(srv, method, path, body))
    return out


def test_connect_rest_answers_equal_jax(tmp_path):
    """The connector CRUD and status routes, the reference FQCN aliases
    and the error answers (400, 404, 409) of both servers to one script;
    `register_sink` books a programmatic connector as the REST path
    does."""
    answers = {}
    for kind, (conn, broker_cls, sim, _) in PKGS.items():
        broker = broker_cls()
        sim.FleetGenerator(sim.FleetScenario(num_cars=10)).publish(
            broker, "SENSOR_DATA_S_AVRO", n_ticks=12)
        srv = conn.ConnectServer(conn.ConnectWorker(broker),
                                 poll_interval_s=3600).start()
        try:
            answers[kind] = _rest_script(srv, tmp_path)
            sink = conn.DocumentStoreSink(id_field="car")
            srv.register_sink("car-health-twin", sink, ["car-health"],
                              kind="DocumentStoreSink",
                              config={"connector.class": "DocumentStoreSink",
                                      "topics": "car-health"})
            with pytest.raises(ValueError, match="already exists"):
                srv.register_sink("car-health-twin", sink, ["car-health"],
                                  kind="DocumentStoreSink")
            broker.produce("car-health", b'{"car": "c1", "state": "ALERT"}',
                           key=b"c1")
            srv.pump_now()
            answers[kind].append(_answer(
                srv, "GET", "/connectors/car-health-twin/status"))
            answers[kind].append(sink.docs)
        finally:
            srv.stop()
    assert answers["port"] == answers["jax"]
    got = {(a[0], a[1]): a[2] for a in answers["port"][:-2]
           if a[0] != "pump"}
    assert got[("DELETE", "/connectors/lake")] == 404  # the second one
    statuses = [a[2] for a in answers["port"][2:9]]
    assert statuses == [201, 201, 201, 409, 400, 400, 400]
    plugins = answers["port"][0][3]
    assert {p["class"] for p in plugins} == {
        "FileStreamSource", "DocumentStoreSink", "ObjectStoreSink"}
    assert set(t_connect.server.PLUGIN_ALIASES) == \
        set(j_connect.server.PLUGIN_ALIASES)
    assert t_connect.server.PLUGIN_ALIASES == \
        j_connect.server.PLUGIN_ALIASES
    assert answers["port"][-1] == {"c1": {"car": "c1", "state": "ALERT"}}


def test_connect_serves_the_tsdb_as_jax(tmp_path):
    """`attach_tsdb`: /query and /query_range over the port's TSDB answer
    as JAX's server does over the same `_IOTML_TSDB` records."""
    from iotml.obs import tsdb as j_tsdb
    from iotml_torch.obs import tsdb as t_tsdb

    answers = {}
    for kind, (conn, broker_cls, _, _), tsdb in (
            ("port",) + (PKGS["port"], t_tsdb),
            ("jax",) + (PKGS["jax"], j_tsdb)):
        broker = broker_cls()
        app = tsdb.TsdbAppender(broker)
        for i in range(6):
            app.append([("x_total", {"topic": "a"}, 10.0 * i),
                        ("g", {}, 2.5 + i)], ts_ms=1_000 + 15_000 * i)
        srv = conn.ConnectServer(conn.ConnectWorker(broker),
                                 poll_interval_s=3600).start()
        try:
            srv.attach_tsdb(broker)
            q = urllib.parse.quote
            answers[kind] = [
                _call(srv.url, "GET", "/query?query=" + q("g")
                      + "&time_ms=80000"),
                _call(srv.url, "GET", "/query?query="
                      + q("rate(x_total[1m])") + "&time_ms=76000"),
                _call(srv.url, "GET", "/query_range?query=" + q("g")
                      + "&start_ms=1000&end_ms=76000&step_ms=15000"),
                _call(srv.url, "GET", "/query"),
                _call(srv.url, "GET", "/query?query=" + q("rate(")),
                _call(srv.url, "GET", "/query_range?query=g"),
            ]
        finally:
            srv.stop()
    assert answers["port"] == answers["jax"]
    assert [a[0] for a in answers["port"]] == [200, 200, 200, 400, 400, 400]
