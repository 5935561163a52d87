"""The port's schema registry (``iotml_torch.stream.registry``) and its
Confluent REST server (``iotml_torch.stream.registry_server``) held
against the JAX package's on the CPU.

Tolerances: exact.  Ids, versions, ``check``, ``parse_avsc``,
``fingerprint`` and ``subject_for_topic`` equal JAX's for the same
sequence of calls; the REST server's status codes and JSON bodies equal
JAX's server's for one request sequence (404, 422, routes with query
strings, the registry's errors).  Every server binds 127.0.0.1:0 and is
stopped by the test that starts it.
"""

import http.client
import json

import numpy as np
import pytest

from iotml.core.schema import CAR_SCHEMA as J_CAR_SCHEMA
from iotml.core.schema import KSQL_CAR_SCHEMA as J_KSQL_CAR_SCHEMA
from iotml.stream import registry as j_registry
from iotml.stream.registry_server import \
    SchemaRegistryServer as JSchemaRegistryServer
from iotml_torch.core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from iotml_torch.ops.avro import AvroCodec
from iotml_torch.ops.framing import frame, unframe
from iotml_torch.stream import registry as t_registry
from iotml_torch.stream.registry_server import SchemaRegistryServer

SCHEMAS = {"car": (CAR_SCHEMA, J_CAR_SCHEMA),
           "ksql": (KSQL_CAR_SCHEMA, J_KSQL_CAR_SCHEMA)}


def _sequence(mod, car_avsc, ksql_avsc):
    """One sequence of registry calls; every answer or error class."""
    reg = mod.SchemaRegistry()
    out = []

    def call(fn, *a):
        try:
            r = fn(*a)
        except (KeyError, ValueError) as e:
            return ("raise", type(e).__name__, str(e))
        if isinstance(r, mod.RegisteredSchema):
            return (r.schema_id, r.subject, r.version, r.avsc)
        return r

    out.append(call(reg.check, "s-value", car_avsc))
    out.append(call(reg.register, "s-value", car_avsc))
    out.append(call(reg.register, "s-value", car_avsc))
    out.append(call(reg.register, "s-value", ksql_avsc))
    out.append(call(reg.register, "other-value", car_avsc))
    out.append(call(reg.register, "s-value", json.dumps(json.loads(
        car_avsc))))  # whitespace only: the same fingerprint
    out.append(call(reg.register, "s-value", "{not json"))
    for sid in (1, 2, 3, 99):
        out.append(call(reg.by_id, sid))
    for subject in ("s-value", "other-value", "nope"):
        out.append(call(reg.latest, subject))
    for subject, v in (("s-value", 1), ("s-value", 2), ("s-value", 3),
                       ("other-value", 1)):
        out.append(call(reg.version, subject, v))
    out.append(call(reg.subjects))
    for subject, avsc in (("s-value", car_avsc), ("s-value", ksql_avsc),
                          ("other-value", ksql_avsc), ("nope", car_avsc)):
        out.append(call(reg.check, subject, avsc))
    return out


def test_registry_call_sequence_equals_jax():
    got = _sequence(t_registry, CAR_SCHEMA.avro_json(),
                    KSQL_CAR_SCHEMA.avro_json())
    want = _sequence(j_registry, J_CAR_SCHEMA.avro_json(),
                     J_KSQL_CAR_SCHEMA.avro_json())
    assert got == want
    assert got[1] == 1 and got[3] == 2 and got[4] == 1


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_register_record_schema_and_framing_equal_jax(name):
    t_schema, j_schema = SCHEMAS[name]
    t_reg, j_reg = t_registry.SchemaRegistry(), j_registry.SchemaRegistry()
    for reg in (t_reg, j_reg):
        reg.register("sensor-data-value", J_CAR_SCHEMA.avro_json())
    sid = t_reg.register_record_schema("SENSOR_DATA_S_AVRO", t_schema)
    assert sid == j_reg.register_record_schema("SENSOR_DATA_S_AVRO",
                                               j_schema)
    assert t_reg.subjects() == j_reg.subjects()
    codec = AvroCodec(t_schema)
    rec = {f.name: (0.5 if f.avro_type in ("double", "float") else
                    1 if f.avro_type == "int" else "false")
           for f in t_schema.fields}
    got_id, payload = unframe(frame(codec.encode(rec), schema_id=sid))
    assert AvroCodec(t_reg.by_id(got_id).record_schema).decode(payload) \
        == rec


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_parse_avsc_equals_jax(name):
    t_schema, j_schema = SCHEMAS[name]
    got = t_registry.parse_avsc(t_schema.avro_json())
    want = j_registry.parse_avsc(j_schema.avro_json())
    assert got.name == want.name and got.namespace == want.namespace
    assert got.label_field == want.label_field
    assert [(f.name, f.avro_type, f.nullable, f.doc) for f in got.fields] \
        == [(f.name, f.avro_type, f.nullable, f.doc) for f in want.fields]
    assert [f.name for f in got.fields] == [f.name for f in t_schema.fields]
    assert got.avro_json() == want.avro_json()


@pytest.mark.parametrize("avsc", [
    '{"type": "enum", "name": "E", "symbols": ["A"]}',
    '{"type": "record", "name": "R", "fields": [{"name": "x", "type": '
    '["null", "int", "string"]}]}',
    '{"type": "record", "name": "R", "fields": [{"name": "x", "type": '
    '{"type": "array", "items": "int"}}]}',
    '{"type": "record", "name": "R", "fields": []}',
])
def test_parse_avsc_errors_equal_jax(avsc):
    def outcome(mod):
        try:
            s = mod.parse_avsc(avsc)
        except ValueError as e:
            return ("raise", str(e))
        return (s.name, s.fields, s.label_field)

    assert outcome(t_registry) == outcome(j_registry)


def test_fingerprint_and_subject_naming_equal_jax():
    rng = np.random.default_rng(0)
    a = CAR_SCHEMA.avro_json()
    variants = [a, json.dumps(json.loads(a)),
                json.dumps(json.loads(a), indent=int(rng.integers(1, 8))),
                KSQL_CAR_SCHEMA.avro_json()]
    got = [t_registry.fingerprint(v) for v in variants]
    assert got == [j_registry.fingerprint(v) for v in variants]
    assert got[0] == got[1] == got[2] != got[3]
    for topic in ("sensor-data", "SENSOR_DATA_S_AVRO", "x-y"):
        for is_key in (False, True):
            assert t_registry.subject_for_topic(topic, is_key) == \
                j_registry.subject_for_topic(topic, is_key)


def test_reserved_id_band_equals_jax():
    assert t_registry.RESERVED_ID_BASE == j_registry.RESERVED_ID_BASE
    outs = []
    for mod in (t_registry, j_registry):
        reg = mod.SchemaRegistry()
        reg._next_id = mod.RESERVED_ID_BASE
        with pytest.raises(RuntimeError) as ei:
            reg.register("s-value", CAR_SCHEMA.avro_json())
        outs.append(str(ei.value))
    assert outs[0] == outs[1]


# ----------------------------------------------------------------- REST
def _req(server, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection(server.host, server.port, timeout=5)
    try:
        payload = raw if raw is not None else (
            json.dumps(body) if body is not None else None)
        conn.request(method, path, payload,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        data = r.read()
        return r.status, r.getheader("Content-Type"), \
            (json.loads(data) if data else None)
    finally:
        conn.close()


def _rest_sequence(server, car_avsc, ksql_avsc):
    steps = [
        ("GET", "/subjects", None),
        ("POST", "/subjects/sensor-data-value/versions", {"schema": car_avsc}),
        ("POST", "/subjects/sensor-data-value/versions", {"schema": car_avsc}),
        ("POST", "/subjects/sensor-data-value/versions?normalize=false",
         {"schema": ksql_avsc}),
        ("GET", "/subjects?deleted=false", None),
        ("GET", "/schemas/ids/1", None),
        ("GET", "/schemas/ids/2", None),
        ("GET", "/schemas/ids/99", None),
        ("GET", "/subjects/sensor-data-value/versions", None),
        ("GET", "/subjects/nope/versions", None),
        ("GET", "/subjects/sensor-data-value/versions/latest", None),
        ("GET", "/subjects/nope/versions/latest", None),
        ("GET", "/subjects/sensor-data-value/versions/1", None),
        ("GET", "/subjects/sensor-data-value/versions/7", None),
        ("POST", "/subjects/sensor-data-value", {"schema": car_avsc}),
        ("POST", "/subjects/other", {"schema": car_avsc}),
        ("POST", "/subjects/s", {"schema": "not json"}),
        ("POST", "/subjects/s/versions", {}),
        ("POST", "/subjects/s/versions", {"schema": "not json"}),
        ("POST", "/subjects/s", {}),
        ("GET", "/config", None),
        ("GET", "/bogus", None),
        ("DELETE", "/subjects/s", None),
    ]
    out = [_req(server, m, p, b) for m, p, b in steps]
    out.append(_req(server, "POST", "/subjects/s/versions", raw="{oops"))
    return out


def test_rest_server_answers_equal_jax():
    t_srv = SchemaRegistryServer(t_registry.SchemaRegistry()).start()
    j_srv = JSchemaRegistryServer(j_registry.SchemaRegistry()).start()
    try:
        got = _rest_sequence(t_srv, CAR_SCHEMA.avro_json(),
                             KSQL_CAR_SCHEMA.avro_json())
        want = _rest_sequence(j_srv, J_CAR_SCHEMA.avro_json(),
                              J_KSQL_CAR_SCHEMA.avro_json())
    finally:
        t_srv.stop()
        j_srv.stop()
    assert got == want
    codes = [status for status, _, _ in got]
    assert {200, 400, 404, 422} <= set(codes)
    assert got[1][2] == {"id": 1} and got[3][2] == {"id": 2}
    assert got[4][2] == ["sensor-data-value"]
