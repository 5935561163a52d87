"""The Confluent Schema Registry REST API over ``SchemaRegistry``
(``iotml.stream.registry_server``'s copy).

The reference registers schemas by POSTing Avro JSON to the registry
(``testdata/Test-Load-csv/register_schema.py:20-31``: ``POST
/subjects/{subject}/versions`` with ``{"schema": "<avsc>"}``), and its
consumers resolve frame ids with ``GET /schemas/ids/{id}``:

  POST /subjects/{subject}/versions   {"schema": avsc}  → {"id": n}
  POST /subjects/{subject}            {"schema": avsc}  → registered version
  GET  /subjects                                        → ["s", ...]
  GET  /subjects/{subject}/versions                     → [1, 2, ...]
  GET  /subjects/{subject}/versions/latest|{n}          → full entry
  GET  /schemas/ids/{id}                                → {"schema": avsc}
  GET  /config                                          → compatibility
"""

from __future__ import annotations

import json

from ..utils.rest import RestError, RestServer
from .registry import RegisteredSchema, SchemaRegistry


def _entry(rs: RegisteredSchema) -> dict:
    return {"subject": rs.subject, "version": rs.version,
            "id": rs.schema_id, "schema": rs.avsc}


class SchemaRegistryServer(RestServer):
    """REST front-end for one `SchemaRegistry`."""

    def __init__(self, registry: SchemaRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        super().__init__(host, port, name="iotml-schema-registry")
        self.registry = registry
        sub = r"([^/]+)"
        self.route("GET", r"/subjects", self._subjects)
        self.route("POST", rf"/subjects/{sub}/versions", self._register)
        self.route("POST", rf"/subjects/{sub}", self._check)
        self.route("GET", rf"/subjects/{sub}/versions", self._versions)
        self.route("GET", rf"/subjects/{sub}/versions/latest", self._latest)
        self.route("GET", rf"/subjects/{sub}/versions/(\d+)", self._version)
        self.route("GET", r"/schemas/ids/(\d+)", self._by_id)
        self.route("GET", r"/config", lambda m, b: (
            200, {"compatibilityLevel": "BACKWARD"}))

    # ------------------------------------------------------------- routes
    def _subjects(self, m, body):
        return 200, self.registry.subjects()

    def _register(self, m, body):
        avsc = body.get("schema")
        if not avsc:
            raise RestError(422, "missing 'schema' field")
        try:
            sid = self.registry.register(m.group(1), avsc)
        except ValueError as e:
            # Confluent's 42201: invalid Avro schema
            raise RestError(422, f"invalid schema: {e}")
        return 200, {"id": sid}

    def _check(self, m, body):
        avsc = body.get("schema")
        if not avsc:
            raise RestError(422, "missing 'schema' field")
        try:
            sid = self.registry.check(m.group(1), avsc)
        except ValueError as e:
            raise RestError(422, f"invalid schema: {e}")
        if sid is None:
            # Confluent's 40403: schema not found under subject
            raise RestError(404, "schema not found")
        for rs in self._all_versions(m.group(1)):
            if rs.schema_id == sid:
                return 200, _entry(rs)
        raise RestError(404, "schema not found")

    def _all_versions(self, subject):
        try:
            n = self.registry.latest(subject).version
        except KeyError:
            return []
        return [self.registry.version(subject, v) for v in range(1, n + 1)]

    def _versions(self, m, body):
        versions = self._all_versions(m.group(1))
        if not versions:
            raise RestError(404, f"subject {m.group(1)!r} not found")
        return 200, [rs.version for rs in versions]

    def _latest(self, m, body):
        try:
            return 200, _entry(self.registry.latest(m.group(1)))
        except KeyError as e:
            raise RestError(404, str(e))

    def _version(self, m, body):
        try:
            return 200, _entry(self.registry.version(m.group(1),
                                                     int(m.group(2))))
        except KeyError as e:
            raise RestError(404, str(e))

    def _by_id(self, m, body):
        try:
            rs = self.registry.by_id(int(m.group(1)))
        except KeyError as e:
            raise RestError(404, str(e))
        return 200, {"schema": rs.avsc}
