"""Kafka-Connect REST API over `ConnectWorker`
(``iotml.connect.server``'s copy).

The reference manages its connectors entirely through Connect's REST
interface — `POST /connectors` with `{"name", "config"}` JSON, status
checks, and deletes (reference `infrastructure/kafka-connect/mongodb/
README.md:139-175`, `gcs/README.md:21-43`) — with connector behavior
chosen by the `connector.class` config key.  This server provides that
surface over the in-process runtime, mapping the reference's three
connector classes onto the port's implementations:

  FileStreamSource (`file_stream_demo_standalone.properties:2-8`)
      config: file, topic, skip.header
  DocumentStoreSink  (the MongoDB digital-twin sink,
      `mongodb-connector-configmap.yaml:6-23`)
      config: topics, path, hoist.key.field (HoistField$Key SMT)
  ObjectStoreSink    (the GCS data-lake sink, `gcs/README.md:21-43`)
      config: topics, directory, flush.size

Endpoints:
  GET    /connectors                      → ["name", ...]
  POST   /connectors                      {"name","config"} → created entry
  GET    /connectors/{name}               → {"name","config","tasks"}
  GET    /connectors/{name}/config        → config
  GET    /connectors/{name}/status        → RUNNING + per-pass record count
  DELETE /connectors/{name}               → 204
  GET    /connector-plugins               → available classes

With a digital twin attached (`attach_twin`, ``twin``), the surface the
reference queried MongoDB for is served here directly:
  GET    /twin                            → {"count", "cars": [ids...]}
  GET    /twin/{car_id}                   → latest state + rolling
                                            aggregates (404 unknown car)
  DELETE /twin/{car_id}                   → 204; tombstones the car out
                                            of the compacted changelog

With the telemetry TSDB attached (`attach_tsdb`, ``obs.tsdb``):
  GET    /query, /query_range             → Prometheus HTTP API shapes

A background thread drives `ConnectWorker.run_once()` continuously
(Connect's task threads); `pump_now()` runs one deterministic pass.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..core.schema import KSQL_CAR_SCHEMA
from ..utils.rest import RestError, RestServer
from .connectors import (DocumentStoreSink, FileStreamSource, HoistFieldKey,
                         ObjectStoreSink)
from .runtime import ConnectWorker

#: connector.class aliases accepted in configs (reference-style FQCNs too).
PLUGIN_ALIASES = {
    "filestreamsource": "FileStreamSource",
    "org.apache.kafka.connect.file.filestreamsourceconnector": "FileStreamSource",
    "documentstoresink": "DocumentStoreSink",
    "com.mongodb.kafka.connect.mongosinkconnector": "DocumentStoreSink",
    "objectstoresink": "ObjectStoreSink",
    "io.confluent.connect.gcs.gcssinkconnector": "ObjectStoreSink",
}


def _required(config: dict, key: str) -> str:
    v = config.get(key)
    if not v:
        raise RestError(400, f"missing required config {key!r}")
    return v


class ConnectServer(RestServer):
    """REST front-end + task-driver thread for one `ConnectWorker`."""

    def __init__(self, worker: ConnectWorker, host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 0.05):
        super().__init__(host, port, name="iotml-connect")
        self.worker = worker
        self.poll_interval_s = poll_interval_s
        self._lock = threading.Lock()
        self._configs: Dict[str, dict] = {}
        self._kinds: Dict[str, str] = {}
        self._counts: Dict[str, int] = {}
        self._stop = threading.Event()
        self._driver: Optional[threading.Thread] = None
        self.twin = None  # a twin.TwinService, via attach_twin

        name = r"([^/]+)"
        self.route("GET", r"/connectors", self._list)
        self.route("POST", r"/connectors", self._create)
        self.route("GET", rf"/connectors/{name}", self._get)
        self.route("GET", rf"/connectors/{name}/config", self._config)
        self.route("GET", rf"/connectors/{name}/status", self._status)
        self.route("DELETE", rf"/connectors/{name}", self._delete)
        self.route("GET", r"/connector-plugins", lambda m, b: (
            200, [{"class": c, "type": "source" if "Source" in c else "sink"}
                  for c in sorted(set(PLUGIN_ALIASES.values()))]))

    # --------------------------------------------------------- lifecycle
    def start(self):
        from ..supervise.registry import register_thread

        super().start()
        self._driver = register_thread(threading.Thread(
            target=self._drive, daemon=True, name="iotml-connect-driver"))
        self._driver.start()
        return self

    def stop(self):
        self._stop.set()
        if self._driver is not None:
            self._driver.join(timeout=2)
        super().stop()

    def _drive(self):
        while not self._stop.wait(self.poll_interval_s):
            self.pump_now()

    def pump_now(self) -> Dict[str, int]:
        """One deterministic worker pass; updates per-connector counts."""
        with self._lock:
            counts = self.worker.run_once()
            for k, v in counts.items():
                self._counts[k] = self._counts.get(k, 0) + v
            return counts

    # ------------------------------------------------------ construction
    def _instantiate(self, name: str, config: dict) -> str:
        cls = PLUGIN_ALIASES.get(
            str(config.get("connector.class", "")).lower())
        if cls is None:
            raise RestError(400, f"unknown connector.class "
                            f"{config.get('connector.class')!r}")
        if cls == "FileStreamSource":
            src = FileStreamSource(
                path=_required(config, "file"),
                topic=_required(config, "topic"),
                skip_header=str(config.get("skip.header", "false")).lower()
                == "true")
            self.worker.add_source(name, src)
        elif cls == "DocumentStoreSink":
            topics = [t.strip() for t in _required(config, "topics").split(",")]
            sink = DocumentStoreSink(path=config.get("path"))
            transforms = []
            hoist = config.get("hoist.key.field")
            if hoist:
                transforms.append(HoistFieldKey(field=hoist))
            self.worker.add_sink(name, sink, topics, transforms=transforms)
        else:  # ObjectStoreSink
            topics = [t.strip() for t in _required(config, "topics").split(",")]
            sink = ObjectStoreSink(
                directory=_required(config, "directory"),
                schema=KSQL_CAR_SCHEMA,
                flush_size=int(config.get("flush.size", 1000)),
                framed=str(config.get("framed", "true")).lower() == "true")
            self.worker.add_sink(name, sink, topics)
        return cls

    # ----------------------------------------------------- registration
    def register_sink(self, name: str, connector, topics, kind: str,
                      config: Optional[dict] = None,
                      transforms=()) -> None:
        """Register an ALREADY-CONSTRUCTED sink under the server's own
        bookkeeping (config/kind/count, under the lock) — the
        programmatic twin of the REST create path, for hosts that wire a
        connector instance directly (cli/up.py's car-health twin) rather
        than describing one by config."""
        with self._lock:
            if name in self._configs:
                raise ValueError(f"connector {name} already exists")
            self.worker.add_sink(name, connector, topics,
                                 transforms=transforms)
            self._configs[name] = dict(config or {})
            self._kinds[name] = kind
            self._counts[name] = 0

    # ------------------------------------------------------------ twin
    def attach_twin(self, twin) -> None:
        """Serve a TwinService's table over this REST surface — the
        reference's 'query MongoDB for the car document' becomes a GET
        against the connect API the operators already talk to.  Reads
        go straight to the in-memory table (no lock: the table is
        mutated by one pump thread and read lock-free, same discipline
        as the broker's metric gauges)."""
        self.twin = twin
        self.route("GET", r"/twin", self._twin_list)
        self.route("GET", r"/twin/([^/]+)", self._twin_get)
        self.route("DELETE", r"/twin/([^/]+)", self._twin_delete)

    def attach_tsdb(self, broker, partition: int = 0) -> None:
        """Serve the telemetry TSDB over this REST surface:
        `GET /query?query=<expr>[&time_ms=]` for instant evaluation and
        `GET /query_range?query=&start_ms=&end_ms=[&step_ms=]` for
        stepped series — the Prometheus HTTP API's shape, answered from
        the `_IOTML_TSDB` log replay instead of a separate TSDB
        process."""
        self.tsdb_broker = broker
        self.tsdb_partition = partition
        self.route("GET", r"/query", self._tsdb_query)
        self.route("GET", r"/query_range", self._tsdb_query_range)

    def _tsdb_series(self, start_ms=None):
        from ..obs import tsdb

        return tsdb.read_series(self.tsdb_broker, start_ms=start_ms,
                                partition=self.tsdb_partition)

    def _tsdb_query(self, m, body):
        from ..obs import tsdb

        expr = body.get("query") or body.get("expr")
        if not expr:
            raise RestError(400, "missing 'query' parameter")
        at_ms = int(body["time_ms"]) if body.get("time_ms") else None
        try:
            result = tsdb.query(self._tsdb_series(), expr, at_ms=at_ms)
        except ValueError as e:
            raise RestError(400, f"bad query: {e}")
        return 200, {"status": "success", "data": result}

    def _tsdb_query_range(self, m, body):
        from ..obs import tsdb

        expr = body.get("query") or body.get("expr")
        if not expr:
            raise RestError(400, "missing 'query' parameter")
        try:
            start = int(body["start_ms"])
            end = int(body["end_ms"])
        except (KeyError, ValueError):
            raise RestError(400, "range query needs integer 'start_ms' "
                            "and 'end_ms'")
        step = int(body.get("step_ms") or 15_000)
        # replay from before the range start: rate()/increase() at the
        # first steps look back across the range boundary
        horizon = start - 2 * tsdb.DEFAULT_LOOKBACK_MS
        try:
            result = tsdb.query(self._tsdb_series(start_ms=horizon), expr,
                                start_ms=start, end_ms=end, step_ms=step)
        except ValueError as e:
            raise RestError(400, f"bad query: {e}")
        return 200, {"status": "success", "data": result}

    #: page-size ceiling for GET /twin: a 100k-car table must never emit
    #: a multi-megabyte id dump per poll — callers page with
    #: limit/offset or take the count_only fast path
    TWIN_LIST_DEFAULT_LIMIT = 1000
    TWIN_LIST_MAX_LIMIT = 10_000

    def _twin_list(self, m, body):
        out = {"count": self.twin.count(),
               "rebuilt_from_changelog": self.twin.rebuilt_records}
        if str(body.get("count_only", "")).lower() in ("1", "true", "yes"):
            # fast path: len() of the table, no id list materialised
            return 200, out
        try:
            limit = int(body.get("limit", self.TWIN_LIST_DEFAULT_LIMIT))
            offset = int(body.get("offset", 0))
        except (TypeError, ValueError):
            raise RestError(400, "limit/offset must be integers")
        if limit < 0 or offset < 0:
            raise RestError(400, "limit/offset must be >= 0")
        limit = min(limit, self.TWIN_LIST_MAX_LIMIT)
        cars = self.twin.cars()
        page = cars[offset:offset + limit]
        out["cars"] = page
        out["offset"] = offset
        out["limit"] = limit
        # the resume cursor: None signals the last page, so pollers
        # walk `next_offset` until it nulls instead of guessing from
        # page fill (a filtered backend may return short pages)
        nxt = offset + len(page)
        out["next_offset"] = nxt if nxt < len(cars) else None
        return 200, out

    def _twin_get(self, m, body):
        doc = self.twin.get(m.group(1))
        if doc is None:
            raise RestError(404, f"no twin for car {m.group(1)!r}")
        return 200, doc

    def _twin_delete(self, m, body):
        if not self.twin.retire(m.group(1)):
            raise RestError(404, f"no twin for car {m.group(1)!r}")
        return 204, {}

    # ------------------------------------------------------------- routes
    def _list(self, m, body):
        with self._lock:
            return 200, sorted(self._configs)

    def _create(self, m, body):
        name = body.get("name")
        config = body.get("config", {})
        if not name:
            raise RestError(400, "missing connector name")
        with self._lock:
            if name in self._configs:
                # Connect's 409 on duplicate create
                raise RestError(409, f"connector {name} already exists")
            kind = self._instantiate(name, config)
            self._configs[name] = dict(config)
            self._kinds[name] = kind
            self._counts[name] = 0
        return 201, {"name": name, "config": config,
                     "tasks": [{"connector": name, "task": 0}]}

    def _entry(self, name: str) -> dict:
        if name not in self._configs:
            raise RestError(404, f"connector {name} not found")
        return {"name": name, "config": self._configs[name],
                "type": "source" if "Source" in self._kinds[name] else "sink",
                "tasks": [{"connector": name, "task": 0}]}

    def _get(self, m, body):
        with self._lock:
            return 200, self._entry(m.group(1))

    def _config(self, m, body):
        with self._lock:
            self._entry(m.group(1))
            return 200, self._configs[m.group(1)]

    def _status(self, m, body):
        with self._lock:
            entry = self._entry(m.group(1))
            return 200, {
                "name": entry["name"],
                "connector": {"state": "RUNNING", "worker_id": self.url},
                "tasks": [{"id": 0, "state": "RUNNING",
                           "records_processed": self._counts[m.group(1)]}],
                "type": entry["type"],
            }

    def _delete(self, m, body):
        name = m.group(1)
        with self._lock:
            self._entry(name)
            self.worker.remove(name)
            del self._configs[name]
            del self._kinds[name]
            self._counts.pop(name, None)
        return 204, {}
