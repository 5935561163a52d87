"""KSQL-equivalent REST API over ``SqlEngine``
(``iotml.streamproc.server``'s copy).

The reference drives its stream preprocessing through the KSQL server's
REST endpoint (``curl -X POST http://ksql:8088/ksql -d '{"ksql": "CREATE
STREAM ..."}'``, reference
``infrastructure/confluent/01_installConfluentPlatform.sh:229-258``), and
its docs verify pipelines with ``POST /query`` push queries:

  POST /ksql         {"ksql": "<stmts>"}  → JSON array, one entry/statement
  POST /query        {"ksql": "SELECT ...|PRINT ..."} → ND-JSON rows
  GET  /info         server metadata
  GET  /healthcheck  {"isHealthy": true}

A background pump thread (daemon, named and registered in
``supervise.registry``) advances every persistent query, KSQL's
continuous-query runtime, every ``pump_interval_s``; ``pump_now``
advances them synchronously.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from ..supervise.registry import register_thread
from ..utils.rest import RestError, RestServer
from .sql import SqlEngine, SqlError


class KsqlServer(RestServer):
    """REST front-end + continuous-query pump for one SqlEngine."""

    def __init__(self, engine: SqlEngine, host: str = "127.0.0.1",
                 port: int = 0, pump_interval_s: float = 0.05):
        super().__init__(host, port, name="iotml-ksql")
        self.engine = engine
        self._lock = threading.Lock()  # engine is not thread-safe per se
        self.pump_interval_s = pump_interval_s
        self._stop = threading.Event()
        self._pump_thread: Optional[threading.Thread] = None

        self.route("GET", r"/info", lambda m, b: (200, {"KsqlServerInfo": {
            "version": "iotml-sql-1.0", "kafkaClusterId": "iotml-broker",
            "ksqlServiceId": "iotml-ksql"}}))
        self.route("GET", r"/healthcheck",
                   lambda m, b: (200, {"isHealthy": True}))
        self.route("POST", r"/ksql", self._ksql)
        self.route("POST", r"/query", self._query)

    @staticmethod
    def _sql_of(body) -> str:
        if isinstance(body, dict):
            return body.get("ksql", body.get("sql", ""))
        if isinstance(body, str):  # bare SQL string body
            return body
        raise RestError(400, "body must be a JSON object with a 'ksql' field")

    def _ksql(self, m, body):
        sql = self._sql_of(body)
        try:
            with self._lock:
                return 200, self.engine.execute(sql)
        except SqlError as e:
            return 400, {"@type": "statement_error", "message": str(e),
                         "statementText": sql}

    def _query(self, m, body):
        sql = self._sql_of(body)
        try:
            with self._lock:
                results = self.engine.execute(sql)
        except SqlError as e:
            return 400, {"@type": "statement_error", "message": str(e)}
        lines = []
        for res in results:
            if "rows" in res and "header" in res:
                lines.append(json.dumps({"header": res["header"]},
                                        default=str))
                lines.extend(json.dumps({"row": r}, default=str)
                             for r in res["rows"])
            elif "rows" in res:  # PRINT
                lines.extend(json.dumps(r, default=str) for r in res["rows"])
            else:
                lines.append(json.dumps(res, default=str))
        body_bytes = ("\n".join(lines) + "\n").encode()
        return 200, body_bytes, "application/x-ndjson"

    # --------------------------------------------------------- lifecycle
    def start(self):
        super().start()
        self._pump_thread = register_thread(threading.Thread(
            target=self._pump_loop, daemon=True, name="iotml-ksql-pump"))
        self._pump_thread.start()
        return self

    def _pump_loop(self):
        while not self._stop.wait(self.pump_interval_s):
            try:
                with self._lock:
                    self.engine.pump()
            except Exception:
                # A failing query must not kill the continuous-query runtime
                # for every other query; poisoned rows are dropped upstream,
                # so anything landing here is transient or a bug — keep
                # pumping either way (KSQL keeps its query runtime alive and
                # surfaces errors per-query).
                pass

    def pump_now(self) -> int:
        """Synchronously advance continuous queries (deterministic tests)."""
        with self._lock:
            return self.engine.pump()

    def stop(self):
        self._stop.set()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2)
        super().stop()
