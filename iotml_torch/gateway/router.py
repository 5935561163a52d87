"""Scatter-gather routing over the sharded twin plane
(``iotml.gateway.router``'s copy).

Two consumers, one map:

* ``GatewayClient`` — the SMART client (the repo's client-side-routing
  idiom, same shape as ``cluster.ClusterClient``): resolves the routing
  map once, routes point lookups straight to the owning shard over a
  persistent connection, scatters batch lookups / feature joins per
  shard, and re-resolves on connection errors, 421 NOT-OWNER answers,
  or 503 sheds.  It duck-types ``twin.TwinFeatureStore`` (``vector`` /
  ``matrix`` / ``dim``), so ``StreamScorer(feature_store=client)``
  joins per-car history through the gateway with no scorer changes.
* ``GatewayRouter`` — the DUMB-client front: mounts fleet-facing routes
  on an existing REST surface (the connect server, per the reference's
  "query the twin over the Connect API" shape) and does the scatter-
  gather server-side: ``GET /twin/{car}`` proxies to the owning shard,
  ``GET /twin`` and ``/gateway/aggregate`` fan out and merge,
  ``/gateway/map`` hands smart clients the map so they can stop paying
  the extra hop.

Key→owner is the same pure policy everywhere: the broker's keyed
partitioner (``crc32(key) % n_partitions`` — a cross-client invariant
of the produce path) composes with the cluster plane's
``partition % n_shards``.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

from ..core.normalize import CAR_NORMALIZER, Normalizer
from ..utils.rest import RestError, RestServer


def partition_for_key(key, n_partitions: int) -> int:
    """The broker's keyed-produce partitioner (stream.broker and the
    native RAW_PRODUCE front agree on it byte-for-byte): which source —
    and therefore changelog — partition a car's records land in."""
    if isinstance(key, str):
        key = key.encode()
    return zlib.crc32(key) % int(n_partitions)


def shard_for_key(key, n_partitions: int, n_shards: int) -> int:
    """Key → owning serving shard (composition of the two pure
    policies; every party computes the same answer coordination-free)."""
    return partition_for_key(key, n_partitions) % int(n_shards)


class GatewayError(Exception):
    """A gateway query failed after map refreshes and retries."""


class _ShardConn:
    """One persistent keep-alive connection to a shard's REST surface."""

    def __init__(self, url: str, timeout_s: float):
        host, _, port = url.partition("://")[2].partition(":")
        self.url = url
        self.conn = http.client.HTTPConnection(host, int(port),
                                               timeout=timeout_s)

    def request(self, method: str, path: str,
                body: Optional[dict] = None):
        """(status, parsed json) — raises OSError family on transport
        failure; the caller owns refresh/retry policy."""
        payload = None
        headers = {}
        if body is not None:
            payload = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        try:
            self.conn.request(method, path, body=payload, headers=headers)
            resp = self.conn.getresponse()
            raw = resp.read()
        except Exception:
            # a dead keep-alive socket must not poison the next attempt
            self.close()
            raise
        doc = json.loads(raw) if raw else {}
        return resp.status, doc

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:
            pass


class GatewayClient:
    """Smart sharded-twin client; see the module docstring.

    Args:
      source: where the routing map comes from — a ``GatewayCluster``
        (in-process: ``map_doc()`` is read directly) or a URL string
        whose ``/gateway/map`` endpoint serves it (the router's).
      normalizer: feature-vector normalizer — fixes ``dim`` without a
        round trip, so the scorer can build its model input layout
        before the first join.
      retry_deadline_s: how long a query keeps refreshing + retrying
        across a failover window before it errors.  Bounds the drill's
        query-storm latency tail; committed cars must never need more
        than a promotion takes.
    """

    def __init__(self, source, normalizer: Normalizer = CAR_NORMALIZER,
                 timeout_s: float = 5.0, retry_deadline_s: float = 10.0):
        self._source = source
        self.timeout_s = float(timeout_s)
        self.retry_deadline_s = float(retry_deadline_s)
        self.normalizer = normalizer
        self.dim = len(normalizer.scale) + 2
        self._lock = threading.Lock()
        self._conns: Dict[int, _ShardConn] = {}
        self._map: dict = {}
        self.refreshes = 0
        self.refresh()

    # ---------------------------------------------------------------- map
    def _fetch_map(self) -> dict:
        if isinstance(self._source, str):
            import urllib.request

            with urllib.request.urlopen(
                    f"{self._source}/gateway/map",
                    timeout=self.timeout_s) as resp:
                return json.loads(resp.read())
        return self._source.map_doc()

    def refresh(self) -> dict:
        doc = self._fetch_map()
        with self._lock:
            old = {s["shard"]: s["url"]  # lint-ok: R4 dict .get below, not the blocking GatewayClient.get
                   for s in self._map.get("shards", [])}
            self._map = doc
            for s in doc["shards"]:
                if old.get(s["shard"]) != s["url"]:  # lint-ok: R4 dict .get, not the blocking GatewayClient.get
                    stale = self._conns.pop(s["shard"], None)
                    if stale is not None:
                        stale.close()
            self.refreshes += 1
        return doc

    @property
    def n_shards(self) -> int:
        return self._map["n_shards"]

    @property
    def n_partitions(self) -> int:
        return self._map["n_partitions"]

    def shard_of(self, car: str) -> int:
        return shard_for_key(car, self._map["n_partitions"],
                             self._map["n_shards"])

    def _conn_for(self, shard: int) -> _ShardConn:
        with self._lock:
            conn = self._conns.get(shard)  # lint-ok: R4 dict .get, not the blocking GatewayClient.get
            url = next(s["url"] for s in self._map["shards"]
                       if s["shard"] == shard)
            if conn is None or conn.url != url:
                if conn is not None:
                    conn.close()
                conn = self._conns[shard] = _ShardConn(url, self.timeout_s)
        return conn

    # -------------------------------------------------------------- calls
    def _call(self, shard: int, method: str, path: str,
              body: Optional[dict] = None, expect=(200,)):
        """One shard call under the refresh-and-retry discipline: a
        transport error, a 421 (stale map: the shard no longer owns the
        key), or a 503 (shed) re-resolves the map and retries until the
        deadline.  404 and other codes are real answers, returned."""
        deadline = time.monotonic() + self.retry_deadline_s
        delay = 0.02
        while True:
            try:
                status, doc = self._conn_for(shard).request(
                    method, path, body)
            except (OSError, http.client.HTTPException):
                status, doc = None, None
            if status is not None and status not in (421, 503):
                return status, doc
            if time.monotonic() >= deadline:
                raise GatewayError(
                    f"shard {shard} {method} {path}: no live owner "
                    f"within {self.retry_deadline_s}s "
                    f"(last status {status})")
            time.sleep(delay)
            delay = min(delay * 2, 0.25)
            try:
                self.refresh()
            except Exception:
                pass  # map source itself failing over: keep retrying

    # ------------------------------------------------------------ queries
    def get(self, car: str) -> Optional[dict]:
        """Point lookup — routed by key hash to the owning shard.
        None = the fleet has never seen this car (404)."""
        status, doc = self._call(self.shard_of(car), "GET",
                                 f"/shard/twin/{car}")
        if status == 404:
            return None
        if status != 200:
            raise GatewayError(f"GET /twin/{car}: {status} {doc}")
        return doc

    def retire(self, car: str) -> bool:
        status, doc = self._call(self.shard_of(car), "DELETE",
                                 f"/shard/twin/{car}")
        if status == 404:
            return False
        if status != 204:
            raise GatewayError(f"DELETE /twin/{car}: {status} {doc}")
        return True

    def _scatter_keys(self, keys: List[str]) -> Dict[int, List[int]]:
        by_shard: Dict[int, List[int]] = {}
        for i, car in enumerate(keys):
            by_shard.setdefault(self.shard_of(car), []).append(i)
        return by_shard

    def mget(self, cars: List[str]) -> List[Optional[dict]]:
        """Batched point lookups: scatter per owning shard, one
        pipelined round trip each, gather in request order.  None =
        unknown car.  Keys a shard disowns mid-flight (rebalance racing
        the scatter) re-resolve and retry individually."""
        out: List[Optional[dict]] = [None] * len(cars)
        missed: List[int] = []
        for shard, idxs in self._scatter_keys(cars).items():
            status, doc = self._call(shard, "POST", "/shard/mget",
                                     {"keys": [cars[i] for i in idxs]})
            if status != 200:
                raise GatewayError(f"mget on shard {shard}: {status}")
            not_owned = set(doc.get("not_owned", []))
            for j, i in enumerate(idxs):
                if j in not_owned:
                    missed.append(i)
                else:
                    out[i] = doc["docs"][j]
        for i in missed:
            # the ownership policy is pure, so one refreshed map agrees
            # with the shard that disowned the key
            self.refresh()
            status, doc = self._call(self.shard_of(cars[i]), "POST",
                                     "/shard/mget", {"keys": [cars[i]]})
            if status != 200 or doc.get("not_owned"):
                raise GatewayError(
                    f"mget: no shard owns {cars[i]!r} after refresh")
            out[i] = doc["docs"][0]
        return out

    def count(self) -> int:
        return sum(s["count"] for s in self._fan("/shard/info"))

    def cars(self, limit: int = 1000, offset: int = 0,
             prefix: str = "") -> List[str]:
        """Fleet-wide id listing: fan out, merge-sort, slice.  Each
        shard is asked only for the window that could contribute."""
        per_shard = min(limit + offset, 10_000)
        merged: List[str] = []
        for doc in self._fan(f"/shard/cars?limit={per_shard}"
                             f"&prefix={prefix}"):
            merged.extend(doc["cars"])
        merged.sort()
        return merged[offset:offset + limit]

    def aggregate(self) -> dict:
        """Fleet-wide sums, merged from every shard's local fold."""
        cars = records = failures = 0
        for doc in self._fan("/shard/aggregate"):
            cars += doc["cars"]
            records += doc["records"]
            failures += doc["failures"]
        return {"cars": cars, "records": records, "failures": failures,
                "failure_rate": failures / records if records else 0.0}

    def _fan(self, path: str) -> List[dict]:
        out = []
        for shard in range(self.n_shards):
            status, doc = self._call(shard, "GET", path)
            if status != 200:
                raise GatewayError(f"fan-out {path} on shard {shard}: "
                                   f"{status}")
            out.append(doc)
        return out

    # -------------------------------------------- feature-store duck-type
    def vector(self, key) -> np.ndarray:
        """[dim] float32 — one car's historical features via its shard."""
        out = self.matrix([key], 1)
        return out[0]

    def matrix(self, keys, n: int) -> np.ndarray:
        """[n, dim] float32 feature rows for a batch's keys — the
        sharded ``TwinFeatureStore.matrix``: scatter per owning shard,
        gather rows into position.  None keys, padding rows, and
        unknown cars are zero (the cold-start null the scorer already
        understands)."""
        out = np.zeros((n, self.dim), np.float32)
        if keys is None:
            return out
        want: List[str] = []
        pos: List[int] = []
        for i, k in enumerate(list(keys)[:n]):
            if not k:
                continue
            want.append(k.decode() if isinstance(k, bytes) else str(k))
            pos.append(i)
        for shard, idxs in self._scatter_keys(want).items():
            status, doc = self._call(shard, "POST", "/shard/matrix",
                                     {"keys": [want[i] for i in idxs]})
            if status != 200:
                raise GatewayError(f"matrix on shard {shard}: {status}")
            for j, i in enumerate(idxs):
                row = doc["rows"][j]
                if row is not None:
                    out[pos[i]] = row
        return out

    def close(self) -> None:
        with self._lock:
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()


class GatewayRouter:
    """Mount the fleet-facing scatter-gather routes on a REST surface.

    ``mount(rest)`` registers on an existing server — by design the
    connect server, so the reference's "query the twin over the Connect
    API" URL shapes keep working when the twin behind them becomes a
    sharded fleet:

      GET /twin               paginated fleet listing (fan-out merge;
                              limit/offset/count_only as in the single-
                              twin surface)
      GET /twin/{car}         proxied point lookup
      DELETE /twin/{car}      proxied retire
      GET /gateway/map        the routing map (smart clients take over
                              from here and skip this extra hop)
      GET /gateway/aggregate  fleet-wide sums
      POST /gateway/mget      batched lookups for dumb clients
    """

    def __init__(self, cluster, client: Optional[GatewayClient] = None):
        self.cluster = cluster
        self.client = client if client is not None \
            else GatewayClient(cluster)

    def mount(self, rest: RestServer) -> "GatewayRouter":
        car = r"([^/]+)"
        rest.route("GET", r"/gateway/map", self._map)
        rest.route("GET", r"/gateway/aggregate", self._aggregate)
        rest.route("POST", r"/gateway/mget", self._mget)
        rest.route("GET", r"/twin", self._list)
        rest.route("GET", rf"/twin/{car}", self._get)
        rest.route("DELETE", rf"/twin/{car}", self._retire)
        return self

    # ------------------------------------------------------------- routes
    def _map(self, m, body):
        return 200, self.cluster.map_doc()

    def _aggregate(self, m, body):
        return 200, self.client.aggregate()

    def _mget(self, m, body):
        keys = body.get("keys")
        if not isinstance(keys, list):
            raise RestError(400, "mget body needs a 'keys' list")
        return 200, {"docs": self.client.mget([str(k) for k in keys])}

    def _list(self, m, body):
        count = self.client.count()
        out = {"count": count}
        if str(body.get("count_only", "")).lower() in ("1", "true", "yes"):
            return 200, out
        try:
            limit = int(body.get("limit", 1000))
            offset = int(body.get("offset", 0))
        except (TypeError, ValueError):
            raise RestError(400, "limit/offset must be integers")
        if limit < 0 or offset < 0:
            raise RestError(400, "limit/offset must be >= 0")
        page = self.client.cars(limit=limit, offset=offset,
                                prefix=str(body.get("prefix", "")))
        out["cars"] = page
        out["offset"] = offset
        out["limit"] = limit
        nxt = offset + len(page)
        out["next_offset"] = nxt if nxt < count else None
        return 200, out

    def _get(self, m, body):
        doc = self.client.get(m.group(1))
        if doc is None:
            raise RestError(404, f"no twin for car {m.group(1)!r}")
        return 200, doc

    def _retire(self, m, body):
        if not self.client.retire(m.group(1)):
            raise RestError(404, f"no twin for car {m.group(1)!r}")
        return 204, {}
