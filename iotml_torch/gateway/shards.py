"""Sharded twin serving plane: primaries + warm standby replicas
(``iotml.gateway.shards``'s copy).

The digital twin is already partition-sharded at the STORAGE layer: car
keys hash to source partitions, the ``CAR_TWIN`` changelog mirrors the
source partitioning 1:1, and ``TwinService(partitions=...)`` materialises
any partition subset with no cross-talk.  This module turns that latent
shardability into a SERVING plane::

    SENSOR_DATA_S_AVRO (P partitions)
      ├─ shard 0: TwinService(partitions=[p: p%N==0]) → REST :port0
      ├─ shard 1: TwinService(partitions=[p: p%N==1]) → REST :port1
      └─ ...                        │ changelog (same partition numbers)
                                    ▼
    CAR_TWIN (compacted) ──────► TwinStandby per shard: a warm shadow
                                 table rebuilt CONTINUOUSLY from the
                                 changelog (Kafka Streams standby-
                                 replica pattern)

Shard ownership is the cluster plane's pure policy
(``PartitionMap.shard_for``: ``partition % n_shards``), so routers,
clients, and shards all compute the same owner with no coordination.
Leadership lives in the same ``PartitionMap``/``Topology`` cells the
broker cluster uses: a shard kill promotes its standby — the warm table
is ADOPTED by a fresh ``TwinService`` (``table=``/``rebuild_from=``
replay only the changelog delta), a new REST surface mounts, and the
map publishes ``(new_url, epoch+1)``.  Promotion moves one shard, not
the world.

Everything here is drilled live (``python -m iotml_torch.gateway drill``):
standby-equals-primary byte equality, promotion inside the SLO under a
query storm, zero wrong answers for committed cars.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..cluster.partition_map import PartitionMap
from ..core.schema import KSQL_CAR_SCHEMA, RecordSchema
from ..obs.metrics import default_registry
from ..stream.broker import OffsetOutOfRangeError
from ..twin.features import TwinFeatureStore
from ..twin.service import CHANGELOG_TOPIC, TwinDriver, TwinService
from ..twin.state import DEFAULT_WINDOW, TwinTable
from ..utils.rest import RestError, RestServer
from .router import partition_for_key

gateway_promotions = default_registry.counter(
    "iotml_gateway_promotions_total",
    "standby-to-primary promotions, by shard")
gateway_standby_lag = default_registry.gauge(
    "iotml_gateway_standby_lag_records",
    "changelog records a shard's warm standby has not yet applied")


class TwinStandby:
    """Warm shadow TwinTable for one shard's changelog partitions.

    Follows ``CAR_TWIN`` continuously (``catch_up()`` on a driver
    thread), tracking per-partition replay positions.  On promotion the
    table and positions hand over to ``TwinService(table=...,
    rebuild_from=...)`` so only the in-flight delta replays — the
    standby IS the rebuild, paid incrementally while the primary was
    healthy."""

    def __init__(self, broker, partitions, window: int = DEFAULT_WINDOW,
                 changelog_topic: str = CHANGELOG_TOPIC):
        self.broker = broker
        self.changelog_topic = changelog_topic
        self.partitions = sorted(int(p) for p in partitions)
        self.table = TwinTable(window=window)
        #: next changelog offset to apply, per partition
        self.positions: Dict[int, int] = {p: 0 for p in self.partitions}
        self.applied = 0

    def catch_up(self, max_records: int = 65536) -> int:
        """Apply new changelog records into the warm table; returns how
        many were applied this pass."""
        applied = 0
        for p in self.partitions:
            off = self.positions[p]
            try:
                end = self.broker.end_offset(self.changelog_topic, p)
            except KeyError:
                continue
            while off < end and applied < max_records:
                try:
                    batch = self.broker.fetch(self.changelog_topic, p, off,
                                              4096)
                except OffsetOutOfRangeError as e:
                    off = e.earliest
                    continue
                if not batch:
                    # compaction holes between segments end a batch
                    # early; past the last record the log is drained
                    break
                for m in batch:
                    if m.key is not None:
                        self.table.apply_changelog(m.key.decode(), m.value)
                        applied += 1
                off = batch[-1].offset + 1
            self.positions[p] = off
        self.applied += applied
        return applied

    def lag(self) -> int:
        """Changelog records not yet applied (promotion catch-up cost)."""
        total = 0
        for p in self.partitions:
            try:
                total += max(0, self.broker.end_offset(self.changelog_topic,
                                                       p)
                             - self.positions[p])
            except KeyError:
                continue
        return total


class StandbyDriver:
    """Background catch-up pump for one TwinStandby (its thread daemon,
    named and registered)."""

    def __init__(self, standby: TwinStandby, shard: int,
                 poll_interval_s: float = 0.05):
        self.standby = standby
        self.shard = shard
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StandbyDriver":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._run, daemon=True,
            name=f"iotml-gw-standby-{self.shard}"))
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            n = self.standby.catch_up()
            gateway_standby_lag.set(self.standby.lag(),
                                    shard=str(self.shard))
            if n == 0:
                self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class GatewayShard:
    """One serving shard: a primary TwinService over its owned
    partitions + the shard-local REST surface the router and smart
    clients scatter to.

    Shard-local routes (all under ``/shard``; the fleet-facing surface
    is the router's):

      GET  /shard/info            → shard id, owned partitions, count
      GET  /shard/twin/{car}      → full twin doc (421 when not owned —
                                    the client's refresh-and-retry cue)
      POST /shard/mget            {"keys": [...]} → slim docs per key
      POST /shard/matrix          {"keys": [...]} → feature rows [k,dim]
      GET  /shard/cars            paginated local ids
      GET  /shard/aggregate       local fleet sums for fan-out merges
      DELETE /shard/twin/{car}    retire through the owning primary
    """

    def __init__(self, broker, shard_id: int, n_shards: int,
                 source_topic: str = "SENSOR_DATA_S_AVRO",
                 schema: RecordSchema = KSQL_CAR_SCHEMA,
                 window: int = DEFAULT_WINDOW,
                 group_prefix: str = "iotml-gw",
                 host: str = "127.0.0.1",
                 table: Optional[TwinTable] = None,
                 rebuild_from: Optional[Dict[int, int]] = None,
                 poll_interval_s: float = 0.02):
        self.shard_id = int(shard_id)
        self.n_shards = int(n_shards)
        self.broker = broker
        n_parts = broker.topic(source_topic).partitions
        self.n_partitions = n_parts
        self.owned = [p for p in range(n_parts)
                      if p % n_shards == self.shard_id]
        self._owned_set = frozenset(self.owned)
        self.service = TwinService(
            broker, source_topic=source_topic, partitions=self.owned,
            group=f"{group_prefix}-{self.shard_id}", schema=schema,
            window=window, table=table, rebuild_from=rebuild_from)
        self.features = TwinFeatureStore(self.service)
        self.driver = TwinDriver(self.service,
                                 poll_interval_s=poll_interval_s)
        self.rest = RestServer(host=host,
                               name=f"iotml-gw-shard{self.shard_id}")
        car = r"([^/]+)"
        self.rest.route("GET", r"/shard/info", self._info)
        self.rest.route("GET", rf"/shard/twin/{car}", self._get)
        self.rest.route("DELETE", rf"/shard/twin/{car}", self._retire)
        self.rest.route("POST", r"/shard/mget", self._mget)
        self.rest.route("POST", r"/shard/matrix", self._matrix)
        self.rest.route("GET", r"/shard/cars", self._cars)
        self.rest.route("GET", r"/shard/aggregate", self._aggregate)
        self.alive = False

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "GatewayShard":
        self.rest.start()
        self.driver.start()
        self.alive = True
        return self

    def stop(self) -> None:
        self.alive = False
        self.driver.stop()
        self.rest.kill()

    def kill(self) -> None:
        """Crash-shaped death for drills: the REST surface drops (every
        established keep-alive connection severed — a zombie answering
        stale state on old sockets is a WRONG answer) and the pump
        stops — nothing is flushed, nothing says goodbye.  The only
        durable trace of this shard's work is the changelog (exactly
        the guarantee the standby rebuilds from)."""
        self.alive = False
        self.rest.kill()
        self.driver.stop()

    @property
    def url(self) -> str:
        return self.rest.url

    # -------------------------------------------------------------- owner
    def _owns(self, car: str) -> bool:
        return partition_for_key(car, self.n_partitions) in self._owned_set

    def _require_owner(self, car: str) -> None:
        if not self._owns(car):
            # 421 Misdirected Request: the caller's map is stale — its
            # cue to refresh /gateway/map and re-route, never an answer
            raise RestError(421, f"shard {self.shard_id} does not own "
                            f"{car!r}")

    # -------------------------------------------------------------- routes
    def _info(self, m, body):
        return 200, {"shard": self.shard_id, "n_shards": self.n_shards,
                     "partitions": self.owned,
                     "count": self.service.count(),
                     "rebuilt_from_changelog": self.service.rebuilt_records}

    def _get(self, m, body):
        car = m.group(1)
        self._require_owner(car)
        doc = self.service.get(car)
        if doc is None:
            raise RestError(404, f"no twin for car {car!r}")
        return 200, doc

    def _retire(self, m, body):
        car = m.group(1)
        self._require_owner(car)
        if not self.service.retire(car):
            raise RestError(404, f"no twin for car {car!r}")
        return 204, {}

    def _slim(self, car: str) -> Optional[dict]:
        twin = self.service.table.get(car)
        if twin is None:
            return None
        return {"car": twin.car, "partition": twin.partition,
                "offset": twin.offset, "ts": twin.ts,
                "count": twin.count, "failures": twin.failures}

    def _mget(self, m, body):
        """Pipelined point lookups: one round trip answers a key batch.
        Slim docs (identity + provenance + lifetime counts) keep the
        reply ~60B/key so the wire cost stays linear in keys, not in
        window depth; ``not_owned`` indexes are the scatter client's
        refresh-and-retry cue for exactly those keys."""
        keys = body.get("keys")
        if not isinstance(keys, list):
            raise RestError(400, "mget body needs a 'keys' list")
        docs: List[Optional[dict]] = []
        not_owned: List[int] = []
        for i, car in enumerate(keys):
            car = str(car)
            if not self._owns(car):
                docs.append(None)
                not_owned.append(i)
                continue
            docs.append(self._slim(car))
        return 200, {"shard": self.shard_id, "docs": docs,
                     "not_owned": not_owned}

    def _matrix(self, m, body):
        """Feature-vector scatter leg: rows for the keys this shard
        owns, in request order — the server half of the sharded
        ``TwinFeatureStore.matrix`` join `StreamScorer(feature_store=)`
        rides."""
        keys = body.get("keys")
        if not isinstance(keys, list):
            raise RestError(400, "matrix body needs a 'keys' list")
        rows: List[Optional[list]] = []
        not_owned: List[int] = []
        for i, car in enumerate(keys):
            car = str(car)
            if not self._owns(car):
                rows.append(None)
                not_owned.append(i)
                continue
            rows.append([float(v) for v in self.features.vector(car.encode())])
        return 200, {"shard": self.shard_id, "dim": self.features.dim,
                     "rows": rows, "not_owned": not_owned}

    def _cars(self, m, body):
        try:
            limit = int(body.get("limit", 1000))
            offset = int(body.get("offset", 0))
        except (TypeError, ValueError):
            raise RestError(400, "limit/offset must be integers")
        prefix = str(body.get("prefix", ""))
        cars = self.service.cars(prefix=prefix)
        return 200, {"shard": self.shard_id, "count": len(cars),
                     "cars": cars[offset:offset + limit]}

    def _aggregate(self, m, body):
        """Local sums for the router's fleet-wide merge."""
        records = 0
        failures = 0
        for twin in self.service.table.twins.values():
            records += twin.count
            failures += twin.failures
        return 200, {"shard": self.shard_id,
                     "cars": self.service.count(),
                     "records": records, "failures": failures}


class GatewayCluster:
    """N serving shards + their standbys + the leadership map.

    The in-process cluster-of-record for drills, benches and the
    platform CLI: shards serve over real HTTP (each on its own
    ephemeral port), the ``PartitionMap`` holds shard URLs in its
    ``Topology`` cells, and ``promote()`` is the standby-replica
    failover the gateway drill kills shards to exercise."""

    #: drill SLO: a killed shard's standby must be promoted and serving
    #: within this budget (catch-up + service adoption + REST mount)
    PROMOTE_SLO_S = 5.0

    def __init__(self, broker, n_shards: int = 2,
                 source_topic: str = "SENSOR_DATA_S_AVRO",
                 schema: RecordSchema = KSQL_CAR_SCHEMA,
                 window: int = DEFAULT_WINDOW,
                 standbys: bool = True,
                 host: str = "127.0.0.1"):
        if n_shards < 1:
            raise ValueError("a gateway needs at least one shard")
        self.broker = broker
        self.source_topic = source_topic
        self.schema = schema
        self.window = window
        self.host = host
        self.n_shards = int(n_shards)
        self.shards: List[GatewayShard] = [
            GatewayShard(broker, i, n_shards, source_topic=source_topic,
                         schema=schema, window=window, host=host)
            for i in range(n_shards)]
        self.n_partitions = self.shards[0].n_partitions
        self.pmap = PartitionMap([s.url for s in self.shards])
        self.pmap.register_topic(CHANGELOG_TOPIC, self.n_partitions)
        self.pmap.register_topic(source_topic, self.n_partitions)
        self.standbys: Dict[int, TwinStandby] = {}
        self.standby_drivers: Dict[int, StandbyDriver] = {}
        if standbys:
            for s in self.shards:
                self.standbys[s.shard_id] = TwinStandby(
                    broker, s.owned, window=window)
                self.standby_drivers[s.shard_id] = StandbyDriver(
                    self.standbys[s.shard_id], s.shard_id)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "GatewayCluster":
        for s in self.shards:
            s.start()
        for d in self.standby_drivers.values():
            d.start()
        return self

    def stop(self) -> None:
        for d in self.standby_drivers.values():
            d.stop()
        for s in self.shards:
            if s.alive:
                s.stop()

    # ------------------------------------------------------------- facade
    def shard_for_key(self, car: str) -> int:
        return self.pmap.shard_for(self.source_topic,
                                   partition_for_key(car, self.n_partitions))

    def map_doc(self) -> dict:
        """The routing map clients resolve (also served as
        ``GET /gateway/map`` by the router): shard → live URL + fencing
        epoch, plus the pure policy inputs (topic partition count and
        shard count) every party derives ownership from."""
        return {
            "topic": self.source_topic,
            "n_partitions": self.n_partitions,
            "n_shards": self.n_shards,
            "generation": self.pmap.generation,
            "shards": [{"shard": i, "url": self.pmap.leader(i),
                        "epoch": self.pmap.epoch(i)}
                       for i in range(self.n_shards)],
        }

    def counts(self) -> List[int]:
        return [s.service.count() for s in self.shards]

    # ------------------------------------------------------------ failover
    def kill_shard(self, shard: int) -> GatewayShard:
        """Crash a primary (drill hook); returns the corpse for
        post-mortem snapshots."""
        corpse = self.shards[shard]
        corpse.kill()
        return corpse

    def promote(self, shard: int) -> float:
        """Standby-replica failover: drain the standby's changelog
        delta, adopt its warm table into a fresh primary, mount a new
        REST surface, publish the new (url, epoch).  Returns seconds
        from call to published — the drill's ``promote_s`` SLO.

        The new primary's delta replay (``rebuild_from``) starts at the
        standby's positions, so promotion cost is proportional to the
        standby's LAG, not to the table size — the whole point of
        paying the rebuild continuously."""
        t0 = time.perf_counter()
        standby = self.standbys.get(shard)
        if standby is None:
            raise ValueError(f"shard {shard} has no standby to promote")
        driver = self.standby_drivers.pop(shard, None)
        if driver is not None:
            driver.stop()
        standby.catch_up()  # drain the tail the driver hadn't reached
        replacement = GatewayShard(
            self.broker, shard, self.n_shards,
            source_topic=self.source_topic, schema=self.schema,
            window=self.window, host=self.host,
            table=standby.table, rebuild_from=dict(standby.positions))
        replacement.start()
        self.shards[shard] = replacement
        # a FRESH standby shadows the promoted primary: the next kill
        # must find the same warm-follower protection in place
        self.standbys[shard] = TwinStandby(self.broker, replacement.owned,
                                           window=self.window)
        self.standby_drivers[shard] = StandbyDriver(
            self.standbys[shard], shard).start()
        self.pmap.publish(shard, replacement.url,
                          self.pmap.epoch(shard) + 1)
        gateway_promotions.inc(shard=str(shard))
        return time.perf_counter() - t0
