"""Live gateway failover drill — kill a serving shard under a query
storm, promote its warm standby, prove nobody got a wrong answer
(``iotml.gateway.drill``'s copy, with one repair named below).

The drill drives the real serving plane end to end: a durable broker
(small segments so the changelog rolls and compacts mid-drill), a
seeded fleet publishing framed-Avro sensor records CONTINUOUSLY, a
``GatewayCluster`` of twin shards with warm standbys, and a
``GatewayClient`` query storm mixing point lookups and pipelined
batches.  Mid-storm one primary is KILLED (REST surface drops, pump
stops, nothing flushed) and its standby is promoted:

- ``standby_byte_identical``: quiesced, each shard's warm standby table
  is BYTE-identical to its primary's — across a compaction pass, so
  the standby demonstrably follows the *compacted* changelog;
- ``promote_within_slo``: kill → new primary published within
  ``GatewayCluster.PROMOTE_SLO_S``;
- ``zero_wrong_answers``: every storm query for a committed car
  answered correctly (right car, count never below the pre-storm
  baseline) — across the failover, with zero gateway errors;
- ``bounded_staleness``: records published AFTER the failover are
  served by the promoted primary within ``STALENESS_SLO_S``;
- ``fanout_agrees``: ``GET /twin`` through the mounted router (fan-out
  merge) agrees with per-shard truth on count and page contents;
- ``scorer_join_matches``: ``GatewayClient.matrix`` (the sharded
  feature join ``StreamScorer(feature_store=)`` rides) equals a local
  ``TwinFeatureStore`` over the same changelog, elementwise.

One ordering differs from the JAX package's drill.  Its barriers
wait for the shards' tables to hold every published record, but a
shard folds into its table before it produces that pass's changelog
records, so a barrier can pass between the two.  Three steps then go
wrong: the changelog roll after the warm-up races a shard's changelog
append (the roll bypasses the broker, and a shard's pump thread that
dies in it leaves the drill waiting out its timeout), and
``standby_byte_identical`` and ``scorer_join_matches`` compare the
tables with a changelog still missing their last folds.  Here each of
those barriers also waits until every primary's committed source
offsets reach the source's end (``sources_committed``): a shard commits
after its changelog records land, so then the changelog holds every
fold and no append is in flight.

Exit status = verdict (``python -m iotml_torch.gateway drill``).
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional

from ..chaos.runner import Invariant

IN_TOPIC = "SENSOR_DATA_S_AVRO"
PARTITIONS = 4

#: records produced after a failover must be queryable within this
STALENESS_SLO_S = 5.0


@dataclasses.dataclass
class GatewayDrillReport:
    seed: int
    records: int
    cars: int
    n_shards: int
    published: int
    killed_shard: int
    storm_queries: int
    storm_wrong: int
    storm_errors: int
    storm_p99_ms: float
    promote_catchup_records: int
    slos: Dict[str, float]
    invariants: List[Invariant]

    @property
    def ok(self) -> bool:
        return all(i.ok for i in self.invariants)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def run_gateway_drill(seed: int = 11, records: int = 2000,
                      cars: int = 40, n_shards: int = 2,
                      partitions: int = PARTITIONS) -> GatewayDrillReport:
    store_dir = tempfile.mkdtemp(prefix="iotml_gw_drill_")
    try:
        return _run(seed, records, cars, n_shards, partitions, store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _await(cond, timeout_s: float = 20.0, interval_s: float = 0.02,
           what: str = "condition") -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"drill: {what} not reached "
                               f"in {timeout_s}s")
        time.sleep(interval_s)


def sources_committed(cluster) -> bool:
    """Whether every primary has committed its source partitions to
    their end offsets.  ``TwinService.pump_once`` produces a pass's
    changelog records before it commits the pass, so once this holds the
    changelog carries every fold in the primaries' tables."""
    broker = cluster.broker
    for s in cluster.shards:
        svc = s.service
        for p in svc.partitions:
            committed = broker.committed(svc.group, svc.source_topic, p)
            if (committed or 0) < broker.end_offset(svc.source_topic, p):
                return False
    return True


class _Storm:
    """Closed-loop query storm on its own thread: point lookups by key
    hash plus periodic pipelined ``mget`` sweeps, each answer verified
    against the committed baseline (identity + count monotonicity)."""

    def __init__(self, client, baseline: Dict[str, int]):
        self.client = client
        self.baseline = baseline
        self.cars = sorted(baseline)
        self.queries = 0
        self.wrong = 0
        self.errors = 0
        self.point_lat: List[float] = []
        self.wrong_detail: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _check(self, car: str, doc: Optional[dict]) -> None:
        ok = (doc is not None and doc.get("car") == car
              and doc.get("count", doc.get("aggregates", {})
                          .get("count", 0)) >= self.baseline[car])
        if not ok:
            self.wrong += 1
            if self.wrong_detail is None:
                self.wrong_detail = f"{car!r} -> {doc!r}"

    def _run(self) -> None:
        from .router import GatewayError

        i = 0
        while not self._stop.is_set():
            try:
                if i % 8 == 7:
                    docs = self.client.mget(self.cars)
                    self.queries += len(self.cars)
                    for car, doc in zip(self.cars, docs):
                        self._check(car, doc)
                else:
                    car = self.cars[(i * 7) % len(self.cars)]
                    t0 = time.perf_counter()
                    doc = self.client.get(car)
                    self.point_lat.append(time.perf_counter() - t0)
                    self.queries += 1
                    # full twin doc: identity only (count lives in the
                    # slim mget doc; the full doc carries aggregates)
                    if doc is None or doc.get("car") != car:
                        self.wrong += 1
                        if self.wrong_detail is None:
                            self.wrong_detail = f"{car!r} -> {doc!r}"
            except GatewayError as e:
                # a committed car MUST stay answerable across failover;
                # an exhausted retry deadline is a drill failure
                self.errors += 1
                if self.wrong_detail is None:
                    self.wrong_detail = f"GatewayError: {e}"
            i += 1

    def start(self) -> "_Storm":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._run, daemon=True, name="iotml-gw-storm"))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def p99_ms(self) -> float:
        if not self.point_lat:
            return 0.0
        lat = sorted(self.point_lat)
        return lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1000


def _run(seed: int, records: int, cars: int, n_shards: int,
         partitions: int, store_dir: str) -> GatewayDrillReport:
    import json as _json
    import urllib.request

    import numpy as np

    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..store import StorePolicy
    from ..stream.broker import Broker
    from ..twin.features import TwinFeatureStore
    from ..twin.service import CHANGELOG_TOPIC, TwinService
    from ..utils.rest import RestServer
    from .router import GatewayClient, GatewayRouter
    from .shards import GatewayCluster

    broker = Broker(store_dir=store_dir,
                    store_policy=StorePolicy(fsync="interval",
                                             segment_bytes=8 * 1024,
                                             compact_grace_ms=10**9))
    broker.create_topic(IN_TOPIC, partitions=partitions)
    gen = FleetGenerator(FleetScenario(num_cars=cars, seed=seed,
                                       failure_rate=0.05))
    ticks = max(4, records // cars)
    warm_ticks = ticks // 2

    cluster = GatewayCluster(broker, n_shards=n_shards,
                             source_topic=IN_TOPIC).start()
    client = GatewayClient(cluster)
    try:
        # ---- phase 1: warm the fleet, drain shards and standbys
        published = 0
        for _ in range(warm_ticks):
            published += gen.publish(broker, IN_TOPIC, n_ticks=1,
                                     partitions=partitions)
        _await(lambda: client.aggregate()["records"] >= published,
               what="shards drained after warm-up")
        # no changelog append may be in flight when the drill rolls the
        # changelog's segments itself (the roll bypasses the broker)
        _await(lambda: sources_committed(cluster),
               what="primaries committed to the source end")
        # compact the changelog mid-drill so the standby equality below
        # proves the shadow follows the COMPACTED log, not a convenient
        # full history
        for p in range(partitions):
            broker.store.log_for(CHANGELOG_TOPIC, p).roll()
        broker.run_compaction(force=True)
        for _ in range(warm_ticks // 2):
            published += gen.publish(broker, IN_TOPIC, n_ticks=1,
                                     partitions=partitions)
        _await(lambda: client.aggregate()["records"] >= published,
               what="shards drained after compaction pass")
        # the tables hold every record; the changelog holds their folds
        # only once each primary has committed to the source's end
        # (changelog-before-commit), so the standbys' lag means something
        _await(lambda: sources_committed(cluster),
               what="primaries committed to the source end")
        _await(lambda: all(s.lag() == 0
                           for s in cluster.standbys.values()),
               what="standbys caught up")

        standby_identical = all(
            cluster.standbys[s.shard_id].table.snapshot()
            == s.service.table.snapshot()
            for s in cluster.shards)

        # committed baseline every storm answer is checked against
        baseline = {doc["car"]: doc["count"]
                    for doc in client.mget(sorted(client.cars(
                        limit=cars))) if doc is not None}

        # ---- phase 2: query storm + live ingest + shard kill
        storm = _Storm(GatewayClient(cluster), baseline).start()
        pub_stop = threading.Event()
        pub_done = threading.Event()
        pub_counts = {"published": 0}

        def _publish_loop():
            for _ in range(ticks - warm_ticks - warm_ticks // 2):
                if pub_stop.is_set():
                    break
                pub_counts["published"] += gen.publish(
                    broker, IN_TOPIC, n_ticks=1, partitions=partitions)
                time.sleep(0.01)
            pub_done.set()

        from ..supervise.registry import register_thread

        register_thread(threading.Thread(
            target=_publish_loop, daemon=True,
            name="iotml-gw-drill-pub")).start()

        _await(lambda: storm.queries >= 50, what="storm warmed up")
        killed_shard = 0
        cluster.kill_shard(killed_shard)
        time.sleep(0.1)  # let the storm hit the dead shard for real
        promote_s = cluster.promote(killed_shard)
        catchup = cluster.shards[killed_shard].service.rebuilt_records

        _await(pub_done.is_set, what="ingest finished")
        published += pub_counts["published"]
        # ---- bounded staleness: post-failover records become servable
        t0 = time.perf_counter()
        published += gen.publish(broker, IN_TOPIC, n_ticks=1,
                                 partitions=partitions)
        _await(lambda: client.aggregate()["records"] >= published,
               timeout_s=STALENESS_SLO_S + 5,
               what="post-failover records served")
        staleness_s = time.perf_counter() - t0
        _await(lambda: storm.queries >= 200, what="storm sampled enough")
        storm.stop()

        # ---- fan-out agreement through the mounted router
        rest = RestServer(name="iotml-gw-router")
        GatewayRouter(cluster, client=client).mount(rest)
        rest.start()
        try:
            with urllib.request.urlopen(
                    f"{rest.url}/twin?count_only=1", timeout=5) as resp:
                count_doc = _json.loads(resp.read())
            with urllib.request.urlopen(
                    f"{rest.url}/twin?limit={cars}", timeout=5) as resp:
                page_doc = _json.loads(resp.read())
        finally:
            rest.stop()
        all_cars = sorted(c for s in cluster.shards
                          for c in s.service.cars())
        fanout_ok = (count_doc.get("count") == len(all_cars) == cars
                     and page_doc.get("cars") == all_cars
                     and page_doc.get("next_offset") is None)

        # ---- sharded feature join vs a local reference store, rebuilt
        # from the changelog: it must hold every fold the shards serve
        _await(lambda: sources_committed(cluster),
               what="primaries committed to the source end")
        ref = TwinService(broker, source_topic=IN_TOPIC,
                          group="iotml-gw-drill-ref", changelog=False)
        keys = [c.encode() for c in all_cars[:16]]
        local = TwinFeatureStore(ref).matrix(keys, len(keys))
        remote = client.matrix(keys, len(keys))
        join_ok = bool(np.allclose(local, remote, atol=1e-6))
    finally:
        client.close()
        cluster.stop()
        broker.close()

    invariants = [
        Invariant(
            "standby_byte_identical",
            standby_identical,
            "every shard's warm standby table byte-identical to its "
            "primary across a compaction pass" if standby_identical else
            "standby table DIVERGED from its primary"),
        Invariant(
            "promote_within_slo",
            promote_s <= cluster.PROMOTE_SLO_S,
            f"kill -> promoted primary published in {promote_s * 1000:.0f}ms "
            f"(SLO {cluster.PROMOTE_SLO_S:.0f}s); delta replay "
            f"{catchup} records"),
        Invariant(
            "zero_wrong_answers",
            storm.wrong == 0 and storm.errors == 0 and storm.queries > 0,
            f"{storm.queries} storm queries across the failover, all "
            f"answered correctly" if storm.wrong == 0 and storm.errors == 0
            else f"{storm.wrong} wrong, {storm.errors} errors over "
                 f"{storm.queries} queries; first: {storm.wrong_detail}"),
        Invariant(
            "bounded_staleness",
            staleness_s <= STALENESS_SLO_S,
            f"post-failover records served in {staleness_s * 1000:.0f}ms "
            f"(SLO {STALENESS_SLO_S:.0f}s)"),
        Invariant(
            "fanout_agrees",
            fanout_ok,
            f"router GET /twin fan-out merge agrees with per-shard truth "
            f"({cars} cars)" if fanout_ok else
            f"fan-out DISAGREES: count={count_doc}, page={page_doc}"),
        Invariant(
            "scorer_join_matches",
            join_ok,
            f"GatewayClient.matrix == local TwinFeatureStore over "
            f"{len(keys)} keys" if join_ok else
            "sharded feature join diverged from the local store"),
    ]
    return GatewayDrillReport(
        seed=seed, records=records, cars=cars, n_shards=n_shards,
        published=published, killed_shard=killed_shard,
        storm_queries=storm.queries, storm_wrong=storm.wrong,
        storm_errors=storm.errors, storm_p99_ms=round(storm.p99_ms(), 3),
        promote_catchup_records=catchup,
        slos={"promote_s": round(promote_s, 4),
              "promote_slo_s": cluster.PROMOTE_SLO_S,
              "staleness_s": round(staleness_s, 4),
              "staleness_slo_s": STALENESS_SLO_S},
        invariants=invariants)
