"""Live twin-rebuild drill — kill the twin service, rebuild from the
compacted changelog, prove state equality (``iotml.twin.drill``'s copy).

The drill drives the real stack: a durable broker (small segments so
the changelog actually rolls), a seeded fleet publishing framed-Avro
sensor records, and a TwinService changelogging into the compacted
``CAR_TWIN`` topic.  Mid-stream the service is KILLED (the object is
abandoned — no flush; its table dies with it), the broker compacts the
changelog (so the rebuild reads the *compacted* form), and a second
incarnation rebuilds:

- ``rebuild_equals_snapshot``: the rebuilt table is BYTE-identical to
  the dead service's last materialised state;
- ``resume_no_refold``: the restarted service finishes the stream with
  every record folded exactly once (per-car counts sum to published);
- ``compaction_reclaimed``: the changelog rebuild read ~one record per
  car, not one per update — compaction did real work;
- ``retired_stay_retired``: a car tombstoned before the kill does not
  resurrect through the rebuild;
- ``rest_serves_twin``: ``GET /twin/<car_id>`` over a live connect
  server answers the latest state + rolling aggregates for a rebuilt
  car.

The twin is host code: the drill launches no kernel.  Exit status =
verdict (``python -m iotml_torch.twin drill``).
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import tempfile
from typing import List

from ..chaos.runner import Invariant

CARS = 10
IN_TOPIC = "SENSOR_DATA_S_AVRO"


@dataclasses.dataclass
class TwinDrillReport:
    seed: int
    records: int
    published: int
    cars: int
    rebuilt_records: int
    compaction_removed: int
    invariants: List[Invariant]

    @property
    def ok(self) -> bool:
        return all(i.ok for i in self.invariants)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def run_twin_rebuild_drill(seed: int = 7,
                           records: int = 1000) -> TwinDrillReport:
    store_dir = tempfile.mkdtemp(prefix="iotml_twin_drill_")
    try:
        return _run(seed, records, store_dir)
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def _run(seed: int, records: int, store_dir: str) -> TwinDrillReport:
    import urllib.request

    from ..connect import ConnectServer, ConnectWorker
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..store import StorePolicy
    from ..stream.broker import Broker
    from ..twin import TwinService

    broker = Broker(store_dir=store_dir,
                    store_policy=StorePolicy(fsync="interval",
                                             segment_bytes=8 * 1024,
                                             compact_grace_ms=10**9))
    broker.create_topic(IN_TOPIC, partitions=2)
    gen = FleetGenerator(FleetScenario(num_cars=CARS, seed=seed,
                                       failure_rate=0.05))
    ticks = max(2, records // CARS)
    kill_tick = ticks // 2

    svc = TwinService(broker)
    published = 0
    for _ in range(kill_tick):
        published += gen.publish(broker, IN_TOPIC, n_ticks=1, partitions=2)
        svc.pump_once()
    while svc.pump_once():
        pass
    retired_car = svc.cars()[-1]
    svc.retire(retired_car)
    snapshot = svc.table.snapshot()
    updates_before_kill = svc.emitted
    # --- the kill: the service object is abandoned mid-run.  Nothing is
    # flushed; the only durable trace of its work is the changelog.
    del svc

    # the changelog compacts between incarnations (roll the active
    # segments so there is something sealed to clean)
    for p in range(2):
        broker.store.log_for("CAR_TWIN", p).roll()
    stats = broker.run_compaction(force=True)
    removed = sum(s.records_removed for s in stats.values())

    svc2 = TwinService(broker)
    rebuilt_snapshot = svc2.table.snapshot()
    rebuilt_records = svc2.rebuilt_records

    for _ in range(ticks - kill_tick):
        published += gen.publish(broker, IN_TOPIC, n_ticks=1, partitions=2)
        svc2.pump_once()
    while svc2.pump_once():
        pass

    # --- REST over the live connect server
    rest_doc = None
    srv = ConnectServer(ConnectWorker(broker)).start()
    try:
        srv.attach_twin(svc2)
        car = svc2.cars()[0]
        with urllib.request.urlopen(f"{srv.url}/twin/{car}",
                                    timeout=5) as resp:
            rest_doc = json.loads(resp.read())
    finally:
        srv.stop()
    broker.close()

    rest_ok = (rest_doc is not None and rest_doc.get("latest")
               and rest_doc.get("aggregates", {}).get("window_len", 0) > 0)
    # exactly-once accounting: every car sees one record per tick, so a
    # surviving car's fold count must equal the tick count exactly (a
    # redelivery double-fold or a skipped batch both break equality).
    # The retired car restarts from zero at the first post-kill tick —
    # its pre-kill history died with the tombstone, by design.
    per_car = {car: json.loads(v)["count"]
               for car, v in svc2.table.snapshot().items()}
    expected = {car: ticks for car in per_car}
    expected[retired_car] = ticks - kill_tick
    refold_ok = per_car == expected

    invariants = [
        Invariant(
            "rebuild_equals_snapshot",
            rebuilt_snapshot == snapshot,
            f"rebuilt table byte-identical to the killed service's "
            f"state ({len(snapshot)} cars)" if rebuilt_snapshot == snapshot
            else "rebuilt table DIVERGED from the pre-kill snapshot"),
        Invariant(
            "resume_no_refold",
            refold_ok,
            f"per-car fold counts exact after restart "
            f"({sum(per_car.values())} records over {len(per_car)} cars)"
            if refold_ok else
            f"fold counts diverged: {per_car} != {expected}"),
        Invariant(
            "compaction_reclaimed",
            removed > 0 and rebuilt_records <= updates_before_kill,
            f"compaction removed {removed} shadowed changelog records; "
            f"rebuild replayed {rebuilt_records} (service had emitted "
            f"{updates_before_kill})"),
        Invariant(
            "retired_stay_retired",
            retired_car not in {c for c in rebuilt_snapshot},
            f"tombstoned car {retired_car!r} absent from the rebuild"
            if retired_car not in rebuilt_snapshot else
            f"tombstoned car {retired_car!r} RESURRECTED by the rebuild"),
        Invariant(
            "rest_serves_twin",
            bool(rest_ok),
            "GET /twin/<car_id> served latest state + rolling aggregates "
            "over the connect REST surface" if rest_ok else
            f"REST twin query failed or incomplete: {rest_doc}"),
    ]
    return TwinDrillReport(
        seed=seed, records=records, published=published,
        cars=len(per_car), rebuilt_records=rebuilt_records,
        compaction_removed=removed, invariants=invariants)
