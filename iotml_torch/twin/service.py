"""TwinService — materialise the per-car digital twin from the stream
(``iotml.twin.service``'s copy).

Dataflow (the Kafka Streams state-store pattern over the port's
primitives)::

    SENSOR_DATA_S_AVRO ──poll──> TwinTable (fold) ──changelog──> CAR_TWIN
            ▲                         │                       (compacted)
            │                         └──> REST /twin/<car>, feature joins
            └── source offsets committed AFTER the changelog lands

``CAR_TWIN`` is created with ``cleanup.policy=compact`` and keyed by car
id, so the store's key-based compaction bounds it at ~one record per car
no matter how long the service runs — and a crashed service rebuilds its
whole table by replaying that changelog (latest record per key wins,
tombstone = retired car), then resumes the source from the provenance
stamped inside the rebuilt states.  Rebuild-equals-snapshot is drilled
live (``python -m iotml_torch.twin drill``).

Sharding: a service instance owns a set of source partitions and
changelogs into the SAME partition numbers, so N instances materialise
the fleet in parallel with no cross-talk — car keys are
partition-stable, so each car's twin lives in exactly one table.

Records are decoded by the pure ``ops.avro.AvroCodec``, as in the JAX
package, so the folded values are the same Python floats.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence

from ..core.schema import KSQL_CAR_SCHEMA, RecordSchema
from ..obs import metrics as obs_metrics
from ..obs import watermark
from ..ops.avro import AvroCodec
from ..ops.framing import strip_frame
from ..stream.broker import OffsetOutOfRangeError
from ..stream.consumer import StreamConsumer
from .state import DEFAULT_WINDOW, TwinTable

#: the compacted changelog topic — the twin's durable form.  Writes to it
#: belong to this package alone, the way the AVRO leg belongs to
#: streamproc: a foreign writer could corrupt every rebuild.
CHANGELOG_TOPIC = "CAR_TWIN"

twin_applied = obs_metrics.default_registry.counter(
    "iotml_twin_applied_records_total",
    "source records folded into the twin table")
twin_changelog = obs_metrics.default_registry.counter(
    "iotml_twin_changelog_records_total",
    "state records published to the CAR_TWIN changelog")
twin_rebuild = obs_metrics.default_registry.counter(
    "iotml_twin_rebuild_records_total",
    "changelog records replayed during table rebuilds")
twin_cars = obs_metrics.default_registry.gauge(
    "iotml_twin_cars", "cars materialised in this twin table")
twin_query_seconds = obs_metrics.default_registry.histogram(
    "iotml_twin_query_seconds", "GET /twin/<car_id> handler latency")


class TwinService:
    """One twin materialiser over one broker (see module docstring).

    Args:
      broker: Broker duck-type (in-memory, durable, wire or routed).
      source_topic: the keyed sensor stream (framed Avro in `schema`).
      partitions: source partitions this instance owns (None = all).
      group: consumer group for source-offset commits.
      window: rolling-window depth per car.
      changelog: False disables changelog emission (a read-only tap —
        used by feature-store consumers that follow someone else's
        changelog instead of writing their own).
      table: an already-warm TwinTable to ADOPT instead of building an
        empty one — the standby-promotion path
        (``gateway.shards.GatewayCluster.promote``): a standby that
        followed the changelog continuously hands its table over and
        only the delta past `rebuild_from` replays.
      rebuild_from: per-partition changelog offsets the adopted table
        has already applied through (TwinTable.changelog positions);
        replay starts there instead of the log beginning.  Ignored
        offsets behind the compacted log's begin are safe — fetch
        resets to earliest and replay stays idempotent (latest record
        per key wins).
    """

    def __init__(self, broker, source_topic: str = "SENSOR_DATA_S_AVRO",
                 partitions: Optional[Sequence[int]] = None,
                 group: str = "iotml-twin",
                 schema: RecordSchema = KSQL_CAR_SCHEMA,
                 window: int = DEFAULT_WINDOW,
                 changelog_topic: str = CHANGELOG_TOPIC,
                 changelog: bool = True,
                 table: Optional[TwinTable] = None,
                 rebuild_from: Optional[Dict[int, int]] = None):
        self.broker = broker
        self.source_topic = source_topic
        self.group = group
        self.schema = schema
        self.codec = AvroCodec(schema)
        self._fields = [f.name for f in schema.sensor_fields]
        self._label = schema.label_field
        self.changelog_topic = changelog_topic
        self.changelog = changelog
        broker.create_topic(source_topic)
        n_parts = broker.topic(source_topic).partitions
        self.partitions = sorted(int(p) for p in (
            partitions if partitions is not None else range(n_parts)))
        # the changelog mirrors the source's partitioning so shard
        # ownership carries over 1:1 (same car -> same partition number)
        broker.create_topic(changelog_topic, partitions=n_parts,
                            cleanup_policy="compact")
        self.table = table if table is not None else TwinTable(window=window)
        self.rebuilt_records = self._rebuild(start=rebuild_from)
        self.consumer = self._make_consumer()
        self.applied = 0
        self.emitted = 0
        # serializes the two changelog writers — the pump thread's
        # emission and a REST-thread retire() — so a stale state record
        # can never land AFTER a tombstone (the table re-check and the
        # produce must be one atomic step)
        self._changelog_lock = threading.Lock()

    # ----------------------------------------------------------- rebuild
    def _rebuild(self, start: Optional[Dict[int, int]] = None) -> int:
        """Replay the compacted changelog into the table: latest record
        per key wins (compaction already dropped most of the rest),
        tombstones delete.  Returns records replayed.  `start` gives
        per-partition offsets an adopted warm table already holds —
        replay covers only the delta from there."""
        start = start or {}
        replayed = 0
        for p in self.partitions:
            try:
                off = self.broker.begin_offset(self.changelog_topic, p)
            except KeyError:
                continue
            off = max(off, start.get(p, 0))
            end = self.broker.end_offset(self.changelog_topic, p)
            while off < end:
                try:
                    batch = self.broker.fetch(self.changelog_topic, p, off,
                                              4096)
                except OffsetOutOfRangeError as e:
                    off = e.earliest
                    continue
                if not batch:
                    # compaction holes between segments end a batch early;
                    # past the last record the log is simply drained
                    break
                for m in batch:
                    if m.key is None:
                        continue
                    self.table.apply_changelog(m.key.decode(), m.value)
                    replayed += 1
                off = batch[-1].offset + 1
        if replayed:
            twin_rebuild.inc(replayed)
        twin_cars.set(len(self.table))
        return replayed

    def _make_consumer(self) -> StreamConsumer:
        """Source cursors: the rebuilt states' provenance wins over the
        committed group offsets when it is FRESHER (changelog landed,
        commit didn't — the crash window), else committed; never behind
        either, so nothing is re-folded and nothing is skipped."""
        resume = self.table.resume_offsets()
        specs = []
        for p in self.partitions:
            committed = self.broker.committed(self.group,
                                              self.source_topic, p)
            off = max(committed if committed is not None else 0,
                      resume.get(p, 0))
            specs.append(f"{self.source_topic}:{p}:{off}")
        return StreamConsumer(self.broker, specs, group=self.group,
                              eof=False)

    # -------------------------------------------------------------- pump
    def pump_once(self, max_messages: int = 4096) -> int:
        """One deterministic pass: poll, fold, changelog, commit.

        Changelog-before-commit ordering makes the crash window safe:
        dying between the two re-delivers source records whose effects
        the changelog already holds, and the provenance dedup
        (TwinTable.apply) folds them to a no-op."""
        msgs = self.consumer.poll(max_messages)
        if not msgs:
            return 0
        dirty: Dict[int, Dict[str, None]] = {}
        applied = 0
        for m in msgs:
            if m.key is None or m.value is None:
                continue  # unkeyed: no car identity to materialise
            try:
                doc = self.codec.decode(strip_frame(m.value))
            except (ValueError, IndexError, KeyError):
                continue  # poisoned frame: the streamproc DLQ's concern
            values = [float(doc.get(n) or 0.0) for n in self._fields]
            failure = self._label is not None and \
                str(doc.get(self._label)).lower() == "true"
            car = m.key.decode()
            if self.table.apply(car, m.partition, m.offset, values,
                                m.timestamp_ms, failure):
                applied += 1
                dirty.setdefault(m.partition, {})[car] = None
        self.applied += applied
        if applied:
            twin_applied.inc(applied)
            twin_cars.set(len(self.table))
        if self.changelog and dirty:
            with self._changelog_lock:
                for p, cars in sorted(dirty.items()):
                    # one coalesced state record per dirty car per pass
                    # — the compaction-friendly shape (latest, keyed)
                    entries = []
                    for car in cars:
                        twin = self.table.get(car)
                        if twin is None:
                            # a REST DELETE (retire() runs on the
                            # connect server's thread) won the race
                            # between this pass's fold and its emission:
                            # its tombstone already changelogs the
                            # delete — emitting the stale fold would
                            # resurrect the car on every rebuild.  The
                            # lock makes this re-check + produce atomic
                            # against retire's pop + tombstone.
                            continue
                        entries.append((car.encode(), twin.encode(),
                                        twin.ts))
                    if not entries:
                        continue
                    self.broker.produce_many(self.changelog_topic,
                                             entries, partition=p)
                    self.emitted += len(entries)
                    twin_changelog.inc(len(entries))
        self.consumer.commit()
        # fold + changelog + commit done: the pass's event-time ranges
        # become the ingest→twin watermark — how stale the
        # digital twin's knowledge of the fleet is, in event time
        watermark.observe_taken("twin", self.consumer.take_event_time(),
                                group=self.group)
        return len(msgs)

    def retire(self, car: str) -> bool:
        """Tombstone a car out of the twin (device decommissioned — the
        MQTT LWT consumer's hook): the changelog carries a null value,
        compaction erases the key after the grace window, rebuilds
        never resurrect it.  Refused on a read-only tap
        (``changelog=False``): producing a tombstone into a changelog
        someone else owns is a two-writer corruption — the owner's
        table would keep serving the car while
        every REBUILD deletes it."""
        if not self.changelog:
            raise RuntimeError(
                "retire() on a read-only twin tap (changelog=False): "
                "the changelog's owning TwinService must issue the "
                "tombstone")
        # pop + tombstone as ONE atomic step against the pump thread's
        # emission (it re-checks the table under the same lock), so a
        # stale state record can never land AFTER the tombstone
        with self._changelog_lock:
            twin = self.table.get(car)
            if twin is None:
                return False
            self.table.apply_changelog(car, None)
            # stamp the tombstone NOW (record-time), not with the car's
            # last reading: an idle car's final reading can already be
            # older than the grace window, and a grace-expired-at-birth
            # tombstone would be dropped by the very first compaction
            # pass — before slow readers (a lagging follower) ever
            # observed the delete
            self.broker.produce(self.changelog_topic, None,
                                key=car.encode(),
                                partition=twin.partition,
                                timestamp_ms=max(twin.ts,
                                                 int(time.time() * 1000)))
        twin_cars.set(len(self.table))
        return True

    # ------------------------------------------------------------ queries
    def get(self, car: str) -> Optional[dict]:
        with twin_query_seconds.time():
            twin = self.table.get(car)
            return None if twin is None else twin.to_doc(self.schema)

    def cars(self, prefix: str = "") -> List[str]:
        cars = self.table.cars()
        return [c for c in cars if c.startswith(prefix)] if prefix else cars

    def count(self) -> int:
        return len(self.table)

    # ---------------------------------------------------------- lifecycle
    def run_forever(self, poll_interval_s: float = 0.2,
                    should_stop=None) -> None:
        while not (should_stop and should_stop()):
            try:
                n = self.pump_once()
            except ConnectionError:
                self.consumer.rewind_to_committed()
                n = 0
            if n == 0:
                time.sleep(poll_interval_s)


class TwinDriver:
    """Background pump thread for one TwinService (registered with the
    supervisor's thread registry)."""

    def __init__(self, service: TwinService, poll_interval_s: float = 0.05):
        self.service = service
        self.poll_interval_s = poll_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "TwinDriver":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=lambda: self.service.run_forever(
                self.poll_interval_s, should_stop=self._stop.is_set),
            daemon=True, name="iotml-twin-driver"))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
