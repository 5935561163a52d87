"""The scenario runner and its invariant verdicts (``iotml.chaos.runner``'s
copy).

Drives the port's own pipeline — devsim fleet → MQTT broker → Kafka
bridge → stream broker (→ follower replica, wire topology) →
KSQL-equivalent convert → scorer — in-process and single-threaded under
an armed ``faults.ChaosEngine``, then proves the delivery contracts the
stack documents:

- ``scored_or_accounted``: every trace id born at publish is closed by a
  ``score`` e2e span or sits in the chaos engine's intentional-loss
  ledger (the span-log form of "at least once or accounted");
- ``at_least_once_counts``: scored >= published - intentionally dropped
  (the count form, the only form on the wire topology: trace headers end
  at the TCP boundary by design);
- ``commits_monotonic``: every committed offset stream, per (broker,
  group, topic, partition), is non-decreasing;
- ``predictions_contiguous``: the predictions topic holds exactly one
  record per scored row;
- ``final_commit_at_end``: after the final drain, committed offsets equal
  the log end;
- ``promotion_loss_bounded`` (wire): the records the promoted follower
  lacks at the leader's death are at most the measured replication lag.

The topologies: ``inproc`` (mqtt-flap, slow-bridge, dup-storm,
partition-blackout, scorer-crash-resume, loss-bug-fixture, which must
fail), ``wire`` (leader-kill-mid-drain), ``store`` (broker-crash-recover,
tier-upload-crash; compaction-under-crash drives the twin service, which
is ROADMAP A16), ``replication`` (double-fault), ``mlops``
(trainer-crash-mid-checkpoint, rollout-regression-rollback), ``online``
(drift-storm), ``obs`` (alert-burn, through ``obs.drill``) and
``cluster`` (rebalance-under-chaos).  Every scorer and trainer a run
builds runs on ``device`` (``cuda`` unless the caller names another).

Determinism: one thread drives every stage (a follower's sync loop is
stepped synchronously, never started as a thread), so faultpoint hit
sequences, and therefore verdicts, replay exactly.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

from . import faults, scenarios
from .scenarios import CARS_PER_TICK, Schedule

if TYPE_CHECKING:  # the cluster's command line starts without torch
    from ..utils.device import DeviceLike

#: trace-birth stages: a trace with one of these spans entered the
#: pipeline and is owed a score or an accounting
BIRTH_STAGES = ("mqtt_publish", "devsim_publish")

#: the drill pipelines' ML input topic, prediction topic and scorer group
IN_TOPIC = "SENSOR_DATA_S_AVRO"
PRED_TOPIC = "model-predictions"
GROUP = "chaos-scorer"


@dataclasses.dataclass(frozen=True)
class Invariant:
    name: str
    ok: bool
    detail: str

    def verdict(self) -> str:
        return f"{'PASS' if self.ok else 'FAIL'}  {self.name}: {self.detail}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


@dataclasses.dataclass
class ChaosReport:
    scenario: str
    seed: int
    records: int
    topology: str
    published: int
    scored: int
    rewinds: int
    dropped_accounted: int
    injected: Dict[str, int]
    invariants: List[Invariant]
    span_path: Optional[str]

    @property
    def ok(self) -> bool:
        return all(i.ok for i in self.invariants)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


# ----------------------------------------------------------- invariants
def _check_commits_monotonic(commit_log: List[tuple]) -> Invariant:
    """Every committed offset stream, per (tag, group, topic,
    partition), is non-decreasing — a rewinding commit would re-deliver
    unbounded history or mask a lost fence."""
    streams: Dict[tuple, int] = {}
    bad = []
    for tag, group, topic, part, off in commit_log:
        key = (tag, group, topic, part)
        if off < streams.get(key, -1):
            bad.append((key, streams[key], off))
        streams[key] = max(streams.get(key, -1), off)
    return Invariant(
        "commits_monotonic", not bad,
        f"{len(commit_log)} commits over {len(streams)} offset streams"
        + (f"; REGRESSIONS {bad[:4]}" if bad else ", all non-decreasing"))


def _check_spans_accounted(span_path: str, dropped_traces) -> Invariant:
    """Every trace born at publish is closed by a ``score`` e2e span or
    is in the engine's ledger of intentional drops."""
    born, closed = set(), set()
    with open(span_path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue
            if doc.get("kind") == "span" and doc.get("stage") in BIRTH_STAGES:
                born.add(doc["trace"])
            elif doc.get("kind") == "e2e" and doc.get("closer") == "score":
                closed.add(doc["trace"])
    ledger = {f"{tid:016x}" for tid in dropped_traces}
    missing = born - closed - ledger
    return Invariant(
        "scored_or_accounted", not missing,
        f"{len(born)} traces born, {len(closed & born)} scored, "
        f"{len(ledger & born)} accounted as chaos drops"
        + (f"; {len(missing)} SILENTLY LOST "
           f"(e.g. {sorted(missing)[:3]})" if missing else ""))


def _check_counts(published: int, scored: int, dropped: int) -> Invariant:
    """At least once, in counts: scored >= published - intentionally
    dropped."""
    ok = scored >= published - dropped
    return Invariant(
        "at_least_once_counts", ok,
        f"published={published} scored={scored} "
        f"intentionally_dropped={dropped}"
        + ("" if ok else f"; {published - dropped - scored} records "
                         f"unaccounted for"))


def _check_predictions(broker, scored: int) -> Invariant:
    end = broker.end_offset(PRED_TOPIC, 0)
    ok = end == scored
    return Invariant(
        "predictions_contiguous", ok,
        f"predictions end offset {end} == rows scored {scored}"
        if ok else f"predictions end offset {end} != rows scored {scored}")


def _check_final_commit(broker, topic: str, parts: int) -> Invariant:
    gaps = []
    for p in range(parts):
        committed = broker.committed(GROUP, topic, p)
        end = broker.end_offset(topic, p)
        if committed != end:
            gaps.append((p, committed, end))
    return Invariant(
        "final_commit_at_end", not gaps,
        "committed == log end on every partition" if not gaps
        else f"partitions behind/ahead at end: {gaps}")


def _record_commits(broker, log: List[tuple], tag: str) -> None:
    """Shadow a broker instance's commit paths with history-recording
    wrappers — the monotonicity invariant needs the sequence, and the
    broker (correctly) stores only the latest value.  Both entry points
    are wrapped: ``StreamConsumer.commit`` prefers the batched
    ``commit_many`` when the broker offers it."""
    orig = broker.commit

    def commit(group, topic, partition, next_offset):
        log.append((tag, group, topic, partition, next_offset))
        return orig(group, topic, partition, next_offset)

    broker.commit = commit
    orig_many = getattr(broker, "commit_many", None)
    if orig_many is not None:
        def commit_many(group, topic, entries):
            for p, off in entries:
                log.append((tag, group, topic, p, off))
            return orig_many(group, topic, entries)

        broker.commit_many = commit_many


def _read_all(broker, topic: str, parts: int) -> Dict[int, list]:
    """Every live record of ``topic`` per partition as comparable
    (offset, key, value, timestamp) tuples; fetch batches end at tier
    boundaries and compaction holes, and the loop walks across."""
    out = {}
    for p in range(parts):
        recs = []
        off = broker.begin_offset(topic, p)
        end = broker.end_offset(topic, p)
        while off < end:
            batch = broker.fetch(topic, p, off, 1 << 20)
            if not batch:
                break
            recs.extend((m.offset, m.key, m.value, m.timestamp_ms)
                        for m in batch)
            off = batch[-1].offset + 1
        out[p] = recs
    return out


# --------------------------------------------------------------- runner
class ChaosRunner:
    """Compile a scenario, drive the pipeline under it, return the
    report.  ``span_path`` keeps the JSONL span log of the traced
    topologies (inproc, store, online; default: a temporary file, its
    path reported).  ``device`` is where the run's scorers and trainers
    compute (``cuda`` unless given)."""

    def __init__(self, scenario: str, seed: int = 7, records: int = 1000,
                 span_path: Optional[str] = None,
                 device: DeviceLike = None):
        self.schedule: Schedule = scenarios.build(scenario, seed=seed,
                                                  records=records)
        self.span_path = span_path
        self.device = device

    # ------------------------------------------------------------ entry
    def run(self) -> ChaosReport:
        from ..obs import tracing

        topology = self.schedule.topology
        eng = faults.arm(faults.ChaosEngine(self.schedule.events))
        # span-log invariants need trace headers end to end: the inproc,
        # store and online topologies carry them (the durable log
        # round-trips headers in their transport byte form); the wire
        # topology loses them at the TCP boundary by design
        trace_inproc = topology in ("inproc", "store", "online")
        prev = (tracing.ENABLED, tracing._SAMPLE, tracing._PATH)
        span_path = self.span_path
        if trace_inproc:
            if span_path is None:
                fd, span_path = tempfile.mkstemp(prefix="iotml_chaos_",
                                                 suffix=".jsonl")
                os.close(fd)
            open(span_path, "w").close()  # a fresh log per run
            tracing.flush()  # drain any earlier spans into the OLD sinks
            tracing.configure(enabled=True, sample=1.0, path=span_path)
            tracing.reset()
        try:
            if topology == "wire":
                return self._run_wire(eng)
            if topology == "store":
                return self._run_store(eng, span_path)
            if topology == "cluster":
                return self._run_cluster(eng)
            if topology == "replication":
                return self._run_replication(eng)
            if topology == "mlops":
                return self._run_mlops(eng)
            if topology == "online":
                return self._run_online(eng, span_path)
            if topology == "obs":
                return self._run_obs()
            return self._run_inproc(eng, span_path)
        finally:
            faults.disarm()
            if trace_inproc:
                tracing.flush()
                tracing.configure(enabled=prev[0], sample=prev[1],
                                  path=prev[2] if prev[2] else "")

    def _report(self, eng: faults.ChaosEngine, topology: str,
                published: int, scored: int, rewinds: int,
                invariants: List[Invariant],
                span_path: Optional[str] = None) -> ChaosReport:
        return ChaosReport(
            scenario=self.schedule.name, seed=self.schedule.seed,
            records=self.schedule.records, topology=topology,
            published=published, scored=scored, rewinds=rewinds,
            dropped_accounted=eng.dropped_count,
            injected=dict(sorted(eng.injected.items())),
            invariants=invariants, span_path=span_path)

    def _ticks(self, least: int = 1) -> int:
        return max(least, -(-self.schedule.records // CARS_PER_TICK))

    # ------------------------------------------------- shared pipeline
    def _make_scorer(self, broker, consumer):
        """The runs' scorer: fresh weights from seed 0, on the device."""
        from ..data.dataset import SensorBatches
        from ..models.autoencoder import CAR_AUTOENCODER
        from ..serve.scorer import StreamScorer
        from ..stream.producer import OutputSequence
        from ..train.loop import Trainer

        trainer = Trainer(CAR_AUTOENCODER, device=self.device)
        trainer._ensure_state()
        batches = SensorBatches(consumer, batch_size=100)
        out = OutputSequence(broker, PRED_TOPIC, partition=0)
        return StreamScorer(CAR_AUTOENCODER, trainer.state.params,
                            batches, out, device=self.device)

    @staticmethod
    def _publish_tick_mqtt(gen, mqtt) -> int:
        """One fleet tick published over MQTT as the simulated cars do
        (QoS 1, one topic per car)."""
        from ..core.schema import CAR_SCHEMA

        cols = gen.step_columns()
        n = len(cols["car"])
        for i in range(n):
            rec = gen.row_record(cols, i, CAR_SCHEMA)
            rec["failure_occurred"] = str(cols["failure_occurred"][i])
            mqtt.publish(
                f"vehicles/sensor/data/{gen.scenario.car_id(i)}",
                json.dumps(rec).encode(), qos=1)
        return n

    @staticmethod
    def _ingest(stream):
        """The MQTT front bridged into ``stream`` and the JSON → Avro
        convert task: (mqtt, task, input partitions)."""
        from ..mqtt.bridge import KafkaBridge
        from ..mqtt.broker import MqttBroker
        from ..streamproc.tasks import JsonToAvro

        mqtt = MqttBroker()
        KafkaBridge(mqtt, stream, partitions=2)
        task = JsonToAvro(stream, src="sensor-data", dst=IN_TOPIC,
                          partitions=2)
        return mqtt, task, stream.topic(IN_TOPIC).partitions

    # ---------------------------------------------------------- inproc
    def _run_inproc(self, eng: faults.ChaosEngine,
                    span_path: str) -> ChaosReport:
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..obs import tracing
        from ..stream.broker import Broker
        from ..stream.consumer import StreamConsumer

        stream = Broker()
        commit_log: List[tuple] = []
        _record_commits(stream, commit_log, "stream")
        mqtt, task, parts = self._ingest(stream)
        consumer = StreamConsumer(
            stream, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
            group=GROUP)
        scorer = self._make_scorer(stream, consumer)

        gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                           seed=self.schedule.seed))
        published = rewinds = 0

        def drive_once():
            nonlocal rewinds
            try:
                task.process_available()
            except ConnectionError:
                task.consumer.rewind_to_committed()
                rewinds += 1
            try:
                return scorer.score_available()
            except ConnectionError:
                consumer.rewind_to_committed()
                rewinds += 1
                return -1

        for _ in range(self._ticks()):
            published += self._publish_tick_mqtt(gen, mqtt)
            drive_once()
            tracing.flush()  # incremental: bound the per-thread buffers
        for _ in range(64):  # final drain: outlast any remaining window
            n = drive_once()
            if n == 0 and consumer.at_end() and task.consumer.at_end():
                break
        tracing.flush()

        invariants = [
            _check_spans_accounted(span_path, eng.dropped_traces),
            _check_counts(published, scorer.scored, eng.dropped_count),
            _check_commits_monotonic(commit_log),
            _check_predictions(stream, scorer.scored),
            _check_final_commit(stream, IN_TOPIC, parts),
        ]
        return self._report(eng, "inproc", published, scorer.scored,
                            rewinds, invariants, span_path)

    # ------------------------------------------------------------ online
    def _run_online(self, eng: faults.ChaosEngine,
                    span_path: str) -> ChaosReport:
        """drift-storm: regional drift and mqtt-flap at once, over the
        MQTT → bridge → convert → online learner + scorer pipeline with a
        live registry between them.

        The drift half is seeded topology state (an AdversarialFleet
        whose cohorts all shift at mid-stream); the schedule injects the
        flap half at ``mqtt.deliver``.  Invariants: the learner detects
        the drift and its adaptation converges, the adapted model reaches
        the scorer through the registry (a hot swap), and the swap costs
        nothing: every surviving record is scored exactly once."""
        from ..gen.scenarios import AdversarialFleet
        from ..gen.scenarios import condition as fleet_condition
        from ..gen.simulator import FleetScenario
        from ..mlops import ModelRegistry, RegistryWatcher
        from ..obs import tracing
        from ..online.learner import OnlineLearner
        from ..stream.broker import Broker
        from ..stream.consumer import StreamConsumer

        stream = Broker()
        commit_log: List[tuple] = []
        _record_commits(stream, commit_log, "stream")
        mqtt, task, parts = self._ingest(stream)
        ticks = self._ticks()
        fleet = AdversarialFleet(
            FleetScenario(num_cars=CARS_PER_TICK,
                          seed=self.schedule.seed, failure_rate=0.02),
            fleet_condition("drift-storm", drift_tick=ticks // 2))
        root = tempfile.mkdtemp(prefix="iotml_chaos_online_")
        try:
            registry = ModelRegistry(root)
            learner = OnlineLearner(stream, IN_TOPIC, registry=registry,
                                    group="chaos-online",
                                    window=CARS_PER_TICK, publish_every=8,
                                    device=self.device)
            consumer = StreamConsumer(
                stream, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
                group=GROUP)
            scorer = self._make_scorer(stream, consumer)
            watcher = RegistryWatcher(registry, scorers=[scorer])
            published = rewinds = 0

            def drive_once():
                nonlocal rewinds
                try:
                    task.process_available()
                except ConnectionError:
                    task.consumer.rewind_to_committed()
                    rewinds += 1
                learner.process_available()
                learner.write_published()
                watcher.poll_once()
                try:
                    return scorer.score_available()
                except ConnectionError:
                    consumer.rewind_to_committed()
                    rewinds += 1
                    return -1

            for _ in range(ticks):
                published += fleet.publish_mqtt(mqtt, n_ticks=1)
                drive_once()
                tracing.flush()
            for _ in range(64):  # final drain
                n = drive_once()
                if n == 0 and consumer.at_end() \
                        and task.consumer.at_end() \
                        and learner.consumer.at_end():
                    break
            learner.write_published()
            watcher.poll_once()
            tracing.flush()

            mon = learner.monitor
            detections = list(learner.adaptations)
            latest = registry.latest()
            invariants = [
                Invariant(
                    "drift_detected",
                    mon.drifts >= 1 and bool(detections),
                    f"{mon.drifts} drift episode(s) on the error "
                    f"signal (adaptations: {detections[:4]})"),
                Invariant(
                    "adaptation_converged",
                    mon.converged >= 1,
                    f"{mon.converged} episode(s) converged "
                    f"(state {mon.state!r}, baseline "
                    f"{mon.baseline and round(mon.baseline, 4)})"),
                Invariant(
                    "adapted_model_swapped",
                    latest is not None and latest >= 1
                    and scorer.model_version == latest
                    and watcher.swaps >= 1,
                    f"scorer serving registry v{scorer.model_version} "
                    f"== tip v{latest} after {watcher.swaps} hot-"
                    f"swap(s) under the storm"),
                _check_spans_accounted(span_path, eng.dropped_traces),
                _check_counts(published, scorer.scored,
                              eng.dropped_count),
                _check_commits_monotonic(commit_log),
                _check_predictions(stream, scorer.scored),
                _check_final_commit(stream, IN_TOPIC, parts),
            ]
            return self._report(eng, "online", published, scorer.scored,
                                rewinds, invariants, span_path)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # ------------------------------------------------------------- store
    def _run_store(self, eng: faults.ChaosEngine,
                   span_path: str) -> ChaosReport:
        """The durable-broker scenarios, each in a store directory of its
        own that is removed afterwards."""
        if self.schedule.name == "compaction-under-crash":
            raise NotImplementedError(
                "chaos scenario 'compaction-under-crash' drives the twin "
                "service (twin/), which is not ported yet (ROADMAP A16)")
        store_dir = tempfile.mkdtemp(prefix="iotml_chaos_store_")
        try:
            if self.schedule.name == "tier-upload-crash":
                return self._run_tiered_in(eng, span_path, store_dir)
            return self._run_store_in(eng, span_path, store_dir)
        finally:
            shutil.rmtree(store_dir, ignore_errors=True)

    def _run_store_in(self, eng: faults.ChaosEngine, span_path: str,
                      store_dir: str) -> ChaosReport:
        """broker-crash-recover: the inproc pipeline over a broker on the
        segmented store (``fsync=always``), the process "killed" mid-write
        at the scheduled record count (the broker object abandoned
        unflushed with a torn frame on the active segment, what a real
        kill leaves on disk), then remounted: recovery truncates the torn
        tail, every record acked before the kill re-serves byte for byte,
        and a restarted pipeline (fresh task, consumer and scorer, cursors
        from the committed offsets) finishes the stream with the delivery
        invariants intact."""
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..obs import tracing
        from ..store import StorePolicy
        from ..stream.broker import Broker
        from ..stream.consumer import StreamConsumer

        # small segments so the crash lands on a log with real rolls
        # behind it; fsync=always is the acked=durable contract the
        # zero-loss invariant rides on
        policy = dict(fsync="always", segment_bytes=64 * 1024)
        commit_log: List[tuple] = []
        rewinds = published = 0
        gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                           seed=self.schedule.seed))

        def build_pipeline(broker):
            """One process incarnation: ingress, transform and scorer,
            every cursor resuming from the broker's committed offsets."""
            mqtt, task, parts = self._ingest(broker)
            consumer = StreamConsumer.from_committed(
                broker, IN_TOPIC, range(parts), group=GROUP)
            scorer = self._make_scorer(broker, consumer)
            return mqtt, task, consumer, scorer, parts

        broker = Broker(store_dir=store_dir,
                        store_policy=StorePolicy(**policy))
        _record_commits(broker, commit_log, "stream")
        mqtt, task, consumer, scorer, parts = build_pipeline(broker)

        def drive_once():
            nonlocal rewinds
            try:
                task.process_available()
            except ConnectionError:
                task.consumer.rewind_to_committed()
                rewinds += 1
            try:
                return scorer.score_available()
            except ConnectionError:
                consumer.rewind_to_committed()
                rewinds += 1
                return -1

        crash = {"done": False, "torn": 0, "acked": {}, "committed": {},
                 "recovered_end": {}, "truncated": 0, "resumed_at": {},
                 "replayed_match": False}
        scored_total = 0

        def crash_and_recover():
            nonlocal broker, mqtt, task, consumer, scorer, parts
            nonlocal scored_total
            # the kill: snapshot what was ACKED, leave a torn frame
            for t in (IN_TOPIC, PRED_TOPIC, "sensor-data"):
                for p in range(broker.topic(t).partitions):
                    crash["acked"][(t, p)] = broker.end_offset(t, p)
            for p in range(parts):
                crash["committed"][p] = broker.committed(GROUP, IN_TOPIC, p)
            pre_crash = broker.fetch(IN_TOPIC, 0,
                                     broker.begin_offset(IN_TOPIC, 0), 10**6)
            crash["torn"] = broker.store.log_for(
                IN_TOPIC, 0).simulate_torn_write()
            scored_total += scorer.scored
            # the old incarnation is dead: nothing flushes, nothing
            # closes; fsync=always already made every ack durable
            broker = Broker(store_dir=store_dir,
                            store_policy=StorePolicy(**policy))
            _record_commits(broker, commit_log, "stream")
            crash["truncated"] = broker.store.recovered_truncated_bytes()
            for key in crash["acked"]:
                crash["recovered_end"][key] = broker.end_offset(*key)
            # byte-identical replay: the full pre-crash read repeats
            post_crash = broker.fetch(IN_TOPIC, 0,
                                      broker.begin_offset(IN_TOPIC, 0),
                                      10**6)
            crash["replayed_match"] = \
                [(m.offset, m.key, m.value, m.timestamp_ms)
                 for m in pre_crash] == \
                [(m.offset, m.key, m.value, m.timestamp_ms)
                 for m in post_crash]
            mqtt, task, consumer, scorer, parts = build_pipeline(broker)
            crash["resumed_at"] = {p: off for _t, p, off
                                   in consumer.positions()}
            crash["done"] = True

        def run_due_events():
            for ev in eng.due_runner_events(published):
                if ev.action == "crash_broker" and not crash["done"]:
                    crash_and_recover()
                    eng.note_runner_fired(ev)

        for _ in range(self._ticks()):
            run_due_events()
            published += self._publish_tick_mqtt(gen, mqtt)
            drive_once()
            tracing.flush()
        run_due_events()
        for _ in range(64):
            n = drive_once()
            if n == 0 and consumer.at_end() and task.consumer.at_end():
                break
        tracing.flush()
        scored_total += scorer.scored
        broker.close()

        lost = {k: (acked, crash["recovered_end"].get(k))
                for k, acked in crash["acked"].items()
                if crash["recovered_end"].get(k) != acked}
        resumed_bad = {p: (crash["resumed_at"].get(p), committed)
                       for p, committed in crash["committed"].items()
                       if committed is not None
                       and crash["resumed_at"].get(p) != committed}
        truncated_ok = crash["truncated"] == crash["torn"]
        invariants = [
            _check_spans_accounted(span_path, eng.dropped_traces),
            _check_counts(published, scored_total, eng.dropped_count),
            _check_commits_monotonic(commit_log),
            _check_predictions(broker, scored_total),
            _check_final_commit(broker, IN_TOPIC, parts),
            Invariant(
                "acked_records_survive_crash",
                crash["done"] and not lost,
                ("broker never crashed" if not crash["done"] else
                 f"every pre-kill acked offset re-served after remount "
                 f"({sum(crash['acked'].values())} records across "
                 f"{len(crash['acked'])} partitions)" if not lost else
                 f"ACKED RECORDS LOST after recovery: {lost}")),
            Invariant(
                "replay_byte_identical",
                crash["replayed_match"],
                "pre-crash read == post-recovery read (offset, key, "
                "value, timestamp all equal)" if crash["replayed_match"]
                else "post-recovery replay DIVERGED from the acked read"),
            Invariant(
                "torn_tail_truncated",
                crash["done"] and truncated_ok,
                f"recovery truncated {crash['truncated']} bytes == the "
                f"{crash['torn']} torn bytes the kill left "
                f"(iotml_store_recovery_truncated_bytes)"
                if truncated_ok else
                f"recovery truncated {crash['truncated']} bytes, kill "
                f"left {crash['torn']}"),
            Invariant(
                "consumer_resumed_from_committed",
                crash["done"] and not resumed_bad,
                "restarted consumer cursors == persisted committed "
                "offsets" if not resumed_bad else
                f"cursors diverged from persisted commits: {resumed_bad}"),
        ]
        return self._report(eng, "store", published, scored_total,
                            rewinds, invariants, span_path)

    # ------------------------------------------------------------- tiered
    def _run_tiered_in(self, eng: faults.ChaosEngine, span_path: str,
                       store_dir: str) -> ChaosReport:
        """tier-upload-crash: a durable broker tiers sealed segments into
        a local-directory artifact store, and the uploader is killed at
        the scheduled ``store.tier_upload`` traversal, between the segment
        blob uploads and the remote manifest commit (staged blobs exist
        remotely, nothing references them).  Proven: a cold reader
        trusting only the manifest serves exactly the committed prefix,
        the local copy stays authoritative across the kill, the finished
        pass sweeps the garbage, and, after the hot tier is evicted
        whole, the history replays through the remote leg byte for byte
        as before the kill, across a remount too."""
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..store import RemoteTier, StorePolicy, TieredLog, TierPolicy
        from ..stream.broker import Broker

        remote_dir = tempfile.mkdtemp(prefix="iotml_chaos_tier_")
        cold_dir = tempfile.mkdtemp(prefix="iotml_chaos_cold_")
        policy = dict(fsync="interval", segment_bytes=16 * 1024)
        parts = 2
        try:
            broker = Broker(store_dir=store_dir,
                            store_policy=StorePolicy(**policy),
                            tier=TierPolicy(uri=remote_dir))
            broker.create_topic(IN_TOPIC, partitions=parts)
            gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                               seed=self.schedule.seed))
            published = 0
            for _ in range(self._ticks(least=2)):
                published += gen.publish(broker, IN_TOPIC, n_ticks=1,
                                         partitions=parts)
            logs = [broker.store.log_for(IN_TOPIC, p) for p in range(parts)]
            for log in logs:
                log.roll()  # sealed segments exist before the first pass
            pre_kill = _read_all(broker, IN_TOPIC, parts)
            store_obj = broker.store._tier_store

            def unreferenced(p):
                """Blobs under partition p's prefix that the manifest
                does not name: the torn upload's remote footprint."""
                tierp = logs[p].remote
                referenced = {tierp._manifest_name}
                for m in tierp.load():
                    for sfx in (".log", ".index", ".timeindex"):
                        referenced.add(tierp._blob(m.base, sfx))
                return [n for n in store_obj.list(tierp.prefix)
                        if n not in referenced]

            # the kill: the scheduled error fires inside an upload, after
            # the blobs landed and before the manifest commit
            crashed = False
            try:
                broker.run_tiering()
            except RuntimeError:
                crashed = True
            committed = {p: logs[p].remote_metas() for p in range(parts)}
            torn = {p: unreferenced(p) for p in range(parts)}
            any_torn = any(torn.values())

            # local authority: every pre-kill byte still re-serves
            local_ok = _read_all(broker, IN_TOPIC, parts) == pre_kill

            # a cold reader (a fresh empty dir, trusting the manifest
            # alone, as a bootstrapping follower does) serves exactly the
            # committed prefix, every segment CRC-verified, nothing staged
            cold_ok = True
            for p in range(parts):
                cold = TieredLog(
                    os.path.join(cold_dir, str(p)),
                    policy=StorePolicy(fsync="never"),
                    remote=RemoteTier(store_obj,
                                      prefix=logs[p].remote.prefix),
                    tier=TierPolicy(uri=remote_dir))
                recs = []
                off = cold.base_offset
                end = max((m.next for m in cold.remote_metas()),
                          default=off)
                while off < end:
                    batch = cold.read_from(off, 4096)
                    if not batch:
                        break
                    recs.extend((o, k, v, ts) for o, k, v, ts, _h in batch)
                    off = recs[-1][0] + 1
                cold.close()
                want = [r for r in pre_kill[p]
                        if committed[p]
                        and r[0] < max(m.next for m in committed[p])]
                if recs != want:
                    cold_ok = False

            # finish the job: the spent event does not fire again; the
            # completed pass commits everything and sweeps the garbage
            finished = True
            try:
                stats = broker.run_tiering()
            except RuntimeError:
                finished, stats = False, {}
            garbage_left = sum(len(unreferenced(p)) for p in range(parts))

            # the hot tier evicted whole: history serves through the
            # remote leg only (plus the live active segment locally)
            for log in logs:
                log.evict_hot(budget_bytes=0)
            evicted = all(log.local_base_offset > log.base_offset
                          for log in logs)
            remote_replay = _read_all(broker, IN_TOPIC, parts)
            remote_used = any(len(log.cache) for log in logs)
            replay_ok = remote_replay == pre_kill and evicted and remote_used

            # and a remount sees the same bytes (the manifest and the
            # local tail recompose the one log)
            broker.close()
            broker2 = Broker(store_dir=store_dir,
                             store_policy=StorePolicy(**policy),
                             tier=TierPolicy(uri=remote_dir))
            stable = _read_all(broker2, IN_TOPIC, parts) == pre_kill
            broker2.close()
        finally:
            shutil.rmtree(remote_dir, ignore_errors=True)
            shutil.rmtree(cold_dir, ignore_errors=True)

        invariants = [
            Invariant(
                "crash_injected",
                crashed and any_torn,
                f"uploader killed between blob puts and manifest commit "
                f"({sum(len(v) for v in torn.values())} unreferenced "
                f"staged blob(s) left remotely)" if crashed and any_torn
                else "the scheduled store.tier_upload error NEVER FIRED "
                     "(or left no staged garbage)"),
            Invariant(
                "torn_upload_never_served",
                cold_ok,
                "cold manifest-only reader served exactly the committed "
                "prefix, every segment CRC-verified" if cold_ok else
                "cold reader DIVERGED from the committed prefix (torn "
                "or missing bytes served)"),
            Invariant(
                "local_authoritative_across_kill",
                local_ok,
                "every pre-kill record re-served locally after the "
                "crashed pass" if local_ok else
                "local reads DIVERGED after the crashed upload pass"),
            Invariant(
                "resumed_pass_commits_and_sweeps",
                finished and garbage_left == 0,
                f"re-run pass committed the interrupted segment and "
                f"swept the stage garbage (sweep total "
                f"{sum(s.get('swept', 0) for s in stats.values())})"
                if finished and garbage_left == 0 else
                f"resumed pass failed or left {garbage_left} "
                f"unreferenced blob(s)"),
            Invariant(
                "remote_replay_byte_identical",
                replay_ok,
                "hot tier evicted; full history replayed THROUGH THE "
                "REMOTE TIER byte-identical to pre-kill reads"
                if replay_ok else
                f"remote replay diverged (evicted={evicted}, "
                f"remote_cache_used={remote_used})"),
            Invariant(
                "remount_byte_stable",
                stable,
                "a remounted broker re-serves the identical history "
                "from manifest + local tail" if stable else
                "post-remount reads DIVERGED"),
        ]
        return self._report(eng, "store", published, 0, 0, invariants,
                            span_path)

    # ---------------------------------------------------------------- obs
    def _run_obs(self) -> ChaosReport:
        """alert-burn: the telemetry-plane drill (``obs.drill``) under the
        runner.  The drill arms faults itself (its sustained degradation
        must land in the DEGRADED phase, not at t=0), so the runner's
        engine is stood down and the schedule's events handed over; the
        drill also configures its own tracing."""
        from ..obs.drill import drill_alert_burn

        faults.disarm()
        rep = drill_alert_burn(seed=self.schedule.seed,
                               records=self.schedule.records,
                               events=self.schedule.events,
                               device=self.device)
        return ChaosReport(
            scenario=self.schedule.name, seed=self.schedule.seed,
            records=self.schedule.records, topology="obs",
            published=rep.published, scored=rep.scored,
            rewinds=0, dropped_accounted=0,
            injected=dict(rep.injected), invariants=list(rep.invariants),
            span_path=None)

    # -------------------------------------------------------------- mlops
    def _run_mlops(self, eng: faults.ChaosEngine) -> ChaosReport:
        """The model-lifecycle scenarios on a temporary registry."""
        root = tempfile.mkdtemp(prefix="iotml_chaos_mlops_")
        try:
            if self.schedule.name == "rollout-regression-rollback":
                return self._run_mlops_rollback(eng, root)
            return self._run_mlops_trainer_crash(eng, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)

    def _run_mlops_trainer_crash(self, eng: faults.ChaosEngine,
                                 root: str) -> ChaosReport:
        """The trainer killed inside a registry publication.

        The checkpoint writer is driven on the drive thread
        (``write_once``), so the scheduled ``registry.commit`` error lands
        on an exact publish: artifacts visible, manifest never written,
        the torn version dir a real kill leaves.  The "process" then dies
        (trainer and checkpointer abandoned) and a second incarnation
        mounts the same registry root: ``recover()`` must sweep exactly
        the torn dir, readers must never have seen it, and the restarted
        trainer must resume model and stream cursors from the last
        durable manifest, re-consuming forward from its stamped offsets
        (no gap), never behind them (no double training).

        A run too short for a crash round fails
        ``crash_injected_mid_publish`` (and what needs the crash), where
        the JAX runner raises KeyError."""
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..mlops import AsyncCheckpointer, ModelRegistry
        from ..stream.broker import Broker
        from ..train.live import ContinuousTrainer

        group = "chaos-mlops-train"
        broker = Broker()
        commit_log: List[tuple] = []
        _record_commits(broker, commit_log, "stream")
        gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                           seed=self.schedule.seed,
                                           failure_rate=0.02))
        published = gen.publish(broker, IN_TOPIC, n_ticks=self._ticks(),
                                partitions=2)

        def incarnation():
            reg = ModelRegistry(root)
            swept = reg.recover()
            ck = AsyncCheckpointer(reg)
            tr = ContinuousTrainer(broker, IN_TOPIC, None, checkpointer=ck,
                                   group=group, batch_size=25,
                                   take_batches=2, only_normal=False,
                                   device=self.device)
            return reg, ck, tr, swept

        def version_dirs():
            return sorted(n for n in os.listdir(
                os.path.join(root, "versions")) if n.startswith("v"))

        reg, ck, tr, _ = incarnation()
        crash: dict = {"round": None, "versions_visible": [], "dirs": [],
                       "committed": {}}
        trained = 0
        while tr.available() >= tr.min_available:
            stats = tr.train_round()
            trained += stats.get("records", 0)
            try:
                ck.write_once()
            except RuntimeError:
                # the kill: snapshot the on-disk evidence the dead process
                # leaves, then abandon every live object
                crash["round"] = tr.rounds
                crash["versions_visible"] = reg.versions()
                crash["dirs"] = version_dirs()
                crash["committed"] = {
                    p: broker.committed(group, IN_TOPIC, p)
                    for p in range(2)}
                break

        committed_names = {f"v{v:010d}" for v in crash["versions_visible"]}
        torn_dirs = sorted(set(crash["dirs"]) - committed_names)

        # the restart: a fresh mount of the same registry root
        reg2, ck2, tr2, swept = incarnation()
        post_recover_versions = reg2.versions()
        last_durable = reg2.latest()
        manifest = reg2.manifest(last_durable) \
            if last_durable is not None else None
        resumed = {p: off for _t, p, off in tr2.consumer.positions()}
        post_crash_versions = []
        while tr2.available() >= tr2.min_available:
            stats = tr2.train_round()
            trained += stats.get("records", 0)
            v = ck2.write_once()
            if v is not None:
                post_crash_versions.append(v)
        final_versions = reg2.versions()

        manifest_offsets = {p: off for _t, p, off
                            in (manifest.offsets if manifest else [])}
        commit_behind = manifest is not None and all(
            (crash["committed"].get(p) or 0) <= manifest_offsets.get(p, 0)
            for p in range(2))
        final_manifest = reg2.manifest(final_versions[-1]) \
            if final_versions else None
        final_committed_ok = final_manifest is not None and all(
            broker.committed(group, t, p) == off
            for t, p, off in final_manifest.offsets)
        invariants = [
            Invariant(
                "crash_injected_mid_publish",
                crash["round"] is not None,
                f"registry.commit crash landed on round {crash['round']}"
                if crash["round"] is not None else
                "the scheduled mid-publish crash never fired"),
            Invariant(
                "torn_version_never_served",
                len(torn_dirs) == 1
                and int(torn_dirs[0][1:]) not in crash["versions_visible"],
                f"torn dir {torn_dirs} existed on disk, invisible to "
                f"versions() before AND after recovery" if torn_dirs else
                "no torn version dir found — the crash left no artifact"),
            Invariant(
                "recover_swept_torn_only",
                swept == len(torn_dirs) and
                post_recover_versions == crash["versions_visible"],
                f"recover() swept {swept} dir(s) == the {len(torn_dirs)} "
                f"torn; committed set unchanged"),
            Invariant(
                "commit_trails_checkpoint",
                commit_behind,
                "committed offsets at crash <= last durable manifest's "
                "stamped offsets on every partition" if commit_behind else
                f"COMMITTED RAN AHEAD of durable state: "
                f"committed={crash['committed']} "
                f"manifest={manifest_offsets}"),
            Invariant(
                "resumed_exactly_at_manifest",
                manifest is not None and resumed == manifest_offsets,
                f"restart cursors {resumed} == durable manifest offsets "
                f"{manifest_offsets} (no gap, no double-train)"
                if resumed == manifest_offsets else
                f"restart cursors {resumed} DIVERGED from manifest "
                f"{manifest_offsets}"),
            Invariant(
                "version_ids_number_commits",
                bool(final_versions) and final_versions == list(
                    range(1, len(final_versions) + 1)),
                f"{len(final_versions)} committed versions, contiguous "
                f"ids (the torn publish's id was reused)"),
            Invariant(
                "training_resumed_to_end",
                bool(post_crash_versions)
                and tr2.available() < tr2.min_available
                and final_committed_ok,
                f"{len(post_crash_versions)} post-crash versions "
                f"published; stream consumed to the round boundary; "
                f"final committed == final manifest offsets"),
            _check_commits_monotonic(commit_log),
        ]
        return self._report(eng, "mlops", published, trained, 0,
                            invariants)

    def _run_mlops_rollback(self, eng: faults.ChaosEngine,
                            root: str) -> ChaosReport:
        """Deploy a degraded candidate; the gate must roll it back.

        The baseline is a quickly trained autoencoder published through
        the async checkpointer; the candidate is the same weights wrecked
        with seeded noise, published and DEPLOYED (serving points at it
        for the evaluation window).  Both score the whole seeded stream
        into their own prediction topics; the detection-quality gate must
        see the AUC/F1 regression and point serving back at the baseline
        within one pass over the stream."""
        import numpy as np

        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..mlops import (ABRollout, AsyncCheckpointer, ModelRegistry,
                             RolloutGate)
        from ..mlops.checkpoint import (params_from_h5_bytes,
                                        params_to_h5_bytes)
        from ..online.drill import _noised
        from ..stream.broker import Broker
        from ..train.live import ContinuousTrainer

        broker = Broker()
        commit_log: List[tuple] = []
        _record_commits(broker, commit_log, "stream")
        gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                           seed=self.schedule.seed,
                                           failure_rate=0.05))
        published = gen.publish(broker, IN_TOPIC, n_ticks=self._ticks(),
                                partitions=2)

        reg = ModelRegistry(root)
        tr = ContinuousTrainer(
            broker, IN_TOPIC, None, checkpointer=AsyncCheckpointer(reg),
            group="chaos-ab-train", batch_size=50,
            take_batches=max(2, min(8, published // 60)),
            epochs_per_round=3, device=self.device)
        tr.train_round()
        tr.checkpointer.write_once()
        baseline = reg.latest()

        # the candidate: the baseline + N(0, 1), drawn in the JAX
        # package's leaf order
        params = params_from_h5_bytes(reg.load_bytes(baseline, "model.h5"))
        bad = _noised(params, np.random.RandomState(self.schedule.seed))
        candidate = reg.publish(
            {"model.h5": params_to_h5_bytes(bad)},
            metrics={"degraded": 1.0}).version

        gate = RolloutGate(
            min_records=max(50, min(300, published // 2)), epsilon=0.02)
        ab = ABRollout(broker, IN_TOPIC, reg, baseline, candidate,
                       gate=gate, threshold=5.0, deploy_candidate=True,
                       from_start=True, device=self.device)
        serving_during = reg.channel("serving")
        # one deterministic pass: both sides drain the retained stream,
        # and the gate must settle before the data runs out
        for _ in range(512):
            if ab.step(max_rows=5_000) == 0:
                break
        scored = sum(s.scored for s in ab.sides.values())
        qb, qc = ab.quality("baseline"), ab.quality("candidate")
        serving_after = reg.channel("serving")
        events = [e["event"] for e in reg.history()]
        pred_ok = all(
            broker.end_offset(f"model-predictions.v{v}", 0) == s.scored
            for v, s in ((baseline, ab.sides["baseline"]),
                         (candidate, ab.sides["candidate"])))
        invariants = [
            Invariant(
                "regression_rolled_back",
                ab.decision == "rollback",
                f"gate verdict: {ab.decision!r} "
                f"(baseline auc={qb['auc']}, candidate auc={qc['auc']})"),
            Invariant(
                "candidate_served_during_eval",
                serving_during == candidate,
                f"serving pointed at the candidate (v{serving_during}) "
                f"for the evaluation window"),
            Invariant(
                "serving_restored_to_baseline",
                serving_after == baseline and "rollback" in events,
                f"serving back at v{serving_after} == baseline "
                f"v{baseline}; history records the rollback"),
            Invariant(
                "quality_gap_real",
                qb["auc"] is not None and qc["auc"] is not None
                and qb["auc"] > qc["auc"] + gate.epsilon,
                f"measured regression: baseline auc {qb['auc']} vs "
                f"candidate {qc['auc']} (epsilon {gate.epsilon})"),
            Invariant(
                "decided_within_one_pass",
                ab.decision is not None and all(
                    s.scored <= published for s in ab.sides.values()),
                f"verdict after {max(s.scored for s in ab.sides.values())}"
                f"/{published} records per side — no replay needed"),
            Invariant(
                "ab_prediction_streams_on_log",
                pred_ok,
                "both versions' prediction topics hold exactly one "
                "record per scored row (the comparison artifact is "
                "itself replayable)" if pred_ok else
                "prediction topic row counts diverge from scored rows"),
            _check_commits_monotonic(commit_log),
        ]
        return self._report(eng, "mlops", published, scored, 0, invariants)

    # ------------------------------------------------------ replication
    def _run_replication(self, eng: faults.ChaosEngine) -> ChaosReport:
        """double-fault under sustained acks=all load.

        A leader and two ISR-tracked followers (min_isr 2) serve a
        2-partition topic; every produce is acks=all, issued from a worker
        thread while this thread steps the followers' sync rounds, so the
        quorum wait resolves deterministically.  Mid-epoch one follower
        dies abruptly (the ISR evicts it; the quorum re-forms at width 2),
        then the leader dies with no drain.  The runner promotes an ISR
        member at epoch 1, heals the set with a new follower bootstrapped
        from the promoted leader, and finishes the stream.

        The proof: no acked record lost, byte for byte — every (partition,
        offset, value) acked before the leader's death reads back the same
        from the promoted log; the consumer (bounded by the quorum HWM)
        scores the final log exactly once; commits stay monotonic across
        the promotion; and the new leader sat in the ISR at the kill."""
        import threading

        from ..replication import ReplicaSet
        from ..stream.broker import Broker
        from ..stream.consumer import StreamConsumer
        from ..stream.kafka_wire import KafkaWireBroker, KafkaWireServer
        from ..supervise.registry import register_thread

        parts = 2
        leader = Broker()
        leader.create_topic(IN_TOPIC, partitions=parts)
        commit_log: List[tuple] = []
        _record_commits(leader, commit_log, "leader")
        lsrv = KafkaWireServer(leader).start()
        rs = ReplicaSet(leader_broker=leader, leader_server=lsrv,
                        n_followers=2, min_isr=2, max_lag_s=0.25,
                        topics=[IN_TOPIC], groups=(GROUP,))
        for rid, rep in rs.followers.items():
            _record_commits(rep.local, commit_log, f"follower-{rid}")
        rs.start(sync="manual")  # stepped: determinism over realism
        bootstrap = ",".join(
            [f"127.0.0.1:{lsrv.port}"]
            + [f"127.0.0.1:{rep.port}" for rep in rs.followers.values()])
        producer = KafkaWireBroker(bootstrap, client_id="chaos-repl-prod")
        consumer_client = KafkaWireBroker(bootstrap,
                                          client_id="chaos-repl-scorer")
        consumer = StreamConsumer(
            consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
            group=GROUP)

        published = rewinds = 0
        acked: Dict[Tuple[int, int], bytes] = {}  # (part, offset) -> value
        consumed: List[Tuple[int, int, bytes]] = []
        killed_follower: Optional[int] = None
        killed_leader = False
        isr_at_kill: List[int] = []
        promoted_rid: Optional[int] = None
        healed_rid: Optional[int] = None

        # the ISR forms before the load: acks=all refuses below min_isr by
        # contract, and the scenario is about losing the quorum
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not all(
                rs.state.isr_size(IN_TOPIC, p) == 3 for p in range(parts)):
            rs.sync_once()

        def produce_tick(tick: int) -> int:
            """One tick of acks=all load: the produce blocks in the wire
            server until the quorum HWM covers it, so it runs on a worker
            thread while this thread steps replication."""
            nonlocal published
            n = 0
            for p in range(parts):
                values = [f"t{tick}r{i}p{p}".encode()
                          for i in range(CARS_PER_TICK // parts)]
                result: dict = {}

                def attempt_produce(res=result, _p=p, _vals=values):
                    try:
                        res["last"] = producer.produce_many(
                            IN_TOPIC, [(None, v, 0) for v in _vals],
                            partition=_p, timeout_ms=8000)
                    except Exception as e:  # noqa: BLE001 - verdict data
                        res["err"] = e

                for _attempt in range(12):  # redelivery (caller-owns)
                    result.clear()
                    t = register_thread(threading.Thread(
                        target=attempt_produce, daemon=True,
                        name="iotml-chaos-repl-producer"))
                    t.start()
                    while t.is_alive():
                        rs.sync_once()
                        time.sleep(0.002)
                    t.join(1.0)
                    if "last" in result:
                        last = result["last"]
                        for i, v in enumerate(values):
                            acked[(p, last - len(values) + 1 + i)] = v
                        n += len(values)
                        break
                    err = result.get("err")
                    if err is not None and not isinstance(
                            err, ConnectionError):
                        raise err
                    # the ConnectionError family (NotEnoughReplicas and
                    # ProduceTimedOut too): step replication, redeliver
                    for _ in range(5):
                        rs.sync_once()
                    time.sleep(0.05)
                else:
                    # never give up silently: a dropped batch would let
                    # the invariants pass vacuously
                    raise RuntimeError(
                        f"acks=all batch for partition {p} undeliverable "
                        f"after 12 redelivery attempts: {result.get('err')}")
            published += n
            return n

        def drain() -> int:
            nonlocal rewinds
            try:
                batch = consumer.poll(4096)
            except ConnectionError:
                consumer.rewind_to_committed()
                rewinds += 1
                return 0
            for m in batch:
                consumed.append((m.partition, m.offset, m.value))
            if batch:
                consumer.commit()
            return len(batch)

        def run_due_events():
            nonlocal killed_follower, killed_leader, promoted_rid, \
                healed_rid, isr_at_kill
            for ev in eng.due_runner_events(published):
                if ev.action == "kill_follower" and \
                        killed_follower is None:
                    killed_follower = sorted(rs.followers)[0]
                    rs.kill_follower(killed_follower)
                    # the kill blocks ~0.4 s in the server's shutdown;
                    # the survivor fetches at once, as a live follower
                    # would have meanwhile, so the staleness scan evicts
                    # the dead follower alone and the quorum re-forms at
                    # width 2 (JAX's runner steps nothing here: the next
                    # append finds both followers stale, and its server
                    # acks that batch with the leader alone in the ISR)
                    rs.sync_once()
                    eng.note_runner_fired(ev)
                elif ev.action == "kill_leader" and not killed_leader:
                    # retire the dead follower BEFORE electing: if both
                    # kills land in one batch of events, no staleness
                    # window has passed and the corpse still sits in the
                    # ISR; the election must never pick it
                    if killed_follower is not None:
                        rs.retire_follower(killed_follower)
                    # no pre-kill drain: the un-acked tail may die with
                    # the leader; the acked records cannot
                    isr_at_kill = sorted(rs.state.isr_follower_ids())
                    lsrv.kill()
                    killed_leader = True
                    promoted_rid, _addr = rs.promote(epoch=1)
                    # the elastic heal: a fresh follower bootstraps the
                    # whole log from the promoted leader over RAW_FETCH
                    # and re-forms the 2-wide quorum
                    healed_rid = rs.add_follower(sync="manual")
                    _record_commits(rs.followers[healed_rid].local,
                                    commit_log, "healed")
                    deadline = time.monotonic() + 10.0
                    while time.monotonic() < deadline and \
                            healed_rid not in rs.state.isr_follower_ids():
                        rs.sync_once()
                    eng.note_runner_fired(ev)

        try:
            for tick in range(self._ticks()):
                run_due_events()
                produce_tick(tick)
                rs.sync_once()
                drain()
            run_due_events()
            # the final drain to the quorum frontier (the log end once the
            # healed follower is in sync)
            for _ in range(200):
                rs.sync_once()
                if drain() == 0 and consumer.at_end():
                    break
        finally:
            for client in (producer, consumer_client):
                try:
                    client.close()
                except OSError:
                    pass
            rs.stop()
            if not killed_leader:
                lsrv.kill()

        live = rs.leader  # the promoted broker serves the end state
        lost, mismatched = [], []
        for (p, off), value in sorted(acked.items()):
            got = {m.offset: m.value
                   for m in live.fetch_tail(IN_TOPIC, p, off, 1)}
            if off not in got:
                lost.append((p, off))
            elif got[off] != value:
                mismatched.append((p, off))
        expected = set()
        for p in range(parts):
            expected.update((p, o)
                            for o in range(live.end_offset(IN_TOPIC, p)))
        seen = [(p, o) for p, o, _v in consumed]
        dupes = len(seen) - len(set(seen))
        missing = expected - set(seen)
        healed = healed_rid is not None and \
            healed_rid in rs.state.isr_follower_ids()
        no_loss = killed_leader and not lost and not mismatched
        invariants = [
            _check_commits_monotonic(commit_log),
            Invariant(
                "zero_acked_loss", no_loss,
                (f"all {len(acked)} acked records present "
                 f"byte-identically at identical offsets after the "
                 f"double fault" if no_loss else
                 "leader was never killed" if not killed_leader else
                 f"{len(lost)} ACKED RECORDS LOST "
                 f"(e.g. {lost[:3]}), {len(mismatched)} mismatched")),
            Invariant(
                "new_leader_in_isr",
                promoted_rid is not None and promoted_rid in isr_at_kill,
                f"promoted replica {promoted_rid} was in the ISR "
                f"{isr_at_kill} at the kill" if promoted_rid is not None
                else "no promotion happened"),
            Invariant(
                "double_fault_injected",
                killed_follower is not None and killed_leader,
                f"follower {killed_follower} and the leader both died"
                if killed_follower is not None and killed_leader else
                "both faults must fire"),
            Invariant(
                "consumer_exact_once",
                not missing and dupes == 0,
                f"{len(seen)} consumed rows cover all "
                f"{len(expected)} log records exactly once"
                if not missing and dupes == 0 else
                f"{len(missing)} never consumed, {dupes} duplicated"),
            Invariant(
                "quorum_healed", healed,
                f"replica {healed_rid} bootstrapped from the promoted "
                f"leader and re-joined the ISR (raw-mirrored "
                f"{rs.followers[healed_rid].raw_mirrored} records)"
                if healed else "the elastic heal never completed"),
        ]
        return self._report(eng, "replication", published, len(consumed),
                            rewinds, invariants)

    # ------------------------------------------------------------ wire
    def _run_wire(self, eng: faults.ChaosEngine) -> ChaosReport:
        """leader-kill-mid-drain: a leader and a serving follower over the
        Kafka wire; at the scheduled count replication drains to zero lag
        and the leader dies; the clients fail over to the follower, which
        serves the end state."""
        from ..core.schema import KSQL_CAR_SCHEMA
        from ..gen.simulator import FleetGenerator, FleetScenario
        from ..ops.avro import AvroCodec
        from ..ops.framing import frame
        from ..stream.broker import Broker
        from ..stream.consumer import StreamConsumer
        from ..stream.kafka_wire import KafkaWireBroker, KafkaWireServer
        from ..stream.replica import FollowerReplica

        leader = Broker()
        commit_log: List[tuple] = []
        _record_commits(leader, commit_log, "leader")
        lsrv = KafkaWireServer(leader).start()
        rep = FollowerReplica(f"127.0.0.1:{lsrv.port}",
                              topics=[IN_TOPIC, PRED_TOPIC],
                              groups=(GROUP,))
        _record_commits(rep.local, commit_log, "follower")
        # the follower serves from the start, but its sync loop is
        # stepped by this thread: determinism over realism
        rep.server.start()
        bootstrap = f"127.0.0.1:{lsrv.port},127.0.0.1:{rep.port}"
        producer = KafkaWireBroker(bootstrap, client_id="chaos-devsim")
        consumer_client = KafkaWireBroker(bootstrap,
                                          client_id="chaos-scorer")
        parts = 2
        producer.create_topic(IN_TOPIC, partitions=parts)
        producer.create_topic(PRED_TOPIC, partitions=1)
        consumer = StreamConsumer(
            consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
            group=GROUP)
        scorer = self._make_scorer(producer, consumer)

        gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK,
                                           seed=self.schedule.seed))
        codec = AvroCodec(KSQL_CAR_SCHEMA)
        published = rewinds = 0
        killed = False
        promotion: Optional[Tuple[int, int]] = None

        def run_due_events():
            nonlocal killed, promotion
            for ev in eng.due_runner_events(published):
                if ev.action == "kill_leader" and not killed:
                    # a deterministic failover: drain replication to zero
                    # lag (a direct sync mirrors the commit tables too),
                    # measure the loss window, then die abruptly
                    while rep.sync_once() > 0:
                        pass
                    lag = sum(rep.lag().values())
                    tail = sum(
                        leader.end_offset(t, p) - rep.local.end_offset(t, p)
                        for t in (IN_TOPIC, PRED_TOPIC)
                        for p in range(leader.topic(t).partitions))
                    promotion = (lag, tail)
                    lsrv.kill()
                    killed = True
                    eng.note_runner_fired(ev)

        def drive_once():
            nonlocal rewinds
            try:
                return scorer.score_available()
            except ConnectionError:
                consumer.rewind_to_committed()
                rewinds += 1
                return -1

        try:
            for _ in range(self._ticks()):
                run_due_events()
                cols = gen.step_columns()
                entries = [
                    (gen.scenario.car_id(i).encode(),
                     frame(codec.encode(
                         gen.row_record(cols, i, KSQL_CAR_SCHEMA))), 0)
                    for i in range(len(cols["car"]))]
                for attempt in range(3):
                    try:
                        producer.produce_many(IN_TOPIC, entries)
                        break
                    except ConnectionError:
                        # the client has already failed over: redeliver to
                        # the promoted follower.  Kills land between ticks,
                        # so the dead leader cannot have applied the batch
                        if attempt == 2:
                            raise
                published += len(entries)
                if not killed:
                    rep.sync_once()
                drive_once()
            run_due_events()
            for _ in range(64):
                n = drive_once()
                if n == 0 and consumer.at_end():
                    break
        finally:
            for client in (producer, consumer_client):
                try:
                    client.close()
                except OSError:
                    pass
            rep.stop()
            if not killed:
                lsrv.kill()

        live = rep.local  # the promoted broker serves the end state
        lag, tail = promotion if promotion is not None else (-1, -1)
        bounded = killed and 0 <= tail <= max(lag, 0)
        invariants = [
            _check_counts(published, scorer.scored, eng.dropped_count),
            _check_commits_monotonic(commit_log),
            _check_predictions(live, scorer.scored),
            _check_final_commit(live, IN_TOPIC, parts),
            Invariant(
                "promotion_loss_bounded", bounded,
                ("leader was never killed" if not killed else
                 f"unreplicated tail at leader death: {tail} records "
                 f"within the measured lag {lag} (the runner's "
                 f"sync-before-kill drives both to zero)"
                 if bounded else
                 f"unreplicated tail at leader death: {tail} records "
                 f"EXCEEDS the measured lag {lag} — records the "
                 f"promoted follower never saw")),
        ]
        return self._report(eng, "wire", published, scorer.scored,
                            rewinds, invariants)

    # --------------------------------------------------------- cluster
    def _run_cluster(self, eng: faults.ChaosEngine) -> ChaosReport:
        """Rebalance-under-chaos on a partitioned 3-broker cluster.

        Three group members score a 6-partition topic through routed
        ``ClusterClient``s (the group protocol pinned to the coordinator
        broker).  Mid-epoch a member is killed (a crash: it stops
        polling and never leaves; the coordinator expires it and the
        survivors inherit its partitions at the committed frontier),
        then a shard LEADER is killed once replication has drained to
        zero lag and its follower is promoted at a bumped epoch (one
        shard's map entry moves).  The proof is exact-once by record
        identity: the (partition, offset) pairs scored across all members
        equal the records in the logs (zero lost, zero double-scored),
        with monotonic commits and the evidence that both failures
        happened."""
        from ..cluster import ClusterController
        from ..stream.group import GroupConsumer
        from ..stream.kafka_wire import RemoteGroupCoordinator

        n_parts, n_members = 6, 3
        # a non-coordinator shard: here the GROUP must survive both kills
        victim_shard = 2
        ctl = ClusterController(brokers=3, replicated=True,
                                replica_sync="manual",
                                mirror_groups=(GROUP,))
        ctl.start()
        commit_log: List[tuple] = []
        # group commits land on the coordinator broker (shard 0), fenced
        # through its GroupCoordinator
        _record_commits(ctl.brokers[0], commit_log, "coordinator")
        published = rewinds = 0
        scored: List[List[Tuple[int, int]]] = [[] for _ in range(n_members)]
        clients = []
        members: List[Optional[GroupConsumer]] = []
        killed_member: Optional[int] = None
        killed_shard = False
        try:
            ctl.create_topic(IN_TOPIC, partitions=n_parts)
            ctl.create_topic(PRED_TOPIC, partitions=n_members)
            producer = ctl.client(client_id="chaos-cluster-producer")
            clients.append(producer)
            for m in range(n_members):
                c = ctl.client(client_id=f"chaos-cluster-m{m}")
                clients.append(c)
                coord = RemoteGroupCoordinator(c, GROUP,
                                               session_timeout_ms=1500)
                members.append(GroupConsumer(coord, [IN_TOPIC]))

            def drive_member(m: int) -> int:
                nonlocal rewinds
                gc = members[m]
                if gc is None:
                    return 0
                try:
                    batch = gc.poll(4096)
                    if not batch:
                        return 0
                    for msg in batch:
                        scored[m].append((msg.partition, msg.offset))
                        clients[m + 1].produce(
                            PRED_TOPIC,
                            f"{msg.partition}:{msg.offset}".encode(),
                            key=msg.key, partition=m)
                    # commit AFTER scoring the whole poll: the committed
                    # frontier is the scored one, so an inheritor never
                    # scores a record again
                    gc.commit()
                    return len(batch)
                except ConnectionError:
                    gc.rewind_to_committed()
                    rewinds += 1
                    return 0

            def run_due_events():
                nonlocal killed_member, killed_shard
                for ev in eng.due_runner_events(published):
                    if ev.action == "kill_member" and killed_member is None:
                        # a crash, not a leave: the last member stops
                        # polling
                        killed_member = n_members - 1
                        members[killed_member] = None
                        eng.note_runner_fired(ev)
                    elif ev.action == "kill_shard_leader" \
                            and not killed_shard:
                        # the zero-lag handoff: drain replication, then
                        # kill the leader and promote its follower
                        while ctl.sync_replicas_once() > 0:
                            pass
                        ctl.fail_shard(victim_shard)
                        killed_shard = True
                        eng.note_runner_fired(ev)

            def produce_tick(tick: int) -> int:
                entries = [(f"car_{tick}_{i}".encode(),
                            f"r{tick}:{i}".encode(), 0)
                           for i in range(CARS_PER_TICK)]
                for attempt in range(3):
                    try:
                        producer.produce_many(IN_TOPIC, entries)
                        return len(entries)
                    except ConnectionError:
                        # kills land between ticks: the dead broker cannot
                        # have applied this batch, so it is redelivered
                        if attempt == 2:
                            raise
                return 0

            for tick in range(self._ticks()):
                run_due_events()
                published += produce_tick(tick)
                if not killed_shard:
                    ctl.sync_replicas_once()
                for m in range(n_members):
                    drive_member(m)
            run_due_events()
            # the final drain outlasts the dead member's session timeout,
            # so the survivors inherit and finish its partitions
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                moved = sum(drive_member(m) for m in range(n_members))
                live = [gc for gc in members if gc is not None]
                if not moved and all(gc.at_end() for gc in live):
                    # at_end is trusted once every partition is assigned
                    # to a survivor (the dead member's move at expiry)
                    assigned = set()
                    for gc in live:
                        assigned.update(gc.assignment)
                    if assigned == {(IN_TOPIC, p) for p in range(n_parts)}:
                        break
                time.sleep(0.05)
        finally:
            for c in clients:
                try:
                    c.close()
                except OSError:
                    pass
            ctl.stop()

        # exact-once over record identities: everything in the logs, once
        # each, across all members
        expected = set()
        for p in range(n_parts):
            end = ctl.serving[ctl.pmap.shard_for(IN_TOPIC, p)] \
                .end_offset(IN_TOPIC, p)
            expected.update((p, o) for o in range(end))
        flat = [ident for member in scored for ident in member]
        dupes = len(flat) - len(set(flat))
        missing = expected - set(flat)
        extra = set(flat) - expected
        total_scored = len(flat)
        invariants = [
            _check_counts(published, total_scored, eng.dropped_count),
            _check_commits_monotonic(commit_log),
            Invariant(
                "zero_records_lost", not missing and not extra,
                f"all {len(expected)} log records scored"
                if not missing and not extra else
                f"{len(missing)} records NEVER SCORED "
                f"(e.g. {sorted(missing)[:3]}); {len(extra)} phantom"),
            Invariant(
                "zero_double_scored", dupes == 0,
                f"{total_scored} scores over {len(set(flat))} unique "
                f"records" + ("" if dupes == 0 else
                              f"; {dupes} DOUBLE-SCORED")),
            Invariant(
                "member_death_rebalanced",
                killed_member is not None and any(
                    gc is not None and gc.rebalances > 0
                    for gc in members),
                "survivors rebalanced and inherited the dead member's "
                "partitions" if killed_member is not None else
                "member was never killed"),
            Invariant(
                "shard_failover_one_shard_only",
                killed_shard and ctl.pmap.epoch(victim_shard) == 1
                and all(ctl.pmap.epoch(s) == 0 for s in range(3)
                        if s != victim_shard),
                f"shard {victim_shard} at epoch "
                f"{ctl.pmap.epoch(victim_shard)}, every other shard "
                f"untouched at epoch 0" if killed_shard else
                "shard leader was never killed"),
        ]
        return self._report(eng, "cluster", published, total_scored,
                            rewinds, invariants)
