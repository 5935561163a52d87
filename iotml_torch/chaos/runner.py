"""The scenario runner and its invariant verdicts (``iotml.chaos.runner``'s
copy): ``ChaosRunner`` compiles a scenario's seeded schedule, arms it,
drives the pipeline under it single-threaded and returns a
``ChaosReport`` of invariant verdicts; the drills reuse the ``Invariant``
record, the commit-monotonicity check and its commit recorder.

Ported topology: ``cluster`` (``rebalance-under-chaos``: a consumer-group
member and a shard leader die mid-epoch on a 3-broker partitioned
cluster; every record is scored exactly once, by (partition, offset)).
The runner's other topologies (inproc, online, store, obs, mlops,
replication, wire) raise NotImplementedError naming ROADMAP A14; the
``alert-burn`` drill runs through ``obs.drill.drill_alert_burn``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

from . import faults, scenarios
from .scenarios import CARS_PER_TICK, Schedule

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


# --------------------------------------------------------------- runner
class ChaosRunner:
    """Compile a scenario, drive the pipeline under it, return the
    report.  Only the ``cluster`` topology is ported (it writes no span
    log: the JAX runner's ``span_path`` serves the other topologies)."""

    #: the ported topologies
    TOPOLOGIES = ("cluster",)

    def __init__(self, scenario: str, seed: int = 7, records: int = 1000):
        self.schedule: Schedule = scenarios.build(scenario, seed=seed,
                                                  records=records)

    def run(self) -> ChaosReport:
        topology = self.schedule.topology
        if topology not in self.TOPOLOGIES:
            raise NotImplementedError(
                f"chaos scenario {self.schedule.name!r}: the runner's "
                f"{topology!r} topology is not ported yet (ROADMAP A14); "
                f"ported: {', '.join(self.TOPOLOGIES)}")
        eng = faults.arm(faults.ChaosEngine(self.schedule.events))
        try:
            return self._run_cluster(eng)
        finally:
            faults.disarm()

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

            ticks = max(1, -(-self.schedule.records // CARS_PER_TICK))
            for tick in range(ticks):
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
        return ChaosReport(
            scenario=self.schedule.name, seed=self.schedule.seed,
            records=self.schedule.records, topology="cluster",
            published=published, scored=total_scored, rewinds=rewinds,
            dropped_accounted=eng.dropped_count,
            injected=dict(sorted(eng.injected.items())),
            invariants=invariants, span_path=None)
