"""Seeded, declarative fault schedules — replayable bit-for-bit
(``iotml.chaos.scenarios``'s copy: every schedule of its table, the same
canonical text).

A scenario is a *builder*: ``(random.Random(seed), records) -> events``.
Events are expressed in deterministic counters only — the Nth traversal
of a faultpoint (``at`` = hit index, optionally covering ``repeat``
consecutive hits) or, for runner-orchestrated pseudo-points, the Nth
published record.  No wall clock anywhere: the same (scenario, seed,
records) triple always compiles to the byte-identical schedule
(``Schedule.text()`` is the canonical form CI diffs), which is the same
reproducibility discipline the data-pipeline literature applies to
training input (PAPERS.md: a run you can't replay is a run you can't
debug).

Built-ins:

- ``leader-kill-mid-drain`` (wire): the follower syncs, the leader
  wire-server dies abruptly mid-stream, clients fail over.
- ``mqtt-flap``: flapping device links — seeded MQTT delivery drops
  (accounted as intentional loss) plus short delay bursts.
- ``slow-bridge``: sustained delay windows on the MQTT→stream hop.
- ``dup-storm``: duplicate deliveries — at-least-once must absorb them.
- ``partition-blackout``: a window of consecutive broker fetches fails
  with ConnectionError (partition unavailable) and must be retried
  through.
- ``scorer-crash-resume``: the scorer's drain loop dies mid-stream and
  must resume via rewind-to-committed redelivery.
- ``loss-bug-fixture``: a seeded SILENT drop (not ledgered) — exists so
  tests can prove the invariant checker actually fails on real loss.
- ``broker-crash-recover`` (store): the durable broker dies mid-write
  (torn frame on the active segment); remount recovers, acked records
  re-serve, consumers resume from their persisted committed offsets.
- ``rebalance-under-chaos`` (cluster): on a 3-broker partitioned
  cluster, a consumer-group member dies mid-epoch and then a shard
  leader dies mid-epoch; the runner proves every produced record was
  scored exactly once (zero lost, zero double-scored) across the
  rebalance and the per-shard failover.
- ``compaction-under-crash`` (store): the segment compactor is killed
  at a mid-pass swap on the twin's compacted changelog (durable
  ``.cleaned`` rewrite written, live segment not yet replaced); the
  remount must sweep the tmp, lose no key, serve byte-identical
  compacted reads, and a finished pass must stay byte-stable across a
  second remount.
- ``tier-upload-crash`` (store): the tier uploader is killed between
  the segment blob uploads and the remote manifest commit (staged
  blobs exist, nothing references them); remount + a cold reader over
  the remote tier must never serve the torn upload, local bytes stay
  authoritative, and the finished re-upload must replay byte-identical
  through the remote leg.
- ``trainer-crash-mid-checkpoint`` (mlops): the checkpoint writer dies
  inside a registry publication (torn version dir left behind); a
  restarted trainer must resume model + stream offsets from the last
  durable manifest with the torn state swept, never served.
- ``rollout-regression-rollback`` (mlops): a deliberately degraded
  candidate model is deployed to serving; the A/B quality gate must
  detect the live regression and roll serving back to the baseline.
- ``drift-storm`` (online): seeded regional drift and flapping device
  links CONCURRENTLY — the online learner must detect the drift on
  its error signal, adapt and converge, the adapted model must
  hot-swap the scorer fleet through the registry, and no record may
  be lost or double-scored across the swap.
- ``alert-burn`` (obs): sustained slow-bridge degradation under live
  synthetic canaries; the SLO engine's fast burn-rate pair must fire,
  land in ``_IOTML_ALERTS`` + ``/healthz``, and resolve on recovery.

``runner.ChaosRunner`` drives every topology; ``alert-burn`` runs through
``obs.drill.drill_alert_burn``, and any
schedule arms in-process (``faults.arm(ChaosEngine(events))``) or from
the environment (``faults.arm_from_env``).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, Dict, List, Tuple

from .faults import FaultEvent

#: fleet size per simulator tick — shared with the runner so builders
#: can reason in ticks (records / CARS_PER_TICK) when a faultpoint is
#: hit once per tick (scorer.poll) rather than once per record.
CARS_PER_TICK = 25


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str
    seed: int
    records: int
    topology: str  # "inproc" | "wire" | "store" | "cluster"
    events: Tuple[FaultEvent, ...]

    def lines(self) -> List[str]:
        head = [f"# scenario={self.name} seed={self.seed} "
                f"records={self.records} topology={self.topology}"]
        return head + [e.line() for e in self.events]

    def text(self) -> str:
        return "\n".join(self.lines()) + "\n"


# ------------------------------------------------------------- builders
def _leader_kill(rng: random.Random, records: int) -> list:
    lo, hi = max(1, records // 3), max(2, (2 * records) // 3)
    events = [FaultEvent(rng.randint(lo, hi), "runner.kill_leader",
                         "kill_leader")]
    # flavor: a few slow client recvs around the failover window
    for _ in range(3):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "kafka_wire.recv", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _mqtt_flap(rng: random.Random, records: int) -> list:
    n_drops = max(2, records // 100)
    hits = sorted(rng.sample(range(1, records + 1),
                             min(n_drops, records)))
    events = [FaultEvent(h, "mqtt.deliver", "drop") for h in hits]
    for _ in range(2):  # short link stalls riding along
        events.append(FaultEvent(rng.randint(1, max(2, records - 10)),
                                 "mqtt.deliver", "delay",
                                 params=(("seconds", 0.001),), repeat=5))
    return events


def _slow_bridge(rng: random.Random, records: int) -> list:
    events = []
    at = 1
    for _ in range(3):
        at = rng.randint(at, max(at + 1, min(records, at + records // 3)))
        win = rng.randint(10, 30)
        events.append(FaultEvent(at, "mqtt.deliver", "delay",
                                 params=(("seconds", 0.002),), repeat=win))
        at += win + 1
    return events


def _dup_storm(rng: random.Random, records: int) -> list:
    n = max(5, records // 50)
    hits = sorted(rng.sample(range(1, records + 1), min(n, records)))
    return [FaultEvent(h, "mqtt.deliver", "dup") for h in hits]


def _partition_blackout(rng: random.Random, records: int) -> list:
    # a contiguous window of broker fetches fails (fetch hits accrue
    # fast: every poll round fetches each partition)
    at = rng.randint(5, 40)
    return [FaultEvent(at, "broker.fetch", "error",
                       params=(("exc", "ConnectionError"),),
                       repeat=rng.randint(6, 12))]


def _scorer_crash_resume(rng: random.Random, records: int) -> list:
    # scorer.poll is hit once per drain chunk (~once per tick)
    ticks = max(4, records // CARS_PER_TICK)
    h1 = rng.randint(2, max(3, ticks // 2))
    h2 = h1 + rng.randint(2, max(3, ticks // 2))
    return [FaultEvent(h1, "scorer.poll", "error"),
            FaultEvent(h2, "scorer.poll", "error")]


def _broker_crash_recover(rng: random.Random, records: int) -> list:
    # the durable broker dies MID-WRITE somewhere in the middle third of
    # the stream (torn frame on the active segment); the runner remounts
    # from disk and the restarted pipeline must finish the stream with
    # every pre-crash acked record re-served.  A couple of fetch stalls
    # ride along so recovery is proven under an unquiet consumer.
    lo, hi = max(1, records // 3), max(2, (2 * records) // 3)
    events = [FaultEvent(rng.randint(lo, hi), "runner.crash_broker",
                         "crash_broker")]
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "broker.fetch", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _compaction_under_crash(rng: random.Random, records: int) -> list:
    # the compactor dies at its Nth segment SWAP: the .cleaned rewrite
    # is durable, the live segment still holds the old bytes, and a
    # prefix of earlier segments already swapped — the worst mid-pass
    # shape.  The runner remounts and proves no key lost + byte-stable
    # compacted reads.  A couple of fetch stalls ride along so the
    # pre-kill reads happen under an unquiet consumer.
    events = [FaultEvent(rng.randint(1, 3), "store.compact_swap", "error",
                         params=(("exc", "RuntimeError"),))]
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "broker.fetch", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _tier_upload_crash(rng: random.Random, records: int) -> list:
    # the tier uploader dies BETWEEN the segment blob uploads and the
    # remote manifest commit — staged blobs exist remotely but nothing
    # references them, the worst mid-upload shape.  The runner remounts
    # (local AND a fresh cold reader against the remote tier) and
    # proves the torn upload is never served, local bytes stayed
    # authoritative, and the finished re-upload replays byte-identical
    # through the remote leg.  A couple of fetch stalls ride along so
    # pre-kill reads happen under an unquiet consumer.
    events = [FaultEvent(rng.randint(1, 3), "store.tier_upload", "error",
                         params=(("exc", "RuntimeError"),))]
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "broker.fetch", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _rebalance_under_chaos(rng: random.Random, records: int) -> list:
    # the cluster drill: a consumer-group member dies mid-epoch, then a
    # SHARD leader dies mid-epoch (after the member's rebalance window
    # opens) — the runner asserts every produced record is scored
    # EXACTLY once across both: survivors inherit the dead member's
    # partitions at its committed frontier, and the promoted shard
    # follower serves identical offsets.  A few wire recv delays ride
    # along so routing retries happen under an unquiet clock.
    lo, hi = max(1, records // 3), max(2, (2 * records) // 3)
    mid = (lo + hi) // 2
    events = [
        FaultEvent(rng.randint(lo, max(lo + 1, mid)),
                   "runner.kill_member", "kill_member"),
        FaultEvent(rng.randint(mid + 1, max(mid + 2, hi)),
                   "runner.kill_shard_leader", "kill_shard_leader"),
    ]
    for _ in range(3):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "kafka_wire.recv", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _trainer_crash_mid_checkpoint(rng: random.Random, records: int) -> list:
    # the continuous trainer's checkpoint writer dies INSIDE a registry
    # publication — after the artifacts became visible, before the
    # manifest (the commit marker) landed.  That is the worst spot: a
    # naive registry would serve the torn version.  The runner then
    # "restarts the process" (fresh registry mount + trainer warm start)
    # and proves: readers never saw the torn version, recover() swept
    # exactly it, and training resumed from the last DURABLE manifest's
    # stamped offsets — no gap, no double-train.  registry.commit is hit
    # once per publish (~one per ~50-record round in the runner), so the
    # crash lands on an early-but-not-first checkpoint.
    publishes = max(3, records // 60)
    crash_at = rng.randint(2, max(2, min(4, publishes - 1)))
    events = [FaultEvent(crash_at, "registry.commit", "error",
                         params=(("exc", "RuntimeError"),))]
    # slow-disk flavor on a couple of OTHER writes: serialize/fsync
    # stalls must degrade checkpoint freshness, never training
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, publishes)),
                                 "ckpt.write", "delay",
                                 params=(("seconds", 0.002),)))
    return events


def _rollout_regression_rollback(rng: random.Random, records: int) -> list:
    # no injected faults needed — the "failure" is a deliberately
    # degraded CANDIDATE MODEL deployed to serving (deploy-during-eval),
    # and the system under test is the A/B quality gate: it must detect
    # the regression from live scored quality and re-point serving at
    # the baseline within the drill budget.  A couple of scorer stalls
    # ride along so the gate decides under an unquiet clock.
    ticks = max(4, records // CARS_PER_TICK)
    events = []
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, ticks)),
                                 "scorer.poll", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _drift_storm(rng: random.Random, records: int) -> list:
    # seeded regional drift AND flapping device links CONCURRENTLY:
    # the drift itself is runner-topology state (an AdversarialFleet
    # with every cohort shifting at mid-stream, seeded by the schedule
    # seed); the schedule carries the mqtt-flap half — delivery drops
    # (accounted as intentional loss) plus short delay bursts landing
    # while the online learner is mid-adaptation.  The runner proves
    # the learner still detects, adapts, converges and publishes, the
    # scorer fleet hot-swaps, and no record is lost or double-scored
    # across the swap.
    n_drops = max(2, records // 100)
    hits = sorted(rng.sample(range(1, records + 1),
                             min(n_drops, records)))
    events = [FaultEvent(h, "mqtt.deliver", "drop") for h in hits]
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, records - 10)),
                                 "mqtt.deliver", "delay",
                                 params=(("seconds", 0.001),), repeat=5))
    return events


def _double_fault(rng: random.Random, records: int) -> list:
    # the quorum-durability drill: under sustained acks=all
    # load against a leader + two ISR followers, ONE FOLLOWER dies
    # abruptly (the ISR must evict it within the staleness window and
    # the quorum re-form at width 2), then the LEADER dies mid-epoch
    # with no pre-kill drain — the runner promotes an ISR member at
    # epoch+1 and proves ZERO acked-record loss byte-identically: every
    # produce acked before the kill sits below the quorum HWM, so the
    # surviving ISR member holds it at the identical offset.  A new
    # follower then bootstraps from the promoted leader (the elastic
    # heal) so acks=all resumes for the rest of the stream.  Wire recv
    # delays ride along so failover retries run under an unquiet clock.
    lo, hi = max(1, records // 3), max(2, (2 * records) // 3)
    mid = (lo + hi) // 2
    events = [
        FaultEvent(rng.randint(lo, max(lo + 1, mid)),
                   "runner.kill_follower", "kill_follower"),
        FaultEvent(rng.randint(mid + 1, max(mid + 2, hi)),
                   "runner.kill_leader", "kill_leader"),
    ]
    for _ in range(3):
        events.append(FaultEvent(rng.randint(1, max(2, records // 20)),
                                 "kafka_wire.recv", "delay",
                                 params=(("seconds", 0.001),)))
    return events


def _alert_burn(rng: random.Random, records: int) -> list:
    # the telemetry-plane drill: a SUSTAINED slow-bridge
    # degradation — every MQTT delivery delayed well past the canary
    # latency SLO threshold — armed only for the drill's degraded
    # phase.  The system under test is the alerting loop itself: the
    # canary probes must measure the slowdown through the real path,
    # the TSDB must carry it, and the SLO engine's FAST burn-rate pair
    # must fire within the drill budget (then resolve after recovery).
    # A couple of accounted drops ride along so the delivery SLO sees
    # real loss too.
    # far past the drill SLO threshold (0.1 s) so the degraded e2e
    # separates cleanly from the healthy floor (~tens of ms of polling)
    delay_s = round(rng.uniform(0.35, 0.5), 3)
    events = [FaultEvent(1, "mqtt.deliver", "delay",
                         params=(("seconds", delay_s),),
                         repeat=1_000_000)]
    for _ in range(2):
        events.append(FaultEvent(rng.randint(1, max(2, records // 10)),
                                 "mqtt.deliver", "drop"))
    return events


def _loss_bug_fixture(rng: random.Random, records: int) -> list:
    # the seeded bug: one delivery silently lost — NOT ledgered, so the
    # scored-or-accounted invariant must fail (the checker's own test)
    at = rng.randint(2, max(3, records - 2))
    return [FaultEvent(at, "mqtt.deliver", "drop",
                       params=(("account", False),))]


#: name -> (builder, topology, description).  Topology is a static
#: property of each scenario (which runner harness drives it), not
#: something worth compiling a schedule to discover.
SCENARIOS: Dict[str, Tuple[Callable, str, str]] = {
    "leader-kill-mid-drain": (
        _leader_kill, "wire",
        "leader wire-server dies mid-stream; follower replica promoted "
        "via client failover"),
    "mqtt-flap": (
        _mqtt_flap, "inproc",
        "flapping device links: seeded MQTT delivery drops (accounted) "
        "+ delay bursts"),
    "slow-bridge": (
        _slow_bridge, "inproc",
        "sustained delay windows on the MQTT->stream hop"),
    "dup-storm": (
        _dup_storm, "inproc",
        "duplicate MQTT deliveries; at-least-once must absorb them"),
    "partition-blackout": (
        _partition_blackout, "inproc",
        "a window of broker fetches fails with ConnectionError; "
        "consumers retry through"),
    "scorer-crash-resume": (
        _scorer_crash_resume, "inproc",
        "scorer drain dies mid-stream; resumes via rewind-to-committed "
        "redelivery"),
    "loss-bug-fixture": (
        _loss_bug_fixture, "inproc",
        "SEEDED BUG: one silent (unledgered) drop — the invariant "
        "checker must FAIL on it"),
    "broker-crash-recover": (
        _broker_crash_recover, "store",
        "durable broker killed mid-write; remount recovers the torn "
        "tail, acked records re-serve, consumers resume from committed"),
    "compaction-under-crash": (
        _compaction_under_crash, "store",
        "segment compactor killed mid-swap on the compacted twin "
        "changelog; remount sweeps the tmp, loses no key, and compacted "
        "reads stay byte-stable across a second remount"),
    "tier-upload-crash": (
        _tier_upload_crash, "store",
        "tier uploader killed between segment blob uploads and the "
        "remote manifest commit; remount + cold remote reader prove no "
        "torn segment serves, local stays authoritative, and the "
        "finished re-upload replays byte-identical through the remote "
        "tier"),
    "rebalance-under-chaos": (
        _rebalance_under_chaos, "cluster",
        "3-broker cluster: a group member AND a shard leader die "
        "mid-epoch; every record scored exactly once across the "
        "rebalance + per-shard failover"),
    "trainer-crash-mid-checkpoint": (
        _trainer_crash_mid_checkpoint, "mlops",
        "checkpoint writer killed INSIDE a registry publication (torn "
        "version dir); restart resumes model+offsets from the last "
        "durable manifest — no torn state served, no gap, no "
        "double-train"),
    "rollout-regression-rollback": (
        _rollout_regression_rollback, "mlops",
        "a degraded candidate model is deployed to serving; the A/B "
        "quality gate must detect the regression live and roll serving "
        "back to the baseline within the drill budget"),
    "double-fault": (
        _double_fault, "replication",
        "leader + one follower die mid-epoch under sustained acks=all "
        "load: ISR evicts the dead follower, an ISR member is promoted "
        "at epoch+1 with ZERO acked-record loss (byte-identical "
        "offsets), a new follower heals the set and acks=all resumes"),
    "alert-burn": (
        _alert_burn, "obs",
        "sustained slow-bridge degradation under live canary probes: "
        "the e2e latency SLO's FAST burn-rate pair must fire within "
        "budget, land in _IOTML_ALERTS + /healthz, and resolve after "
        "recovery"),
    "drift-storm": (
        _drift_storm, "online",
        "seeded regional drift + flapping links concurrently: the "
        "online learner must detect and adapt, the adapted model must "
        "hot-swap the scorer fleet, and no record is lost or double-"
        "scored across the swap"),
}


def build(name: str, seed: int = 7, records: int = 1000) -> Schedule:
    """Compile a scenario into its deterministic schedule."""
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have: {sorted(SCENARIOS)})")
    if records < CARS_PER_TICK:
        raise ValueError(f"records must be >= {CARS_PER_TICK} "
                         f"(one fleet tick), got {records}")
    builder, topology, _ = SCENARIOS[name]
    events = builder(random.Random(seed), records)
    events = tuple(sorted(events, key=lambda e: (e.at, e.point, e.action)))
    return Schedule(name=name, seed=seed, records=records,
                    topology=topology, events=events)
