"""Fault points and the injection engine (``iotml.chaos.faults``'s twin).

A fault point is a named site in a hot path, one ``chaos.point("name")``
call.  Disarmed (the default) the call reads one module global and
returns None: no allocation, no lock.

Armed, the engine counts every traversal of every point and fires the
scheduled action when a site's hit count enters an event's window:

- ``error`` raises (ConnectionError / OSError / RuntimeError by name):
  a simulated crash, dead socket or unavailable partition;
- ``delay`` sleeps ``seconds``: a stall or slow link.

Site-specific actions (``drop``, ``dup``, ``short_write``, ``skip``) are
returned to the call site.  A ``drop`` is booked in the engine's
intentional-loss ledger (count and, under tracing, the trace id) unless
the event marks it unaccounted.

Arming: ``arm(ChaosEngine(events))`` in-process, with events of
``FaultEvent``'s shape, or ``IOTML_CHAOS=1`` with ``IOTML_CHAOS_SCENARIO``
/ ``_SEED`` / ``_RECORDS`` for any process of the port: ``arm_from_env``
(run at import) builds the named schedule (``scenarios.build``) and arms
it.
"""

from __future__ import annotations

import os
import threading
import time
import dataclasses
import json
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

from ..obs import metrics as _metrics
from ..obs import tracing

#: every compiled-in injection site, name → what firing there means.
#: Scenarios are validated against this registry at engine build time so
#: a typo'd faultpoint fails loudly instead of silently never firing.
KNOWN_POINTS: Dict[str, str] = {
    "kafka_wire.send": "wire-client socket send: drop connection (error), "
                       "delay, short_write",
    "kafka_wire.recv": "wire-client socket recv: drop connection (error), "
                       "delay",
    "broker.produce": "broker append path: produce error, delay",
    "broker.produce_raw": "RAW_PRODUCE pre-framed batch landing: corrupt "
                          "(flip a byte in the in-flight batch — the "
                          "whole batch must be rejected with "
                          "CORRUPT_MESSAGE before any byte lands), "
                          "error, delay",
    "broker.fetch": "broker fetch path: stall (delay), partition "
                    "unavailable (error)",
    "replica.sync": "follower replication round: pause (delay), skip",
    "mqtt.deliver": "MQTT fan-out delivery: drop, dup, delay",
    "scorer.poll": "scorer drain loop: stall (delay), simulated crash "
                   "(error -> rewind-to-committed redelivery)",
    "trainer.poll": "continuous-trainer poll loop: stall (delay), error",
    "ckpt.write": "checkpoint writer, between serialize and the atomic "
                  "registry publication: crash (error) = killed "
                  "mid-checkpoint with host state gone, registry "
                  "untouched; delay = slow disk (drop-oldest backlog)",
    "registry.commit": "registry publish, between artifact staging and "
                       "the manifest write: crash (error) leaves a "
                       "manifest-less (torn) version dir that readers "
                       "skip and recover() sweeps",
    "store.compact_swap": "segment compaction, between the durable "
                          ".cleaned rewrite and its atomic swap over the "
                          "live segment: crash (error) = compactor killed "
                          "mid-pass (stale tmp left, live segment intact, "
                          "a prefix of segments already swapped); delay = "
                          "slow disk",
    "online.update": "online learner's per-window update loop: stall "
                     "(delay) = a slow incremental step, crash (error) "
                     "= the learner dies mid-stream and must resume "
                     "from its committed cursor",
    "store.tier_upload": "tiered-store upload, between the segment blob "
                         "uploads and the remote manifest commit: crash "
                         "(error) = uploader killed mid-upload, leaving "
                         "staged blobs the manifest never references "
                         "(swept later, never served); delay = slow "
                         "object store",
}

#: runner-orchestrated pseudo-points: process-level acts (killing a wire
#: server is not an inline code path) scheduled by published-record
#: count and executed by the chaos runner between ticks.
RUNNER_POINTS: Dict[str, str] = {
    "runner.kill_leader": "abrupt leader wire-server death (accept loop "
                          "+ every live connection) -> client failover "
                          "promotes the follower",
    "runner.crash_broker": "durable broker process death MID-WRITE (torn "
                           "frame left on the active segment) -> remount "
                           "from the store dir, recovery truncates the "
                           "tail, consumers resume from persisted commits",
    "runner.kill_member": "consumer-group member crash (stops polling, "
                          "never leaves) -> coordinator expires it at "
                          "session timeout, survivors inherit its "
                          "partitions at the committed frontier",
    "runner.kill_shard_leader": "abrupt SHARD leader death on the "
                                "partitioned cluster -> its follower is "
                                "promoted at a bumped epoch; one map "
                                "entry moves, the rest keep serving",
    "runner.kill_follower": "abrupt ISR follower death under acks=all "
                            "load -> the ISR evicts it within the "
                            "staleness window and the quorum re-forms "
                            "without it",
}

#: actions each site actually interprets — validated at engine build so
#: a typo'd action fails as loudly as a typo'd faultpoint (it would
#: otherwise count as injected while doing nothing, a lying report).
POINT_ACTIONS: Dict[str, frozenset] = {
    "kafka_wire.send": frozenset({"error", "delay", "short_write"}),
    "kafka_wire.recv": frozenset({"error", "delay"}),
    "broker.produce": frozenset({"error", "delay"}),
    "broker.produce_raw": frozenset({"corrupt", "error", "delay"}),
    "broker.fetch": frozenset({"error", "delay"}),
    "replica.sync": frozenset({"skip", "delay", "error"}),
    "mqtt.deliver": frozenset({"drop", "dup", "delay"}),
    "scorer.poll": frozenset({"error", "delay"}),
    "trainer.poll": frozenset({"error", "delay"}),
    "ckpt.write": frozenset({"error", "delay"}),
    "registry.commit": frozenset({"error", "delay"}),
    "store.compact_swap": frozenset({"error", "delay"}),
    "store.tier_upload": frozenset({"error", "delay"}),
    "online.update": frozenset({"error", "delay"}),
    "runner.kill_leader": frozenset({"kill_leader"}),
    "runner.crash_broker": frozenset({"crash_broker"}),
    "runner.kill_member": frozenset({"kill_member"}),
    "runner.kill_shard_leader": frozenset({"kill_shard_leader"}),
    "runner.kill_follower": frozenset({"kill_follower"}),
}

_EXCEPTIONS = {"ConnectionError": ConnectionError, "OSError": OSError,
               "RuntimeError": RuntimeError}

chaos_injected = _metrics.default_registry.counter(
    "iotml_chaos_injected_total",
    "faults injected by the chaos engine (label fault=point:action)")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire `action` at the `at`-th traversal of
    `point` (1-based), covering `repeat` consecutive traversals.  For
    runner pseudo-points `at` is a published-record count."""

    at: int
    point: str
    action: str
    params: Tuple[Tuple[str, object], ...] = ()
    repeat: int = 1

    def line(self) -> str:
        """Canonical text form — what byte-identical schedules diff."""
        p = json.dumps(dict(self.params), sort_keys=True,
                       separators=(",", ":"))
        return f"{self.at:>8} x{self.repeat:<4} {self.point} " \
               f"{self.action} {p}"


class Action(NamedTuple):
    """A fired fault handed back to its call site."""

    kind: str
    params: dict


class ChaosEngine:
    """Hit-counting fault scheduler over a compiled scenario.

    Thread-safe: hit counters and ledgers mutate under one lock; the
    blocking/raising part of an action is applied AFTER the lock is
    released (a chaos delay must stall the faulted path, never every
    thread traversing any faultpoint)."""

    def __init__(self, events):
        self._lock = threading.Lock()
        self._windows: Dict[str, List[tuple]] = {}
        self.runner_events: List = []
        for ev in sorted(events, key=lambda e: (e.at, e.point, e.action)):
            if ev.point not in POINT_ACTIONS:
                raise ValueError(
                    f"unknown faultpoint {ev.point!r} (known: "
                    f"{sorted(KNOWN_POINTS) + sorted(RUNNER_POINTS)})")
            if ev.action not in POINT_ACTIONS[ev.point]:
                raise ValueError(
                    f"faultpoint {ev.point!r} does not interpret action "
                    f"{ev.action!r} (supported: "
                    f"{sorted(POINT_ACTIONS[ev.point])})")
            exc = dict(ev.params).get("exc")
            if exc is not None and exc not in _EXCEPTIONS:
                raise ValueError(
                    f"unknown exception {exc!r} for {ev.point} "
                    f"(have: {sorted(_EXCEPTIONS)})")
            if ev.point in RUNNER_POINTS:
                self.runner_events.append(ev)
            else:
                self._windows.setdefault(ev.point, []).append(
                    (ev.at, ev.at + max(ev.repeat, 1), ev))
        # at most ONE non-delay event may cover any given hit: a call
        # site consumes a single action, so overlapping site-level
        # events would count as injected without executing — the
        # diverging-report lie this engine exists to rule out.  Delays
        # compose with anything (they apply inline, cumulatively).
        for point, windows in self._windows.items():
            hard = sorted(((lo, hi, ev) for lo, hi, ev in windows
                           if ev.action != "delay"),
                          key=lambda w: (w[0], w[1]))
            for (alo, ahi, aev), (blo, bhi, bev) in zip(hard, hard[1:]):
                if blo < ahi:
                    raise ValueError(
                        f"overlapping non-delay events on {point!r}: "
                        f"{aev.action}@[{alo},{ahi}) and "
                        f"{bev.action}@[{blo},{bhi}) — only one "
                        f"site-level action can execute per hit")
        self.hits: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}
        self.dropped_count = 0
        self.dropped_traces: Set[int] = set()

    # ----------------------------------------------------------- firing
    def fire(self, name: str) -> Optional[Action]:
        """EVERY event whose window covers this hit fires — a drop
        scheduled inside a delay window both delays and drops.  The
        canonical schedule is ground truth: what it lists must be what
        runs, or the byte-identical replay guarantee is a lie."""
        matched = []
        with self._lock:
            hit = self.hits.get(name, 0) + 1
            self.hits[name] = hit
            for lo, hi, ev in self._windows.get(name, ()):
                if lo <= hit < hi:
                    matched.append(ev)
            if not matched:
                return None
            for ev in matched:
                label = f"{name}:{ev.action}"
                self.injected[label] = self.injected.get(label, 0) + 1
                if ev.action == "drop" and \
                        dict(ev.params).get("account", True):
                    # intentional loss: ledger it so the invariant
                    # checker can tell "chaos ate it" from "the
                    # pipeline lost it"
                    self.dropped_count += 1
                    ctx = tracing.current()
                    if ctx is not None:
                        self.dropped_traces.add(ctx.trace_id)
        # blocking/raising OUTSIDE the engine lock: delays apply first
        # (cumulatively), then the at-most-one (build-validated)
        # non-delay event raises or is returned to the call site
        site: Optional[Action] = None
        err = None
        for ev in matched:
            chaos_injected.inc(fault=f"{name}:{ev.action}")
            params = dict(ev.params)
            if ev.action == "delay":
                time.sleep(float(params.get("seconds", 0.001)))
            elif ev.action == "error":
                err = _EXCEPTIONS.get(params.get("exc", "ConnectionError"),
                                      ConnectionError)
            else:
                site = Action(ev.action, params)
        if err is not None:
            raise err(f"chaos[{name}]: injected fault")
        return site

    def due_runner_events(self, records_published: int) -> List:
        """Pop runner-orchestrated events whose record count has come."""
        with self._lock:
            due = [e for e in self.runner_events
                   if e.at <= records_published]
            self.runner_events = [e for e in self.runner_events
                                  if e.at > records_published]
        return due

    def note_runner_fired(self, ev) -> None:
        """Count a runner-orchestrated event as injected — the runner,
        not a faultpoint shim, executes process-level actions."""
        label = f"{ev.point}:{ev.action}"
        with self._lock:
            self.injected[label] = self.injected.get(label, 0) + 1
        chaos_injected.inc(fault=label)


#: the armed engine, or None.  Module-global read is the entire
#: disarmed faultpoint cost.
_engine: Optional[ChaosEngine] = None


def point(name: str) -> Optional[Action]:
    """The faultpoint shim compiled into hot paths."""
    eng = _engine
    if eng is None:
        return None
    return eng.fire(name)


def engine() -> Optional[ChaosEngine]:
    return _engine


def arm(eng: ChaosEngine) -> ChaosEngine:
    global _engine
    _engine = eng
    return eng


def disarm() -> None:
    global _engine
    _engine = None


def arm_from_env(env: Optional[dict] = None) -> Optional[ChaosEngine]:
    """Arm from ``IOTML_CHAOS`` / ``IOTML_CHAOS_{SCENARIO,SEED,RECORDS}``:
    a no-op unless ``IOTML_CHAOS`` is truthy, so a normal process pays
    one environment read."""
    env = os.environ if env is None else env
    # only an explicit opt-in arms: IOTML_CHAOS=false/no/off disables
    if env.get("IOTML_CHAOS", "").strip().lower() not in \
            ("1", "true", "yes", "on"):
        return None
    from .scenarios import build  # never loaded while disarmed

    schedule = build(env.get("IOTML_CHAOS_SCENARIO", "mqtt-flap"),
                     seed=int(env.get("IOTML_CHAOS_SEED", "7")),
                     records=int(env.get("IOTML_CHAOS_RECORDS", "1000")))
    return arm(ChaosEngine(schedule.events))


arm_from_env()
