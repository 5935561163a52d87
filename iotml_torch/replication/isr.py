"""Leader-side ISR tracking and the quorum high-water mark
(``iotml.replication.isr``'s copy).

Kafka's durability contract is primary-backup quorum commit: the leader
tracks which replicas are *in sync* (caught up to the log end within a
staleness window), and a record is **committed** once every ISR member
holds it, i.e. once it lies below ``min(ISR fetch positions)``, the
quorum high-water mark.  ``acks=all`` producers are acked there and
consumers may not read past it, so an acked record survives the death of
any ``|ISR| - 1`` replicas and a consumer never observes a record a
failover would un-write.

Positions: followers (``stream.replica.FollowerReplica``) stamp a
replica id on their FETCH and RAW_FETCH requests, and the wire server
hands each ``(replica, topic, partition, fetch offset)`` to
``observe_fetch``.  A fetch at offset *O* proves the follower holds every
record below *O* (its sync loop appends a batch before it advances the
cursor), Kafka's own HWM rule.

Membership:

- a follower starts OUT of the ISR and is **admitted** the first time
  its fetch position reaches the leader's log end;
- it is **evicted** when it has not reached the log end for
  ``max_lag_s`` (``replica.lag.time.max.ms``: time-based, so a slow but
  moving follower under a burst is not flapped out);
- it is **re-admitted** by the same catch-up rule; the quorum HWM is
  monotone through all of it.

The leader is always in the ISR: ``isr_size`` counts ``1 + in-sync
followers``, and an unreplicated topic is Kafka RF-1 (ISR = {leader},
quorum HWM = log end, ``acks=all`` is ``acks=1``).  The ISR set and the
quorum HWM have one owner, this module; the wire server only feeds
``observe_fetch`` and waits in ``wait_replicated``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from ..obs import metrics as obs_metrics

#: the bound on one acks=all wait when the request carries no timeout
DEFAULT_ACK_TIMEOUT_S = 10.0


class _FollowerPos:
    """One follower's view of one partition, as the leader observes it."""

    __slots__ = ("position", "in_sync", "last_fetch", "last_caught_up")

    def __init__(self, now: float):
        self.position = -1          # -1: never fetched this partition
        self.in_sync = False        # admitted only at its first catch-up
        self.last_fetch = now
        self.last_caught_up = now   # the eviction window's anchor


class _PartState:
    __slots__ = ("hwm", "followers")

    def __init__(self, hwm: int):
        self.hwm = hwm
        self.followers: Dict[int, _FollowerPos] = {}


class ReplicationState:
    """A leader's ISR and quorum-HWM tracker, attached as
    ``broker.replication`` (the wire server and ``Broker.fetch`` both
    read it there).

    Args:
      broker: the leader broker whose log ends anchor catch-up.
      follower_ids: the configured replica set.
      topics: replicated topic names, None for every topic.  acks=all
        against a topic outside the set answers NOT_ENOUGH_REPLICAS: "no
        ISR configured" is an error on a broker that opted into quorum.
      min_isr: Kafka's ``min.insync.replicas``: acks=all is refused,
        nothing appended, while ``isr_size < min_isr``.
      max_lag_s: the staleness window.
      hwm_file: a ``store.hwm.HwmFile``: quorum HWMs persist through it
        (throttled, off the tracking lock) and re-anchor the ceiling at
        a remount.
      initial_hwms: marks carried over at a promotion (the old quorum's):
        the mirrored but uncommitted tail stays unreadable until the new
        quorum covers it.
    """

    def __init__(self, broker, follower_ids=(), topics=None,
                 min_isr: int = 2, max_lag_s: float = 0.5,
                 hwm_file=None, initial_hwms=None):
        if min_isr < 1:
            raise ValueError(f"min_isr must be >= 1, got {min_isr}")
        self._broker = broker
        self._cond = threading.Condition()
        self._ids: Set[int] = set(int(i) for i in follower_ids)
        self._topics = None if topics is None else set(topics)
        self.min_isr = int(min_isr)
        self.max_lag_s = float(max_lag_s)
        self._parts: Dict[Tuple[str, int], _PartState] = {}
        self._hwm_file = hwm_file
        # a partition's anchor at first touch: the carried-over mark,
        # else the checkpoint, else the current log end
        self._persisted: Dict[Tuple[str, int], int] = \
            hwm_file.load() if hwm_file is not None else {}
        if initial_hwms:
            self._persisted.update(initial_hwms)
        self._hwm_dirty = False
        self._last_persist = 0.0
        self._persist_lock = threading.Lock()
        self._last_evict_scan = 0.0

    # ------------------------------------------------------------ scope
    def covers(self, topic: str) -> bool:
        """Whether acks=all may target this topic (an ISR is configured
        for it)."""
        return bool(self._ids) and (
            self._topics is None or topic in self._topics)

    @property
    def follower_ids(self) -> Tuple[int, ...]:
        with self._cond:
            return tuple(sorted(self._ids))

    @property
    def target_replicas(self) -> int:
        """The replication factor, leader included (the width
        ``under_replicated`` measures against)."""
        with self._cond:
            return 1 + len(self._ids)

    # -------------------------------------------------------- membership
    def register_follower(self, replica_id: int) -> None:
        """Register a replica id; it starts OUT of the ISR and is
        admitted when it catches up (Kafka's add-replica)."""
        with self._cond:
            self._ids.add(int(replica_id))

    def unregister_follower(self, replica_id: int) -> None:
        """Retire a replica id everywhere.  Dropping a laggard can only
        ADVANCE the quorum HWM, so waiting producers are woken."""
        rid = int(replica_id)
        with self._cond:
            self._ids.discard(rid)
            for key, ps in self._parts.items():
                ps.followers.pop(rid, None)
                self._advance_hwm_locked(key, ps, self._end(*key))
            self._cond.notify_all()
        self._refresh_gauges()
        self.maybe_persist()

    # ------------------------------------------------------ observations
    def _end(self, topic: str, partition: int) -> int:
        # the broker's lock is taken inside; no broker path calls back
        # into this state while holding its own lock (fetch clamps after
        # releasing it), so the order never inverts
        try:
            return self._broker.end_offset(topic, partition)
        except (KeyError, ConnectionError, IndexError):
            return 0

    def _part(self, key: Tuple[str, int]) -> _PartState:
        """Caller holds the cond.  Anchor a partition lazily: at the
        persisted mark when there is one (a remount's un-replicated tail
        stays unreadable until followers re-mirror it), else at the
        current log end (attaching replication to a live log must not
        un-commit its history)."""
        ps = self._parts.get(key)
        if ps is None:
            anchor = self._persisted.get(key)
            end = self._end(*key)
            ps = _PartState(end if anchor is None else min(anchor, end))
            self._parts[key] = ps
        return ps

    def observe_fetch(self, replica_id: int, topic: str, partition: int,
                      position: int) -> None:
        """Record a follower's fetch position (the wire server's ingress).
        A fetch at ``position`` proves the follower holds every record
        below it; reaching the log end admits it and advances the quorum
        HWM."""
        rid = int(replica_id)
        try:
            # never track a partition the leader does not serve: a
            # garbage state (end 0, instant admission) would poison the
            # every-partition ISR intersection an election reads
            if not 0 <= int(partition) < \
                    self._broker.topic(topic).partitions:
                return
        except KeyError:
            return
        now = time.monotonic()
        end = self._end(topic, partition)
        key = (topic, partition)
        changed = False
        with self._cond:
            if rid not in self._ids:
                return  # an unregistered observer never counts
            ps = self._part(key)
            f = ps.followers.get(rid)
            if f is None:
                f = ps.followers[rid] = _FollowerPos(now)
            f.position = max(f.position, int(position))
            f.last_fetch = now
            if f.position >= end:
                f.last_caught_up = now
                if not f.in_sync:
                    f.in_sync = True      # admission (or re-admission)
                    changed = True
            self._advance_hwm_locked(key, ps, end)
            self._cond.notify_all()
        if changed:
            self._refresh_gauges()
        self.evict_stale(now=now)
        self.maybe_persist()

    def _advance_hwm_locked(self, key, ps: _PartState, end: int) -> None:
        """Caller holds the cond.  Quorum HWM = min over the ISR's
        positions (the leader's is its log end), MONOTONE: neither a late
        joiner nor an eviction regresses what consumers already read."""
        floor = end
        for f in ps.followers.values():
            if f.in_sync:
                floor = min(floor, max(f.position, 0))
        if floor > ps.hwm:
            ps.hwm = floor
            self._hwm_dirty = True
        obs_metrics.quorum_hwm_lag.set(max(end - ps.hwm, 0),
                                       topic=key[0], partition=key[1])

    def evict_stale(self, now: Optional[float] = None) -> List[int]:
        """Drop from the ISR the followers that have not reached the log
        end within ``max_lag_s``.  Throttled to a quarter of the window,
        so hot paths call it freely; returns the ids this scan evicted."""
        now = time.monotonic() if now is None else now
        with self._cond:
            if now - self._last_evict_scan < self.max_lag_s / 4:
                return []
            self._last_evict_scan = now
            keys = list(self._parts)
        evicted: List[int] = []
        for key in keys:
            end = self._end(*key)
            with self._cond:
                ps = self._parts[key]
                for rid, f in ps.followers.items():
                    if f.in_sync and f.position < end and \
                            now - f.last_caught_up > self.max_lag_s:
                        f.in_sync = False
                        evicted.append(rid)
                self._advance_hwm_locked(key, ps, end)
                if evicted:
                    # an eviction only ADVANCES the quorum: wake the
                    # acks=all waiters to re-check
                    self._cond.notify_all()
        if evicted:
            self._refresh_gauges()
        return evicted

    # ----------------------------------------------------------- queries
    def isr_size(self, topic: str, partition: int) -> int:
        """In-sync replica count, leader included.  A partition no
        follower fetched counts the leader alone: admission is earned."""
        with self._cond:
            ps = self._parts.get((topic, partition))
            n = 0 if ps is None else \
                sum(1 for f in ps.followers.values() if f.in_sync)
        return 1 + n

    def isr_follower_ids(self, topic: Optional[str] = None) -> Set[int]:
        """Replica ids in sync on EVERY tracked partition (of ``topic``,
        or of all): the election's candidates.  Nothing tracked: nobody
        has proven sync, so nobody may be promoted."""
        with self._cond:
            keys = [k for k in self._parts
                    if topic is None or k[0] == topic]
            if not keys:
                return set()
            out: Optional[Set[int]] = None
            for k in keys:
                ins = {rid for rid, f in self._parts[k].followers.items()
                       if f.in_sync}
                out = ins if out is None else (out & ins)
            return out or set()

    def quorum_hwm(self, topic: str, partition: int) -> int:
        with self._cond:
            ps = self._parts.get((topic, partition))
            if ps is not None:
                return ps.hwm
        # untracked: anchor now (the barrier must exist before the first
        # follower fetch, or early consumers read the tail)
        with self._cond:
            return self._part((topic, partition)).hwm

    def fetch_ceiling(self, topic: str, partition: int) -> Optional[int]:
        """The first offset consumers may NOT read (the quorum HWM), or
        None when this topic is not under replication (unbounded)."""
        if not self.covers(topic):
            return None
        return self.quorum_hwm(topic, partition)

    def hwm_snapshot(self) -> Dict[Tuple[str, int], int]:
        """The quorum HWMs of the tracked partitions (what a promotion
        carries into the new leader's state)."""
        with self._cond:
            return {k: ps.hwm for k, ps in self._parts.items()}

    def positions(self, topic: str, partition: int) -> Dict[int, int]:
        """Follower fetch positions (diagnostics, election tiebreaks)."""
        with self._cond:
            ps = self._parts.get((topic, partition))
            if ps is None:
                return {}
            return {rid: f.position for rid, f in ps.followers.items()}

    # ------------------------------------------------------- quorum wait
    def wait_replicated(self, topic: str, partition: int,
                        next_offset: int,
                        timeout_s: float = DEFAULT_ACK_TIMEOUT_S) -> bool:
        """Block until the quorum HWM reaches ``next_offset`` (the acks=all
        ack point of a batch ending at ``next_offset - 1``) or the timeout
        lapses.  The loop runs the eviction scan, so a dead follower holds
        an ack for at most ``max_lag_s`` before the quorum re-forms."""
        deadline = time.monotonic() + max(timeout_s, 0.0)
        while True:
            with self._cond:
                ps = self._part((topic, partition))
                if ps.hwm >= next_offset:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, self.max_lag_s / 4
                                    if self.max_lag_s > 0 else 0.05))
            self.evict_stale()
        self.maybe_persist()
        return True

    def await_isr(self, size: int, topic: str, partition: int = 0,
                  timeout_s: float = 10.0) -> bool:
        """Block until ``isr_size(topic, partition) >= size``."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.isr_size(topic, partition) >= size:
                return True
            time.sleep(0.01)
        return False

    # ------------------------------------------------------- persistence
    def maybe_persist(self, min_interval_s: float = 0.05) -> None:
        """A throttled checkpoint write, OFF the tracking lock (file I/O
        never sits on the quorum wait path)."""
        if self._hwm_file is None:
            return
        now = time.monotonic()
        with self._persist_lock:
            if not self._hwm_dirty or \
                    now - self._last_persist < min_interval_s:
                return
            with self._cond:
                snap = {k: ps.hwm for k, ps in self._parts.items()}
                self._hwm_dirty = False
            self._last_persist = now
        try:
            self._hwm_file.store(snap)
        except OSError:
            with self._cond:
                self._hwm_dirty = True  # retry on the next advance

    def flush(self) -> None:
        """An unthrottled checkpoint (the shutdown path)."""
        if self._hwm_file is None:
            return
        with self._cond:
            snap = {k: ps.hwm for k, ps in self._parts.items()}
            self._hwm_dirty = False
        try:
            self._hwm_file.store(snap)
        except OSError:
            pass

    # ------------------------------------------------------------ gauges
    def _refresh_gauges(self) -> None:
        with self._cond:
            rows = [(k, sum(1 for f in ps.followers.values() if f.in_sync))
                    for k, ps in self._parts.items()]
            target = 1 + len(self._ids)
        under = 0
        for (t, p), in_sync in rows:
            size = 1 + in_sync
            obs_metrics.isr_size.set(size, topic=t, partition=p)
            if size < target:
                under += 1
        obs_metrics.under_replicated.set(under)
