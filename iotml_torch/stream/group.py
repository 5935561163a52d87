"""Consumer-group coordination (``iotml.stream.group``'s copy).

A scorer replica set splits a topic's partitions through a group
coordinator and heals when a member joins, leaves or crashes:

- ``GroupCoordinator``: generation-numbered membership with heartbeats
  and a session timeout on an injectable clock.  A membership change
  (new member, leave, expiry, subscription change, topic metadata
  change) bumps the generation and recomputes the assignments (Kafka's
  range or round-robin assignor).  A current member rejoining with an
  unchanged subscription gets the standing assignment without a bump,
  so members converge instead of invalidating each other forever.
  Commits are generation-fenced (Kafka's ILLEGAL_GENERATION), with a
  grace window in which a surviving member may still commit its old
  partitions' progress before it releases them.
- ``GroupConsumer``: every ``poll()`` heartbeats; on a generation change
  it commits, rejoins, keeps the positions of the partitions it held and
  resumes new ones from the group's committed offsets.  Crash = stop
  polling: after the session timeout the survivors take its partitions
  at the last commit (at-least-once, Kafka's contract).

Across processes the coordinator lives in the wire server
(``stream.kafka_wire.KafkaWireServer.group_coordinator``) and
``GroupConsumer`` reaches it through ``kafka_wire.RemoteGroupCoordinator``,
the same duck-type over JoinGroup / SyncGroup / Heartbeat / LeaveGroup /
OffsetCommit.  The group consumer's fused and columnar polls are not
ported.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

from .broker import Message
from .consumer import StreamConsumer

TopicPartition = Tuple[str, int]


def range_assign(members: Sequence[str], topic_partitions: Dict[str, int]
                 ) -> Dict[str, List[TopicPartition]]:
    """Kafka's RangeAssignor: per topic, contiguous chunks in member order;
    the first (len % n) members get one extra partition."""
    out: Dict[str, List[TopicPartition]] = {m: [] for m in members}
    ms = sorted(members)
    if not ms:
        return out
    for topic in sorted(topic_partitions):
        per, extra = divmod(topic_partitions[topic], len(ms))
        p = 0
        for i, m in enumerate(ms):
            take = per + (1 if i < extra else 0)
            out[m].extend((topic, q) for q in range(p, p + take))
            p += take
    return out


def roundrobin_assign(members: Sequence[str],
                      topic_partitions: Dict[str, int]
                      ) -> Dict[str, List[TopicPartition]]:
    """Kafka's RoundRobinAssignor: all (topic, partition) pairs dealt out
    in order across members."""
    out: Dict[str, List[TopicPartition]] = {m: [] for m in members}
    ms = sorted(members)
    if not ms:
        return out
    cycle = itertools.cycle(ms)
    for topic in sorted(topic_partitions):
        for q in range(topic_partitions[topic]):
            out[next(cycle)].append((topic, q))
    return out


ASSIGNORS = {"range": range_assign, "roundrobin": roundrobin_assign}


class GroupCoordinator:
    """Generation-numbered group membership over a broker's topics."""

    def __init__(self, broker, group_id: str,
                 session_timeout_s: float = 10.0, assignor: str = "range",
                 clock=time.monotonic, metadata_max_age_s: float = 5.0):
        if assignor not in ASSIGNORS:
            raise ValueError(f"unknown assignor {assignor!r}; "
                             f"choose from {sorted(ASSIGNORS)}")
        self.broker = broker
        self.group_id = group_id
        self.session_timeout_s = session_timeout_s
        self.assignor = ASSIGNORS[assignor]
        self._clock = clock
        self._lock = threading.RLock()
        self.generation = 0
        self._heartbeats: Dict[str, float] = {}
        self._subscriptions: Dict[str, Tuple[str, ...]] = {}
        self._assignments: Dict[str, List[TopicPartition]] = {}
        self._last_topics: Dict[str, int] = {}  # metadata at last rebalance
        # revocation grace: each surviving member that has not rejoined
        # since the last bump, with its pre-bump (generation, assignment);
        # a commit at that generation is its "commit before release"
        self._pending_rejoin: Dict[str, Tuple[int,
                                              List[TopicPartition]]] = {}
        # metadata.max.age.ms: heartbeats between sweeps reuse the cached
        # topic view, so a poll costs O(1)
        self.metadata_max_age_s = metadata_max_age_s
        self._meta_checked_at: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    def join(self, topics: Sequence[str], member_id: Optional[str] = None
             ) -> Tuple[str, int, List[TopicPartition]]:
        """(Re)join the group; returns (member_id, generation, assignment).

        Only a change (new member, changed subscription, expired peers,
        topic metadata drift) rebalances; a current member rejoining
        identically receives the standing assignment."""
        with self._lock:
            self._expire_dead()
            known = member_id is not None and member_id in self._heartbeats
            member_id = member_id or f"{self.group_id}-{uuid.uuid4().hex[:8]}"
            subs = tuple(sorted(topics))
            sub_changed = (not known
                           or self._subscriptions.get(member_id) != subs)
            self._heartbeats[member_id] = self._clock()
            self._subscriptions[member_id] = subs
            # one probe after the subscription update, so it covers this
            # member's topics; _rebalance reuses it
            meta = self._topic_metadata(force=True)
            if sub_changed or meta != self._last_topics:
                self._rebalance(meta)
            # rejoining closes the member's revocation-grace window
            self._pending_rejoin.pop(member_id, None)
            return member_id, self.generation, list(
                self._assignments.get(member_id, []))

    def leave(self, member_id: str) -> None:
        with self._lock:
            self._pending_rejoin.pop(member_id, None)
            if member_id in self._heartbeats:
                del self._heartbeats[member_id]
                del self._subscriptions[member_id]
                self._rebalance()

    def heartbeat(self, member_id: str, generation: int) -> bool:
        """True iff the member is still current; False demands a rejoin.
        A subscribed topic appearing or growing partitions rebalances
        (``heartbeat_verdict`` tells the failure modes apart)."""
        return self.heartbeat_verdict(member_id, generation) == "ok"

    def fenced_commit(self, member_id: str, generation: int,
                      positions: Sequence[Tuple[str, int, int]]) -> bool:
        """Commit offsets iff the member is current for this generation
        (or inside its revocation grace); True when accepted.  Only the
        member's own partitions are written."""
        return self.fenced_commit_detailed(member_id, generation,
                                           positions) is not None

    def fenced_commit_detailed(self, member_id: str, generation: int,
                               positions: Sequence[Tuple[str, int, int]]
                               ) -> Optional[set]:
        """Like ``fenced_commit``, per partition: None when the member is
        fenced (nothing written), else the set of (topic, partition)
        actually committed."""
        with self._lock:
            if member_id in self._heartbeats and \
                    generation == self.generation:
                owned = set(self._assignments.get(member_id, []))
                done = set()
                for t, p, off in positions:
                    if (t, p) in owned:
                        self.broker.commit(self.group_id, t, p, off)
                        done.add((t, p))
                return done
            # revocation grace: a survivor that has not seen the
            # rebalance commits its progress at the OLD generation, for
            # the partitions it owned then and never backwards (the new
            # owner may already have committed further)
            pending = self._pending_rejoin.get(member_id)
            if member_id not in self._heartbeats or pending is None or \
                    generation != pending[0]:
                return None
            owned = set(pending[1])
            done = set()
            for t, p, off in positions:
                if (t, p) not in owned:
                    continue
                cur = self.broker.committed(self.group_id, t, p)
                if cur is None or off >= cur:
                    self.broker.commit(self.group_id, t, p, off)
                done.add((t, p))
            return done

    def sync(self, member_id: str, generation: int
             ) -> Tuple[str, List[TopicPartition]]:
        """Membership check + assignment fetch under one lock (SyncGroup).
        Returns ("ok"|"unknown_member"|"illegal_generation",
        assignment)."""
        with self._lock:
            if member_id not in self._heartbeats:
                return "unknown_member", []
            if generation != self.generation:
                return "illegal_generation", []
            return "ok", list(self._assignments.get(member_id, []))

    def assignment(self, member_id: str) -> List[TopicPartition]:
        with self._lock:
            return list(self._assignments.get(member_id, []))

    def members(self) -> List[str]:
        with self._lock:
            self._expire_dead()
            return sorted(self._heartbeats)

    def subscriptions(self) -> Dict[str, Tuple[str, ...]]:
        """member_id → subscribed topics."""
        with self._lock:
            return dict(self._subscriptions)

    def heartbeat_verdict(self, member_id: str, generation: int) -> str:
        """"ok" | "unknown_member" (rejoin with a fresh id) |
        "rebalance_in_progress" (rejoin with the same id)."""
        with self._lock:
            self._expire_dead()
            if member_id not in self._heartbeats:
                return "unknown_member"
            if generation != self.generation:
                return "rebalance_in_progress"
            meta = self._topic_metadata()
            if meta is not self._last_topics and meta != self._last_topics:
                self._rebalance(meta)
                return "rebalance_in_progress"
            self._heartbeats[member_id] = self._clock()
            return "ok"

    # ------------------------------------------------------------ internals
    def _topic_metadata(self, force: bool = False) -> Dict[str, int]:
        """Partition counts of the subscribed topics that exist now (a
        topic subscribed before it exists contributes nothing yet).
        Probes at most once per ``metadata_max_age_s`` unless forced."""
        now = self._clock()
        if (not force and self._meta_checked_at is not None
                and now - self._meta_checked_at < self.metadata_max_age_s):
            return self._last_topics
        self._meta_checked_at = now
        subscribed = set()
        for subs in self._subscriptions.values():
            subscribed.update(subs)
        topics: Dict[str, int] = {}
        for t in sorted(subscribed):
            try:
                topics[t] = self.broker.topic(t).partitions
            except KeyError:
                continue
        return topics

    def _expire_dead(self) -> None:
        now = self._clock()
        dead = [m for m, hb in self._heartbeats.items()
                if now - hb > self.session_timeout_s]
        for m in dead:
            del self._heartbeats[m]
            del self._subscriptions[m]
            # an expired member gets no grace: a zombie resurfacing must
            # not clobber its successor
            self._pending_rejoin.pop(m, None)
        if dead:
            self._rebalance()

    def _rebalance(self, topics: Optional[Dict[str, int]] = None) -> None:
        if topics is None:
            topics = self._topic_metadata(force=True)
        members = sorted(self._heartbeats)
        # open the grace window for every survivor; a member that misses
        # several rebalances keeps the earliest pending generation
        for m in members:
            if m not in self._pending_rejoin:
                self._pending_rejoin[m] = (
                    self.generation, list(self._assignments.get(m, [])))
        assignments = self.assignor(members, topics)
        # only members subscribed to a topic may receive its partitions
        for m in members:
            subs = set(self._subscriptions[m])
            assignments[m] = [tp for tp in assignments[m] if tp[0] in subs]
        self._assignments = assignments
        self._last_topics = topics
        self.generation += 1


class GroupConsumer:
    """Self-healing consumer: rebalance-aware polling with committed-offset
    resume.  At-least-once: records between the last ``commit()`` and a
    crash are redelivered to whichever member inherits the partition.
    Fetching is a ``StreamConsumer`` rebuilt on every rebalance."""

    def __init__(self, coordinator: GroupCoordinator, topics: Sequence[str],
                 member_id: Optional[str] = None,
                 fallback_offset: int = 0):
        self.coord = coordinator
        self.broker = coordinator.broker
        self.group = coordinator.group_id
        self.topics = tuple(topics)
        self.fallback_offset = fallback_offset
        self.rebalances = 0
        self.member_id, self.generation, assigned = \
            coordinator.join(self.topics, member_id)
        self._adopt(assigned)

    # ------------------------------------------------------------- polling
    def _adopt(self, assigned: List[TopicPartition],
               sticky: bool = True) -> None:
        # cooperative-sticky: partitions kept across the rebalance carry
        # their in-memory position; new ones resume from the committed
        # offset, all fetched in one committed_many
        held = ({(t, p): off for t, p, off in self._sc.positions()}
                if sticky and hasattr(self, "_sc") else {})
        frontier = self.broker.committed_many(self.group, list(assigned)) \
            if assigned else {}
        specs = []
        for t, p in assigned:
            committed = frontier.get((t, p))
            if (t, p) in held:
                off = held[(t, p)]
                if committed is not None and committed > off:
                    # an interim owner committed past our held cursor
                    # while we were out of the group: resume there
                    off = committed
            else:
                off = committed if committed is not None \
                    else self.fallback_offset
            specs.append(f"{t}:{p}:{off}")
        self._sc = StreamConsumer(self.broker, specs, group=self.group,
                                  eof=False)

    def _ensure_membership(self) -> None:
        if not self.coord.heartbeat(self.member_id, self.generation):
            # revocation: commit this member's progress before releasing
            # its partitions (inside the grace window), so the successor
            # resumes at the real frontier; a fenced member falls back to
            # at-least-once redelivery
            try:
                self.coord.fenced_commit(self.member_id, self.generation,
                                         self._sc.positions())
            except ConnectionError:
                pass  # the rejoin below re-resolves
            self.member_id, self.generation, assigned = \
                self.coord.join(self.topics, self.member_id)
            self._adopt(assigned)
            self.rebalances += 1

    @property
    def assignment(self) -> List[TopicPartition]:
        return sorted((t, p) for t, p, _ in self._sc.positions())

    def poll(self, max_messages: int = 1024) -> List[Message]:
        """Heartbeat, heal membership if the group moved on, then fetch
        from the assigned partitions round-robin."""
        self._ensure_membership()
        return self._sc.poll(max_messages)

    def at_end(self) -> bool:
        return self._sc.at_end()

    def __iter__(self):
        while True:
            batch = self.poll()
            if not batch:
                return
            yield from batch

    def positions(self) -> List[Tuple[str, int, int]]:
        return sorted(self._sc.positions())

    def seek_to_start(self) -> None:
        """Group semantics: 'start' is the group's committed position (the
        resume cursor), not offset 0."""
        self._adopt([(t, p) for t, p, _ in self._sc.positions()],
                    sticky=False)

    def rewind_to_committed(self) -> None:
        """Reset the cursors to the group's committed offsets: the
        redelivery entry point after a ConnectionError mid-drain."""
        self._sc.rewind_to_committed()

    def commit(self) -> bool:
        """Generation-fenced commit; False (and nothing written) when this
        member has been fenced by a rebalance it has not seen yet."""
        return self.coord.fenced_commit(self.member_id, self.generation,
                                        self._sc.positions())

    def close(self) -> None:
        self.commit()
        self.coord.leave(self.member_id)
