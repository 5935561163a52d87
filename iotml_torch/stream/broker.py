"""In-process broker (``iotml.stream.broker``'s ``Broker``).

The reference's data plane is a Confluent deployment (topics
``sensor-data`` / ``model-predictions``, reference
``01_installConfluentPlatform.sh:180-183``).  This is its in-process
equivalent: a partitioned, offset-addressed append-only log with
retention by message count, by bytes and by record age, and
consumer-group offset storage (one commit or fetch of many partitions
under one lock), so the port's train and score jobs run against it
unchanged.  Keyed records go to ``crc32(key) % partitions``, unkeyed ones
round-robin, as in the JAX package.

Two partition backends behind one ``Broker``:

- **in-memory** (default): a Python list per partition, dies with the
  process;
- **durable** (``store_dir=``): a ``store.SegmentedLog`` per partition
  (a ``store.TieredLog`` with ``tier=``): CRC-framed segments on disk,
  crash recovery at mount, retention by bytes, age and count, committed
  consumer offsets persisted in a compacted offsets file, key-based
  compaction of ``cleanup_policy="compact"`` topics (``run_compaction``)
  and a remote tier (``run_tiering``).  The store directory is the JAX
  package's format byte for byte.  ``produce_many`` frames each
  partition's slice of a batch in one native call and appends it as it
  is, with one fsync a partition under ``fsync=always`` before the call
  returns (acked ⇒ durable); traced records (headers) and
  ``IOTML_RAW_PRODUCE=off`` take the per-record encoder.

One lock guards all mutation and ``fetch``; every append goes through
``produce_many``, which takes it once for a whole batch (the wire
server's produce path and the ordered write-back).  Records carry
optional headers (``Message.headers``, the trace context's carrier, as
the JAX broker's do); ``produce``/``produce_many`` pass the chaos point
``broker.produce`` once a call and ``fetch`` passes ``broker.fetch``.
Topic ownership is ported: ``restrict_topic(prefix)`` makes every topic
of that prefix writable only by a thread inside ``producer_grant(token)``
(the KSQL engine's AVRO leg; other producers get
``TopicOwnershipError``, the wire server answers them Kafka's
TOPIC_AUTHORIZATION_FAILED).

The raw frame-batch legs are ported: ``fetch_raw`` hands back a
``RawFrameBatch`` of store frames (a durable partition's own segment
bytes, read outside the lock; the in-memory partition re-frames its
slice through the one codec), and ``produce_raw`` lands a pre-framed
batch (the RAW_PRODUCE landing: validated whole and offset-stamped by
the engine, then appended as it is on a durable partition or decoded
into the list in memory; a corrupt batch raises
``CorruptMessageError`` before any byte lands, and the chaos point
``broker.produce_raw`` can ``corrupt`` one).

The replication hooks: ``replication`` (a
``replication.ReplicationState`` when this broker leads replicated
partitions; None, the default, costs nothing) bounds every consumer
read, ``fetch`` and ``fetch_raw``, at the quorum high-water mark, while
``fetch_tail`` and ``fetch_raw_tail`` read past it for the followers.
A follower lands its mirror through ``produce_at`` (one record at an
explicit offset, a compacted topic's holes reproduced on disk) and
``produce_raw_at`` (a fetched frame batch at its own offsets, appended
as it is), and realigns with ``align_base_offset`` (an empty partition
started at the leader's earliest retained offset) and
``reset_partition`` (retention outran replication).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import zlib
from typing import Dict, List, NamedTuple, Optional

from ..chaos import faults as chaos


class OffsetOutOfRangeError(LookupError):
    """Fetch below the partition's retained base offset.

    Retention trimmed the log head past the requested offset; the signal
    is explicit so trimmed history cannot pass for delivered history.
    ``StreamConsumer`` auto-resets to the earliest retained offset
    (``auto.offset.reset=earliest``)."""

    def __init__(self, topic: str, partition: int, offset: int,
                 earliest: int):
        super().__init__(
            f"fetch {topic}:{partition}@{offset} below retained base "
            f"{earliest}: the log head was trimmed (retention); consumers "
            f"auto-reset to earliest, raw callers decide")
        self.topic = topic
        self.partition = partition
        self.offset = offset
        self.earliest = earliest


class CorruptMessageError(ValueError):
    """A pre-framed RAW_PRODUCE batch failed CRC/offset validation: the
    whole batch is rejected before any byte lands (no partial append).
    The wire server answers Kafka CORRUPT_MESSAGE (2); the producer
    re-frames and redelivers."""

    def __init__(self, topic: str, partition: int, index: int):
        super().__init__(
            f"corrupt pre-framed batch for {topic}:{partition} at frame "
            f"{index}: whole batch rejected, nothing appended "
            f"(Kafka CORRUPT_MESSAGE)")
        self.topic = topic
        self.partition = partition
        self.index = index


class TopicOwnershipError(PermissionError):
    """Produce to an engine-owned topic without the owner's grant.

    Engine-owned topics (the stream processor's AVRO leg and what derives
    from it) are written only by the owning engine: that exclusivity is
    what makes its trusted pass-through sound (the engine skips
    re-validating bytes only its own validating encoder could have
    written).  The wire server maps this to Kafka's
    TOPIC_AUTHORIZATION_FAILED."""


class SchemaIdMismatchError(ValueError):
    """A fused decode found a Confluent writer-schema id outside the
    reader's pinned band at the current cursor.

    The runtime guard behind the positional fast path: instead of
    stripping 5 bytes and mis-reading an evolved (v2) writer's record,
    the native client stops at the foreign frame and raises this; the
    consumer re-reads that chunk through the name-resolving path
    (``ops.avro.ResolvingCodec``) and then resumes the fast path.
    Nothing is consumed past the mismatch."""

    def __init__(self, topic: str, partition: int, offset: int):
        super().__init__(
            f"non-pinned Confluent schema id at {topic}:{partition}"
            f"@{offset}: evolved writer on a pinned topic — resolve by "
            f"name in Python (chunk fallback), never strip blindly")
        self.topic = topic
        self.partition = partition
        self.offset = offset


# Thread-local produce grants: a thread pumping an owning engine enters
# `producer_grant(token)` and may produce to the topics that token
# restricts; every other producer is rejected.  Thread-local (not an
# instance flag) so a grant cannot leak across the wire server's
# handler threads.
_grants = threading.local()


class Message(NamedTuple):
    """One record as fetched from a partition log."""

    topic: str
    partition: int
    offset: int
    value: bytes
    key: Optional[bytes] = None
    timestamp_ms: int = 0
    #: optional ((name, value), ...) record headers: the trace context's
    #: carrier (``obs.tracing``), beside the payload so the Avro bytes are
    #: untouched.  The wire and native clients drop them (MessageSet v1
    #: has no header slot).
    headers: Optional[tuple] = None


@dataclasses.dataclass
class TopicSpec:
    """A topic's partition count, its retention bounds per partition
    (messages, payload bytes (value + key), age in ms behind the newest
    record's timestamp) and its cleanup policy.

    Retention None is UNSET: a durable broker's topic inherits the
    store-wide ``store.*`` default, an in-memory one is unbounded.  0 is
    EXPLICITLY unlimited (the wire maps Kafka's -1 here), the only way a
    durable topic opts out of the store default.  ``cleanup_policy``
    "compact" additionally reclaims records shadowed by a newer record
    with the same key on a durable broker (``run_compaction``); the
    in-memory backend keeps it as metadata only."""

    name: str
    partitions: int = 1
    retention_messages: Optional[int] = None
    retention_bytes: Optional[int] = None
    retention_ms: Optional[int] = None
    cleanup_policy: str = "delete"


def _size(key, value) -> int:
    return (len(value) if value else 0) + (len(key) if key else 0)


class _Partition:
    """One partition: the list-backed log."""

    __slots__ = ("log", "base_offset", "bytes", "max_ts")

    def __init__(self):
        self.log: List[tuple] = []  # (key, value, ts, headers)
        self.base_offset = 0  # offset of log[0] after retention trimming
        self.bytes = 0  # payload bytes retained (retention_bytes)
        self.max_ts = 0  # newest record ts seen (retention_ms anchor)

    def append(self, key, value, ts, headers=None, sync: bool = True) -> int:
        self.log.append((key, value, ts, headers))
        self.bytes += _size(key, value)
        if ts > self.max_ts:
            self.max_ts = ts
        return self.base_offset + len(self.log) - 1

    def sync_batch(self) -> None:
        pass  # durability is the durable backend's concern

    def note_replay(self, n: int) -> None:
        pass  # iotml_store_* metrics are the durable backend's alone

    def end(self) -> int:
        return self.base_offset + len(self.log)

    def base(self) -> int:
        return self.base_offset

    def offset_for_timestamp(self, ts_ms: int) -> int:
        for i, (_k, _v, ts, _h) in enumerate(self.log):
            if ts >= ts_ms:
                return self.base_offset + i
        return self.end()

    def read(self, offset: int, max_messages: int) -> List[tuple]:
        """[(offset, key, value, ts, headers)] from `offset`."""
        idx = offset - self.base_offset
        return [(offset + i, key, value, ts, hdrs) for i, (key, value, ts, hdrs)
                in enumerate(self.log[idx:idx + max_messages])]

    def read_raw(self, offset: int, max_bytes: int) -> Optional[tuple]:
        """(store frames from ``offset``, ``offset``), or None at the log
        end: the list has no frames, so its slice is re-framed through
        the one codec (``ops.framing.encode_frame_batch``), up to
        ``max_bytes`` counted as value + key + 64 a record."""
        from ..ops.framing import encode_frame_batch

        idx = offset - self.base_offset
        if idx >= len(self.log):
            return None
        out = []
        size = 0
        i = idx
        while i < len(self.log) and size < max_bytes:
            key, value, ts, hdrs = self.log[i]
            out.append((offset + (i - idx), key, value, ts, hdrs))
            size += _size(key, value) + 64
            i += 1
        return encode_frame_batch(out), offset

    def append_raw(self, blob, count, first, last, max_ts,
                   sync: bool = True) -> int:
        """Land a validated raw frame batch: the list holds no frames, so
        each is decoded through the one parser and appended.  Only a
        gap-free continuation of the log is representable."""
        from ..ops.framing import iter_frame_entries

        for off, key, value, ts, hdrs in iter_frame_entries(blob):
            self.append_at(off, key, value, ts, hdrs, sync=False)
        return first

    def append_at(self, offset, key, value, ts, headers=None,
                  sync: bool = True) -> int:
        """Append at an explicit offset (a follower's mirror of a
        compacted topic).  The list is dense, so only a gap-free
        continuation is representable; a true hole needs a durable
        follower."""
        if int(offset) != self.end():
            raise ValueError(
                f"in-memory partition cannot represent an offset hole "
                f"({offset} != end {self.end()}); mount a durable follower "
                f"for compacted-topic mirroring")
        return self.append(key, value, ts, headers, sync=sync)

    def align_base(self, offset: int) -> None:
        if self.log:
            raise ValueError("partition not empty; base is immutable")
        self.base_offset = max(self.base_offset, int(offset))

    def reset(self, base_offset: int) -> None:
        self.log.clear()
        self.bytes = 0
        self.max_ts = 0
        self.base_offset = int(base_offset)

    def drop_head(self, count: int) -> None:
        for key, value, _ts, _h in self.log[:count]:
            self.bytes -= _size(key, value)
        del self.log[:count]
        self.base_offset += count

    def enforce_retention(self, spec: TopicSpec) -> None:
        """Trim the head to the spec's bounds, as the JAX package's
        in-memory partition does: by count; by bytes, always keeping the
        newest record; by age against the newest timestamp (untimestamped
        records never age out), keeping the newest record too."""
        if spec.retention_messages and len(self.log) > spec.retention_messages:
            self.drop_head(len(self.log) - spec.retention_messages)
        if spec.retention_bytes:
            drop = freed = 0
            while self.bytes - freed > spec.retention_bytes and \
                    drop < len(self.log) - 1:
                key, value = self.log[drop][:2]
                freed += _size(key, value)
                drop += 1
            if drop:
                self.drop_head(drop)
        if spec.retention_ms:
            cutoff = self.max_ts - spec.retention_ms
            drop = 0
            while drop < len(self.log) - 1 and self.log[drop][2] < cutoff:
                drop += 1
            if drop and self.log[drop - 1][2] < cutoff:
                self.drop_head(drop)


class _DurablePartition:
    """Durable partition: a ``store.SegmentedLog`` behind the same
    touch-points as ``_Partition``.  All three retention knobs map to
    whole-segment deletes (Kafka's own granularity): count, byte and time
    caps may over-retain up to one segment, never under-retain."""

    __slots__ = ("slog",)

    def __init__(self, slog):
        self.slog = slog

    def append(self, key, value, ts, headers=None, sync: bool = True) -> int:
        return self.slog.append(key, value, ts, headers, sync=sync)

    def append_at(self, offset, key, value, ts, headers=None,
                  sync: bool = True) -> int:
        return self.slog.append_at(offset, key, value, ts, headers,
                                   sync=sync)

    def align_base(self, offset: int) -> None:
        self.slog.align_base(offset)

    def reset(self, base_offset: int) -> None:
        self.slog.reset(base_offset)

    def append_raw(self, blob, count, first, last, max_ts,
                   sync: bool = True) -> int:
        """Append a framed batch as it is: the batch's bytes become the
        log's bytes, no re-serialisation (offset holes reproduce as
        they are)."""
        return self.slog.append_raw(blob, count, first, last, max_ts,
                                    sync=sync)

    def sync_batch(self) -> None:
        self.slog.sync_batch()

    def note_replay(self, n: int) -> None:
        from ..store.log import store_replay_records

        store_replay_records.inc(n)

    def end(self) -> int:
        return self.slog.end_offset

    def base(self) -> int:
        return self.slog.base_offset

    def read(self, offset: int, max_messages: int) -> List[tuple]:
        return self.slog.read_from(offset, max_messages)

    def read_raw(self, offset: int, max_bytes: int) -> Optional[tuple]:
        return self.slog.read_raw(offset, max_bytes)

    def enforce_retention(self, spec: TopicSpec) -> None:
        pol = self.slog.policy
        # the topic's bounds override the store-wide defaults when set
        prev = (pol.retention_bytes, pol.retention_ms,
                pol.retention_messages)
        if spec.retention_bytes is not None:
            pol.retention_bytes = spec.retention_bytes
        if spec.retention_ms is not None:
            pol.retention_ms = spec.retention_ms
        if spec.retention_messages is not None:
            pol.retention_messages = spec.retention_messages
        try:
            self.slog.enforce_retention()
        finally:
            (pol.retention_bytes, pol.retention_ms,
             pol.retention_messages) = prev

    def offset_for_timestamp(self, ts_ms: int) -> int:
        return self.slog.offset_for_timestamp(ts_ms)


class Broker:
    """Partitioned commit log with Kafka-shaped semantics.

    ``Broker()`` is the in-memory emulator.  ``Broker(store_dir=...)``
    mounts (and crash-recovers) a durable segmented log per partition:
    topics from the manifest are re-created before serving, committed
    consumer offsets load from the compacted offsets file, and every
    later commit is persisted through it.  ``store_policy`` (a
    ``store.StorePolicy``) sets fsync, segment and retention defaults;
    ``tier`` (a ``store.TierPolicy`` with a uri) mounts every partition
    as a tiered log over that remote tier."""

    def __init__(self, store_dir: Optional[str] = None, store_policy=None,
                 tier=None):
        self._lock = threading.Lock()
        # serialize whole compaction and tiering passes (a background
        # thread vs a forced pass); the data lock covers only the swaps
        self._compact_pass_lock = threading.Lock()
        self._tier_pass_lock = threading.Lock()
        #: quorum replication state (``replication.ReplicationState``)
        #: when this broker leads replicated partitions: ``fetch`` and
        #: ``fetch_raw`` stop consumers at the quorum HWM, and the wire
        #: server waits on it for acks=all and feeds it the followers'
        #: fetch positions.  None: unreplicated, zero cost.
        self.replication = None
        self._topics: Dict[str, TopicSpec] = {}
        self._parts: Dict[str, List] = {}
        # (group, topic, partition) → next offset
        self._group_offsets: Dict[tuple, int] = {}
        self._rr: Dict[str, int] = {}  # round-robin cursor per topic
        self._owned: Dict[str, object] = {}  # topic prefix → owner token
        self.store = None
        if store_dir:
            from ..store import StoreMount

            self.store = StoreMount(store_dir, policy=store_policy,
                                    tier=tier)
            for doc in self.store.topics():
                self.create_topic(
                    doc["name"], partitions=doc["partitions"],
                    retention_messages=doc.get("retention_messages"),
                    retention_bytes=doc.get("retention_bytes"),
                    retention_ms=doc.get("retention_ms"),
                    cleanup_policy=doc.get("cleanup_policy", "delete"))
            self._group_offsets.update(self.store.offsets.table())

    @property
    def durable(self) -> bool:
        return self.store is not None

    # --------------------------------------------------------- ownership
    def restrict_topic(self, prefix: str,
                       token: Optional[object] = None) -> object:
        """Mark every topic named `prefix`* engine-owned: produces are
        rejected (TopicOwnershipError) unless the calling thread holds
        the returned token via `producer_grant`.  Reads, commits and
        topic creation stay open: the invariant is write exclusivity."""
        token = token if token is not None else object()
        with self._lock:
            self._owned[prefix] = token
        return token

    @contextlib.contextmanager
    def producer_grant(self, token: object):
        """Authorize this thread to produce to the topics `token`
        restricts for the duration of the block (re-entrant)."""
        held = getattr(_grants, "tokens", None)
        if held is None:
            held = _grants.tokens = []
        held.append(token)
        try:
            yield self
        finally:
            held.pop()

    def _check_producer(self, topic: str) -> None:
        if not self._owned:
            return
        with self._lock:  # snapshot: restrict_topic may race a produce
            owned = list(self._owned.items())
        for prefix, token in owned:
            if topic.startswith(prefix) and \
                    token not in getattr(_grants, "tokens", ()):
                raise TopicOwnershipError(
                    f"topic {topic!r} is engine-owned (prefix {prefix!r}): "
                    f"produce requires the owner's grant "
                    f"(Broker.producer_grant)")

    # ------------------------------------------------------------- topics
    def _make_partition(self, topic: str, partition: int):
        if self.store is not None:
            return _DurablePartition(self.store.log_for(topic, partition))
        return _Partition()

    def create_topic(self, name: str, partitions: int = 1,
                     retention_messages: Optional[int] = None,
                     retention_bytes: Optional[int] = None,
                     retention_ms: Optional[int] = None,
                     cleanup_policy: str = "delete") -> TopicSpec:
        """Create a topic (idempotent: an existing topic is returned as
        it is).  A negative retention bound, or a cleanup policy other
        than "delete" or "compact", raises ValueError.  0 is kept apart
        from None (see ``TopicSpec``)."""
        for what, bound in (("retention_messages", retention_messages),
                            ("retention_bytes", retention_bytes),
                            ("retention_ms", retention_ms)):
            if bound is not None and bound < 0:
                # a negative cap would delete every produced record
                # while producers believe writes succeed
                raise ValueError(f"{what} must be >= 0 or None, got "
                                 f"{bound}")
        if cleanup_policy not in ("delete", "compact"):
            # compaction composes with retention when both are set, so
            # "compact,delete" would be no new semantics
            raise ValueError(f"cleanup_policy must be 'delete' or "
                             f"'compact', got {cleanup_policy!r}")
        with self._lock:
            if name in self._topics:
                return self._topics[name]
            spec = TopicSpec(name, partitions, retention_messages,
                             retention_bytes, retention_ms, cleanup_policy)
            self._topics[name] = spec
            if self.store is not None:
                self.store.register_topic(
                    name, partitions, retention_messages=retention_messages,
                    retention_bytes=retention_bytes,
                    retention_ms=retention_ms,
                    cleanup_policy=cleanup_policy)
            self._parts[name] = [self._make_partition(name, p)
                                 for p in range(partitions)]
            self._rr[name] = 0
            return spec

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._topics)

    def topic(self, name: str) -> TopicSpec:
        """The topic's spec; KeyError if it does not exist."""
        return self._topics[name]

    def _partition_for(self, topic: str, key: Optional[bytes]) -> int:
        n = self._topics[topic].partitions
        if key is None:
            self._rr[topic] = (self._rr[topic] + 1) % n
            return self._rr[topic]
        return zlib.crc32(key) % n

    # ------------------------------------------------------------ produce
    def produce(self, topic: str, value: bytes,
                key: Optional[bytes] = None,
                partition: Optional[int] = None,
                timestamp_ms: int = 0,
                headers: Optional[tuple] = None) -> int:
        """Append one record; returns its offset.  A missing topic is
        created with one partition (Kafka's auto.create)."""
        return self.produce_many(topic, [(key, value, timestamp_ms, headers)],
                                 partition=partition)

    def produce_many(self, topic: str, entries,
                     partition: Optional[int] = None) -> int:
        """Append [(key, value, timestamp_ms[, headers]), ...] under ONE
        lock acquisition; returns the offset of the last record appended
        (-1 for none).  Keyed records go to ``crc32(key) % partitions``,
        unkeyed ones round-robin; retention is enforced once per touched
        partition, which trims to what a trim after every record leaves.
        The optional 4th element is the record's headers.  A topic
        restricted to an owner needs its grant (TopicOwnershipError).

        Durable: each partition's slice is framed in ONE native call
        (``ops.framing.frame_entries``, byte-identical to the per-record
        encoder) and appended as it is; entries with headers, or
        ``IOTML_RAW_PRODUCE=off``, take the per-record encoder.  Either
        way a touched partition is fsynced once (``fsync=always``)
        before this returns, so everything acked is durable."""
        chaos.point("broker.produce")
        self._check_producer(topic)
        entries = list(entries)
        if topic not in self._topics:
            self.create_topic(topic)
        last_off = -1
        fuse = self.store is not None and self._raw_produce_enabled()
        with self._lock:
            parts = self._parts[topic]
            spec = self._topics[topic]
            if fuse and entries and \
                    not any(len(e) > 3 and e[3] for e in entries):
                from ..ops.framing import frame_entries

                by_part: Dict[int, list] = {}
                last_p = partition
                if partition is None:
                    for entry in entries:
                        p = self._partition_for(topic, entry[0])
                        by_part.setdefault(p, []).append(entry)
                        last_p = p
                else:
                    by_part[partition] = entries
                ends: Dict[int, int] = {}
                for p, ents in by_part.items():
                    part = parts[p]
                    base = part.end()
                    blob = frame_entries(ents, base)
                    part.append_raw(blob, len(ents), base,
                                    base + len(ents) - 1,
                                    max(e[2] for e in ents), sync=False)
                    ends[p] = base + len(ents) - 1
                    part.sync_batch()
                    part.enforce_retention(spec)
                # the offset the FINAL entry landed at, as below
                return ends[last_p]
            touched = set()
            for entry in entries:
                key, value, ts = entry[0], entry[1], entry[2]
                p = self._partition_for(topic, key) if partition is None \
                    else partition
                last_off = parts[p].append(
                    key, value, ts, entry[3] if len(entry) > 3 else None,
                    sync=False)
                touched.add(p)
            for p in touched:
                # one fsync a touched partition (fsync=always) before the
                # ack; untouched partitions cannot have grown past their
                # caps
                parts[p].sync_batch()
                parts[p].enforce_retention(spec)
        return last_off

    @staticmethod
    def _raw_produce_enabled() -> bool:
        """IOTML_RAW_PRODUCE: on/auto fuse the durable framing, off takes
        the per-record encoder (the debug escape hatch)."""
        from ..data.pipeline import raw_produce_mode

        return raw_produce_mode() != "off"

    def produce_batch(self, topic: str, values, key=None,
                      partition=None) -> int:
        """Append many records; returns the offset of the last one."""
        return self.produce_many(topic, [(key, v, 0) for v in values],
                                 partition=partition)

    def produce_raw(self, topic: str, partition: int, frames: bytes) -> int:
        """Append a PRE-FRAMED batch (contiguous store frames, offsets
        unstamped): the RAW_PRODUCE landing.  Every frame's CRC is
        validated and the log offsets are stamped into the heads in one
        engine call (``ops.framing.restamp_frame_batch``); a durable
        partition then appends the batch's own bytes, the in-memory one
        decodes it into its list.  Returns the batch's base offset.  A
        torn or corrupt batch raises ``CorruptMessageError`` before any
        byte lands.  Not idempotent: the caller owns redelivery, as with
        ``produce``."""
        from ..ops import framing

        act = chaos.point("broker.produce_raw")
        if act is not None and act.kind == "corrupt":
            # seeded corruption of the batch in flight: one flipped byte
            # must reject the whole batch with nothing landed
            mangled = bytearray(frames)
            if mangled:
                mangled[len(mangled) // 2] ^= 0xFF
            frames = bytes(mangled)
        self._check_producer(topic)
        if topic not in self._topics:
            self.create_topic(topic, partitions=max(partition + 1, 1))
        part = self._parts[topic][partition]
        with self._lock:
            base = part.end()
            try:
                stamped, count, max_ts = framing.restamp_frame_batch(
                    frames, base)
            except framing.CorruptFrameError as e:
                raise CorruptMessageError(topic, partition, e.index) from e
            if count:
                part.append_raw(stamped, count, base, base + count - 1,
                                max_ts, sync=False)
                part.sync_batch()
                part.enforce_retention(self._topics[topic])
        return base

    def produce_raw_at(self, topic: str, partition: int,
                       frames: bytes) -> int:
        """Append a raw frame batch AT its own stamped offsets: a
        follower's mirror of a RAW_FETCH batch (the leader's offsets are
        already in the heads).  The batch is validated whole (a torn
        tail refuses it too), then a durable partition appends its bytes
        as they are, holes reproduced; the in-memory one decodes it and
        takes only a gap-free continuation.  Returns the last offset
        appended (-1 for an empty batch)."""
        from ..ops import framing

        self._check_producer(topic)
        if topic not in self._topics:
            self.create_topic(topic, partitions=max(partition + 1, 1))
        try:
            v = framing.validate_frame_batch(frames, strict=True)
        except framing.CorruptFrameError as e:
            raise CorruptMessageError(topic, partition, e.index) from e
        if not v["count"]:
            return -1
        part = self._parts[topic][partition]
        with self._lock:
            end = part.end()
            if v["first"] < end:
                raise ValueError(
                    f"raw mirror batch for {topic}:{partition} starts at "
                    f"{v['first']} behind log end {end}: offsets only "
                    f"move forward")
            part.append_raw(frames, v["count"], v["first"], v["last"],
                            v["max_ts"], sync=False)
            part.sync_batch()
            part.enforce_retention(self._topics[topic])
        return v["last"]

    def produce_at(self, topic: str, partition: int, offset: int,
                   value: Optional[bytes], key: Optional[bytes] = None,
                   timestamp_ms: int = 0,
                   headers: Optional[tuple] = None) -> int:
        """Append one record AT an explicit offset at or after the log
        end: a follower's per-record mirror of a compacted topic, whose
        fetched batches carry offset holes.  A durable partition
        reproduces a forward jump; the in-memory one takes only a
        gap-free continuation (ValueError otherwise)."""
        self._check_producer(topic)
        if topic not in self._topics:
            self.create_topic(topic)
        with self._lock:
            return self._parts[topic][partition].append_at(
                offset, key, value, timestamp_ms, headers)

    # --------------------------------------------------------- compaction
    def run_compaction(self, force: bool = False) -> Dict[tuple, object]:
        """One compaction pass over every ``cleanup_policy="compact"``
        topic partition (durable broker only: the in-memory backend has
        nothing durable to reclaim).  Applies the dirty-ratio gate unless
        ``force``; returns {(topic, partition): CompactionStats} of the
        partitions it rewrote.  Whole passes serialize on their own lock;
        the data lock is taken only around each segment swap, so produce
        and fetch proceed through a pass."""
        if self.store is None:
            return {}
        out: Dict[tuple, object] = {}
        pol = self.store.policy
        with self._compact_pass_lock:
            with self._lock:
                compacted = [(name, spec)
                             for name, spec in self._topics.items()
                             if spec.cleanup_policy == "compact"]
            for name, spec in compacted:
                for p in range(spec.partitions):
                    # a shard's unowned placeholder holds no log
                    slog = getattr(self._parts[name][p], "slog", None)
                    if slog is None:
                        continue
                    if not force and slog.dirty_ratio() < \
                            pol.compact_min_dirty_ratio:
                        continue
                    stats = slog.compact(grace_ms=pol.compact_grace_ms,
                                         lock=self._lock)
                    if stats.segments_rewritten:
                        out[(name, p)] = stats
        return out

    def run_tiering(self) -> Dict[tuple, dict]:
        """One tiering pass over every tiered partition (a durable broker
        mounted with a tier): upload sealed segments to the remote tier,
        evict the hot tier past its byte budget, enforce remote
        retention, sweep unreferenced blobs.  Returns {(topic,
        partition): stats} of the partitions that did anything.  On a
        replicated leader only bytes below the quorum HWM tier out (a
        record a failover could un-write never reaches the remote tier).
        Blob I/O runs outside the data lock; whole passes serialize on
        their own lock."""
        if self.store is None:
            return {}
        out: Dict[tuple, dict] = {}
        with self._tier_pass_lock:
            with self._lock:
                tiered = [(name, p, part.slog)
                          for name, parts in self._parts.items()
                          for p, part in enumerate(parts)
                          if getattr(getattr(part, "slog", None), "remote",
                                     None) is not None]
            for name, p, slog in tiered:
                ceiling = None
                if self.replication is not None:
                    ceiling = self.replication.fetch_ceiling(name, p)
                stats = slog.tier_sync(ceiling=ceiling, lock=self._lock)
                if any(stats.values()):
                    out[(name, p)] = stats
        return out

    # -------------------------------------------------------------- fetch
    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].end()

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].base()

    def offset_for_timestamp(self, topic: str, partition: int,
                             timestamp_ms: int) -> int:
        """Earliest offset whose record timestamp is >= ``timestamp_ms``
        (the end offset when there is none): ListOffsets by timestamp."""
        part = self._parts[topic][partition]
        with self._lock:
            return part.offset_for_timestamp(timestamp_ms)

    def align_base_offset(self, topic: str, partition: int,
                          offset: int) -> None:
        """Start an EMPTY partition at ``offset``: a follower of a leader
        whose head retention already trimmed appends the first copied
        record at the leader's earliest retained offset, so offsets stay
        identical across the pair (cursors survive a failover)."""
        part = self._parts[topic][partition]
        with self._lock:
            part.align_base(offset)

    def reset_partition(self, topic: str, partition: int,
                        base_offset: int) -> None:
        """Drop a partition's log and restart it at ``base_offset``: a
        follower realigns so when the leader's retention outran it
        (appending past the gap at the local end would shift every later
        offset)."""
        part = self._parts[topic][partition]
        with self._lock:
            part.reset(base_offset)

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        """Read up to max_messages starting at offset (no blocking).  A
        fetch below the retained base raises OffsetOutOfRangeError.  On a
        replicated leader a consumer's read stops at the quorum
        high-water mark: a record a failover could un-write is never
        observed (followers read with ``fetch_tail``)."""
        msgs = self.fetch_tail(topic, partition, offset, max_messages)
        repl = self.replication
        if repl is not None and msgs:
            ceiling = repl.fetch_ceiling(topic, partition)
            if ceiling is not None and msgs[-1].offset >= ceiling:
                msgs = [m for m in msgs if m.offset < ceiling]
        return msgs

    def fetch_tail(self, topic: str, partition: int, offset: int,
                   max_messages: int = 1024) -> List[Message]:
        """``fetch`` without the quorum read barrier: the follower's
        mirror leg."""
        chaos.point("broker.fetch")  # before the lock: a chaos stall must
        # park this fetcher, never every thread contending the broker
        part = self._parts[topic][partition]
        with self._lock:
            base = part.base()
            if offset < base:
                raise OffsetOutOfRangeError(topic, partition, offset, base)
            chunk = part.read(offset, max_messages) \
                if isinstance(part, _Partition) else None
        if chunk is None:
            # durable: disk I/O OUTSIDE the lock (one cold read must not
            # park every producer and fetcher).  The log reads a
            # snapshot; the only race is retention passing ``offset``
            # mid-read, signalled again here.
            try:
                chunk = part.read(offset, max_messages)
            except LookupError:
                raise OffsetOutOfRangeError(topic, partition, offset,
                                            part.base()) from None
        return [Message(topic, partition, off, value, key, ts, hdrs)
                for off, key, value, ts, hdrs in chunk]

    def fetch_raw(self, topic: str, partition: int, offset: int,
                  max_bytes: int = 1 << 20):
        """Up to ~``max_bytes`` of contiguous store frames from ``offset``
        as a ``RawFrameBatch``: no ``Message`` list, no per-record
        object.  A durable partition serves its segment's bytes (read
        outside the lock, like ``fetch``: the batch may start at the
        sparse-index entry before ``offset`` and end mid-frame); the
        in-memory one re-frames its slice.  None at the log end;
        ``OffsetOutOfRangeError`` below the retained base.  On a
        replicated leader the batch is cut at the frame boundary below
        the quorum HWM."""
        raw = self.fetch_raw_tail(topic, partition, offset, max_bytes)
        repl = self.replication
        if raw is not None and repl is not None:
            ceiling = repl.fetch_ceiling(topic, partition)
            if ceiling is not None and \
                    self._parts[topic][partition].end() > ceiling:
                # an un-replicated tail exists: the batch may cross it
                if offset >= ceiling:
                    return None
                from ..ops.framing import RawFrameBatch, truncate_frame_batch

                data = truncate_frame_batch(raw.data, ceiling)
                if not data:
                    return None
                raw = RawFrameBatch(topic, partition, raw.start_offset, data)
        return raw

    def fetch_raw_tail(self, topic: str, partition: int, offset: int,
                       max_bytes: int = 1 << 20):
        """``fetch_raw`` without the quorum read barrier: the follower's
        zero-copy mirror leg."""
        from ..ops.framing import RawFrameBatch

        chaos.point("broker.fetch")  # a raw batch is one fetch to chaos
        part = self._parts[topic][partition]
        with self._lock:
            base = part.base()
            if offset < base:
                raise OffsetOutOfRangeError(topic, partition, offset, base)
            res = part.read_raw(offset, max_bytes) \
                if isinstance(part, _Partition) else False
        if res is False:
            try:
                res = part.read_raw(offset, max_bytes)
            except LookupError:
                raise OffsetOutOfRangeError(topic, partition, offset,
                                            part.base()) from None
        if res is None:
            return None
        data, start = res
        return RawFrameBatch(topic, partition, start, data)

    def read_since(self, topic: str, partition: int, timestamp_ms: int,
                   max_messages: int = 1024) -> List[Message]:
        """Replay from the first record at or after ``timestamp_ms``: how
        ``ContinuousTrainer`` backfills history on a cold start."""
        offset = self.offset_for_timestamp(topic, partition, timestamp_ms)
        for _ in range(3):
            try:
                msgs = self.fetch(topic, partition, offset, max_messages)
                break
            except OffsetOutOfRangeError as e:
                # raced a retention trim between the lookup and the read:
                # skip ahead like every other fetch caller
                offset = e.earliest
        else:
            msgs = []
        if msgs:
            # iotml_store_replay_records_total: the durable backend only
            self._parts[topic][partition].note_replay(len(msgs))
        return msgs

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        with self._lock:
            self._group_offsets[(group, topic, partition)] = next_offset
            if self.store is not None:
                self.store.offsets.commit(group, topic, partition,
                                          next_offset)

    def commit_many(self, group: str, topic: str, entries) -> None:
        """Commit [(partition, next_offset), ...] of one topic under one
        lock acquisition (``StreamConsumer.commit``'s path) and, durable,
        one offsets-file fsync."""
        entries = list(entries)
        with self._lock:
            for p, off in entries:
                self._group_offsets[(group, topic, p)] = off
            if self.store is not None:
                self.store.offsets.commit_many(group, topic, entries)

    def committed(self, group: str, topic: str,
                  partition: int) -> Optional[int]:
        with self._lock:
            return self._group_offsets.get((group, topic, partition))

    def committed_many(self, group: str, pairs) -> Dict[tuple, int]:
        """Committed offsets of [(topic, partition), ...] under one lock
        acquisition; pairs with nothing committed are left out."""
        out = {}
        with self._lock:
            for t, p in pairs:
                off = self._group_offsets.get((group, t, p))
                if off is not None:
                    out[(t, p)] = off
        return out

    # ---------------------------------------------------------- lifecycle
    def flush(self) -> None:
        """Durable broker: fsync every partition log and the offsets file
        (no-op in memory)."""
        if self.store is not None:
            with self._lock:
                self.store.flush()

    def close(self) -> None:
        """Release the durable backend's files and its directory lock
        (the clean restart path; crash recovery handles the unclean one).
        No-op in memory."""
        if self.store is not None:
            with self._lock:
                self.store.close()
