"""In-process broker (``iotml.stream.broker``'s in-memory ``Broker``).

The reference's data plane is a Confluent deployment (topics
``sensor-data`` / ``model-predictions``, reference
``01_installConfluentPlatform.sh:180-183``).  This is its in-process
equivalent: a partitioned, offset-addressed append-only log with
retention by message count, by bytes and by record age, and
consumer-group offset storage (one commit or fetch of many partitions
under one lock), so the port's train and score jobs run against it
unchanged.  Keyed records go to ``crc32(key) % partitions``, unkeyed ones
round-robin, as in the JAX package.

One lock guards all mutation and ``fetch``; every append goes through
``produce_many``, which takes it once for a whole batch (the wire
server's produce path and the ordered write-back).  Records carry
optional headers (``Message.headers``, the trace context's carrier, as
the JAX broker's do); ``produce``/``produce_many`` pass the chaos point
``broker.produce`` once a call and ``fetch`` passes ``broker.fetch``.
The durable segmented store, raw frame batches, compaction, tiering and
topic ownership are not ported.
"""

from __future__ import annotations

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
    """A topic's partition count and its retention bounds per partition:
    messages, payload bytes (value + key), and age in ms behind the
    newest record's timestamp (None or 0 = unbounded)."""

    name: str
    partitions: int = 1
    retention_messages: Optional[int] = None
    retention_bytes: Optional[int] = None
    retention_ms: Optional[int] = None


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

    def append(self, key, value, ts, headers=None) -> int:
        self.log.append((key, value, ts, headers))
        self.bytes += _size(key, value)
        if ts > self.max_ts:
            self.max_ts = ts
        return self.base_offset + len(self.log) - 1

    def end(self) -> int:
        return self.base_offset + len(self.log)

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


class Broker:
    """Partitioned in-memory commit log with Kafka-shaped semantics."""

    def __init__(self):
        self._lock = threading.Lock()
        self._topics: Dict[str, TopicSpec] = {}
        self._parts: Dict[str, List[_Partition]] = {}
        # (group, topic, partition) → next offset
        self._group_offsets: Dict[tuple, int] = {}
        self._rr: Dict[str, int] = {}  # round-robin cursor per topic

    # ------------------------------------------------------------- topics
    def create_topic(self, name: str, partitions: int = 1,
                     retention_messages: Optional[int] = None,
                     retention_bytes: Optional[int] = None,
                     retention_ms: Optional[int] = None) -> TopicSpec:
        """Create a topic (idempotent: an existing topic is returned as
        it is).  A negative retention bound raises ValueError."""
        for what, bound in (("retention_messages", retention_messages),
                            ("retention_bytes", retention_bytes),
                            ("retention_ms", retention_ms)):
            if bound is not None and bound < 0:
                # a negative cap would delete every produced record
                # while producers believe writes succeed
                raise ValueError(f"{what} must be >= 0 or None, got "
                                 f"{bound}")
        with self._lock:
            if name in self._topics:
                return self._topics[name]
            spec = TopicSpec(name, partitions, retention_messages,
                             retention_bytes, retention_ms)
            self._topics[name] = spec
            self._parts[name] = [_Partition() for _ in range(partitions)]
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
        The optional 4th element is the record's headers."""
        chaos.point("broker.produce")
        entries = list(entries)
        if topic not in self._topics:
            self.create_topic(topic)
        last_off = -1
        with self._lock:
            parts = self._parts[topic]
            touched = set()
            for entry in entries:
                key, value, ts = entry[0], entry[1], entry[2]
                p = self._partition_for(topic, key) if partition is None \
                    else partition
                last_off = parts[p].append(
                    key, value, ts, entry[3] if len(entry) > 3 else None)
                touched.add(p)
            for p in touched:
                # untouched partitions cannot have grown past their caps
                parts[p].enforce_retention(self._topics[topic])
        return last_off

    def produce_batch(self, topic: str, values, key=None,
                      partition=None) -> int:
        """Append many records; returns the offset of the last one."""
        return self.produce_many(topic, [(key, v, 0) for v in values],
                                 partition=partition)

    # -------------------------------------------------------------- fetch
    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].end()

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].base_offset

    def offset_for_timestamp(self, topic: str, partition: int,
                             timestamp_ms: int) -> int:
        """Earliest offset whose record timestamp is >= ``timestamp_ms``
        (the end offset when there is none): ListOffsets by timestamp."""
        part = self._parts[topic][partition]
        with self._lock:
            return part.offset_for_timestamp(timestamp_ms)

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        """Read up to max_messages starting at offset (no blocking).  A
        fetch below the retained base raises OffsetOutOfRangeError."""
        chaos.point("broker.fetch")  # before the lock: a chaos stall must
        # park this fetcher, never every thread contending the broker
        part = self._parts[topic][partition]
        with self._lock:
            if offset < part.base_offset:
                raise OffsetOutOfRangeError(topic, partition, offset,
                                            part.base_offset)
            chunk = part.read(offset, max_messages)
        return [Message(topic, partition, off, value, key, ts, hdrs)
                for off, key, value, ts, hdrs in chunk]

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        with self._lock:
            self._group_offsets[(group, topic, partition)] = next_offset

    def commit_many(self, group: str, topic: str, entries) -> None:
        """Commit [(partition, next_offset), ...] of one topic under one
        lock acquisition (``StreamConsumer.commit``'s path)."""
        with self._lock:
            for p, off in entries:
                self._group_offsets[(group, topic, p)] = off

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
