"""In-process broker (``iotml.stream.broker``'s in-memory ``Broker``).

The reference's data plane is a Confluent deployment (topics
``sensor-data`` / ``model-predictions``, reference
``01_installConfluentPlatform.sh:180-183``).  This is its in-process
equivalent: a partitioned, offset-addressed append-only log with a
message-count retention bound and consumer-group offset storage, so the port's
train and score jobs run against it unchanged.  Keyed records go to
``crc32(key) % partitions``, unkeyed ones round-robin, as in the JAX
package.

One lock guards all mutation and ``fetch``.  The durable segmented store,
raw frame batches, retention by bytes or by age, compaction, tiering,
topic ownership and chaos points are not ported.
"""

from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, List, NamedTuple, Optional


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


class Message(NamedTuple):
    """One record as fetched from a partition log."""

    topic: str
    partition: int
    offset: int
    value: bytes
    key: Optional[bytes] = None
    timestamp_ms: int = 0


@dataclasses.dataclass
class TopicSpec:
    """A topic's partition count and its retention bound in messages per
    partition (None or 0 = unbounded)."""

    name: str
    partitions: int = 1
    retention_messages: Optional[int] = None


class _Partition:
    """One partition: the list-backed log."""

    __slots__ = ("log", "base_offset")

    def __init__(self):
        self.log: List[tuple] = []  # (key, value, ts)
        self.base_offset = 0  # offset of log[0] after retention trimming

    def append(self, key, value, ts) -> int:
        self.log.append((key, value, ts))
        return self.base_offset + len(self.log) - 1

    def end(self) -> int:
        return self.base_offset + len(self.log)

    def read(self, offset: int, max_messages: int) -> List[tuple]:
        """[(offset, key, value, ts)] from `offset`."""
        idx = offset - self.base_offset
        return [(offset + i, key, value, ts) for i, (key, value, ts)
                in enumerate(self.log[idx:idx + max_messages])]

    def enforce_retention(self, spec: TopicSpec) -> None:
        drop = len(self.log) - (spec.retention_messages or len(self.log))
        if drop > 0:
            del self.log[:drop]
            self.base_offset += drop


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
                     retention_messages: Optional[int] = None) -> TopicSpec:
        """Create a topic (idempotent: an existing topic is returned as
        it is).  A negative retention bound raises ValueError."""
        if retention_messages is not None and retention_messages < 0:
            # a negative cap would delete every produced record while
            # producers believe writes succeed
            raise ValueError(f"retention_messages must be >= 0 or None, "
                             f"got {retention_messages}")
        with self._lock:
            if name in self._topics:
                return self._topics[name]
            spec = TopicSpec(name, partitions, retention_messages)
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
                timestamp_ms: int = 0) -> int:
        """Append one record; returns its offset.  A missing topic is
        created with one partition (Kafka's auto.create)."""
        if topic not in self._topics:
            self.create_topic(topic)
        with self._lock:
            p = self._partition_for(topic, key) if partition is None \
                else partition
            part = self._parts[topic][p]
            off = part.append(key, value, timestamp_ms)
            part.enforce_retention(self._topics[topic])
            return off

    def produce_batch(self, topic: str, values, key=None,
                      partition=None) -> int:
        """Append many records; returns the offset of the last one."""
        off = -1
        for v in values:
            off = self.produce(topic, v, key=key, partition=partition)
        return off

    # -------------------------------------------------------------- fetch
    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].end()

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._parts[topic][partition].base_offset

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        """Read up to max_messages starting at offset (no blocking).  A
        fetch below the retained base raises OffsetOutOfRangeError."""
        part = self._parts[topic][partition]
        with self._lock:
            if offset < part.base_offset:
                raise OffsetOutOfRangeError(topic, partition, offset,
                                            part.base_offset)
            chunk = part.read(offset, max_messages)
        return [Message(topic, partition, off, value, key, ts)
                for off, key, value, ts in chunk]

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        with self._lock:
            self._group_offsets[(group, topic, partition)] = next_offset

    def committed(self, group: str, topic: str,
                  partition: int) -> Optional[int]:
        with self._lock:
            return self._group_offsets.get((group, topic, partition))
