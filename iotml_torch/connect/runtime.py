"""Kafka-Connect-equivalent runtime: sources and sinks around the broker
(``iotml.connect.runtime``'s copy).

The reference runs a two-node Connect cluster hosting three connectors
(SURVEY §2.2): a FileStreamSource replaying the test CSV
(`testdata/Test-Load-csv/file_stream_demo_standalone.properties`), a MongoDB
sink building the digital twin (`infrastructure/kafka-connect/mongodb/`),
and a GCS sink archiving the Avro topic
(`infrastructure/kafka-connect/gcs/`).  The runtime contract those share is
what this module provides: named connector instances driven by a worker,
sink progress tracked through consumer-group commits (a restarted worker
resumes from them), and single-message transforms (SMTs) applied between
the log and the sink.

Incremental (`run_once`) like `streamproc.tasks`, so tests and drivers
interleave connectors with producers deterministically; `run_forever` is the
daemon form.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

from ..stream.broker import Broker, Message
from ..stream.consumer import StreamConsumer


@dataclasses.dataclass
class SourceRecord:
    """What a source connector emits: destination topic + key/value."""

    topic: str
    value: bytes
    key: Optional[bytes] = None


class SourceConnector:
    """Produce records into the broker.  Subclasses implement `poll()`
    returning a list of SourceRecord ([] = nothing new) and may persist
    position via `state()` / `restore(state)`."""

    def poll(self) -> List[SourceRecord]:  # pragma: no cover - interface
        raise NotImplementedError

    def state(self) -> dict:
        return {}

    def restore(self, state: dict) -> None:
        pass


class SinkConnector:
    """Consume records from the broker.  `put(messages)` handles a batch;
    `flush()` makes side effects durable (called after each drained run)."""

    def put(self, messages: Sequence[Message]) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass


@dataclasses.dataclass
class _SourceEntry:
    name: str
    connector: SourceConnector


@dataclasses.dataclass
class _SinkEntry:
    name: str
    connector: SinkConnector
    consumer: StreamConsumer
    transforms: tuple


class ConnectWorker:
    """Drives registered connectors against one broker."""

    def __init__(self, broker: Broker):
        self.broker = broker
        self._sources: List[_SourceEntry] = []
        self._sinks: List[_SinkEntry] = []

    def add_source(self, name: str, connector: SourceConnector) -> None:
        self._sources.append(_SourceEntry(name, connector))

    def add_sink(self, name: str, connector: SinkConnector,
                 topics: Sequence[str],
                 transforms: Sequence[Callable[[Message], Message]] = (),
                 from_committed: bool = True) -> None:
        """transforms: SMT chain applied to each message before `put`.
        Sink progress rides the consumer group `connect-<name>`, so a
        restarted worker resumes from the last commit."""
        group = f"connect-{name}"
        specs = []
        for t in topics:
            self.broker.create_topic(t)
            n = self.broker.topic(t).partitions
            for p in range(n):
                off = self.broker.committed(group, t, p) if from_committed \
                    else None
                specs.append(f"{t}:{p}:{off if off is not None else 0}")
        consumer = StreamConsumer(self.broker, specs, group=group)
        self._sinks.append(_SinkEntry(name, connector, consumer,
                                      tuple(transforms)))

    def remove(self, name: str) -> bool:
        """Unregister a connector by name (Connect's DELETE).  Sink progress
        stays committed under `connect-<name>`, so re-adding the connector
        resumes where it left off."""
        n0 = len(self._sources) + len(self._sinks)
        self._sources = [s for s in self._sources if s.name != name]
        self._sinks = [k for k in self._sinks if k.name != name]
        return len(self._sources) + len(self._sinks) < n0

    # ------------------------------------------------------------- driving
    def run_once(self, max_messages: int = 4096) -> Dict[str, int]:
        """One pass: drain every source, then deliver available messages to
        every sink (committing after put + flush).  Returns per-connector
        record counts."""
        counts: Dict[str, int] = {}
        for s in self._sources:
            produced = 0
            # bounded drain: a source tailing a growing file must not
            # starve the sinks (leftovers flow on the next pass)
            while produced < max_messages:
                records = s.connector.poll()
                if not records:
                    break
                for r in records:
                    self.broker.produce(r.topic, r.value, key=r.key)
                produced += len(records)
            counts[s.name] = produced
        for k in self._sinks:
            delivered = 0
            while True:
                msgs = k.consumer.poll(max_messages)
                if not msgs:
                    break
                for t in k.transforms:
                    msgs = [t(m) for m in msgs]
                k.connector.put(msgs)
                delivered += len(msgs)
            k.connector.flush()
            k.consumer.commit()
            counts[k.name] = delivered
        return counts

    def run_forever(self, poll_interval_s: float = 0.5,
                    should_stop: Optional[Callable[[], bool]] = None) -> None:
        while not (should_stop and should_stop()):
            self.run_once()
            time.sleep(poll_interval_s)
