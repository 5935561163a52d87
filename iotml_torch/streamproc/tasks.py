"""KSQL-equivalent continuous stream transforms
(``iotml.streamproc.tasks``'s copy).

The reference preprocesses broker-side with four KSQL objects
(``01_installConfluentPlatform.sh:229-258``):

  SENSOR_DATA_S                 JSON stream over ``sensor-data`` (19 columns)
  SENSOR_DATA_S_AVRO            CSAS: JSON → AVRO (the ML input topic)
  SENSOR_DATA_S_AVRO_REKEY      CSAS: re-key by CAR (ROWKEY → partition key)
  SENSOR_DATA_EVENTS_PER_5MIN_T CTAS: tumbling 5-min event count per car

Here each is a ``StreamTask``: an offset-cursored consumer plus a pure
``process(messages) → [(key, value, ts)]`` step appended to an output
topic.  Tasks are incremental (``process_available()``) and restart from
their consumer group's commits: KSQL's continuous-query semantics,
in-process.  A task may also have a raw produce leg (``process_raw``
over its ``raw_producer``, a ``stream.producer.RawBatchProducer``): the
chunk's outputs framed once, at conversion, and shipped as pre-framed
batches (``Broker.produce_raw`` / RAW_PRODUCE), appended as they are.
Untraced sessions only, since the record headers ride the classic leg;
the records on the topic are the same either way.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA
from ..obs import tracing
from ..ops.avro import AvroCodec
from ..ops.framing import frame
from ..stream.broker import Broker, Message
from ..stream.consumer import StreamConsumer
from . import dlq as _dlq


class StreamTask:
    """Continuous transform: src topic → process() → dst topic."""

    def __init__(self, broker: Broker, src: str, dst: str,
                 partitions: int = 1, group: Optional[str] = None,
                 src_partitions: Optional[int] = None, consumer=None):
        self.broker = broker
        self.src = src
        self.dst = dst
        #: the RawBatchProducer of the raw produce leg, built at first use
        self._raw_producer = None
        broker.create_topic(dst, partitions=partitions)
        if consumer is not None:
            # injected cursor: a GroupConsumer makes the task group-
            # elastic (instances of one task split the source partitions)
            self.consumer = consumer
        else:
            n_src = src_partitions if src_partitions is not None \
                else broker.topic(src).partitions
            # resume from committed group offsets so a restarted task
            # does not re-emit already-transformed records (KSQL's
            # continuous-query restart semantics)
            self.consumer = StreamConsumer.from_committed(
                broker, src, list(range(n_src)),
                group=group or f"task-{dst}", fallback_offset=0, eof=True)

    def process(self, messages: List[Message]) -> List[Tuple]:
        """Return [(key, value, timestamp_ms)] outputs."""
        raise NotImplementedError

    def raw_producer(self):
        """The task's ``RawBatchProducer`` for its output topic (built at
        first use), with the fallback ladder of ``IOTML_RAW_PRODUCE``."""
        if self._raw_producer is None:
            from ..stream.producer import RawBatchProducer

            self._raw_producer = RawBatchProducer(self.broker, self.dst)
        return self._raw_producer

    def process_raw(self, messages: List[Message]) -> Optional[int]:
        """The raw produce hook: transform ``messages`` and ship the
        outputs as pre-framed raw batches, returning the records emitted,
        or None to take ``process`` + ``produce_many`` for the chunk (the
        base task has no raw leg).  Consulted on untraced sessions only:
        trace headers ride the classic per-record leg."""
        return None

    def dead_letter(self, message: Message, error) -> None:
        """Route one poisoned input to `<src>_DLQ` instead of silently
        dropping it (counted under iotml_dlq_total{source=...}); a
        failing DLQ path degrades back to the plain drop."""
        _dlq.route(self.broker, message, str(error),
                   task=type(self).__name__)

    def _forward_traces(self, msgs, outs):
        """Re-attach trace headers to a chunk's outputs and mark the
        `streamproc` stage.  Tasks emit (key, value, ts) without their
        source messages, so forwarding happens HERE, positionally — sound
        only for 1:1 chunks (every task builds outputs in input order).
        Filtering chunks (row drops) lose the association and the trace
        simply ends at this stage: graceful degradation, sampled traces
        are statistics, not an audit log.

        The output carries a FORK of the input's context, marked on this
        task's lineage — never a mark on the shared input object: the
        input topic's other consumers (a sibling task, a batcher) fork
        from the same header, and mutating its t_last after handoff
        would skew their spans by a stage their pipeline never ran."""
        if len(outs) != len(msgs):
            return outs
        fwd = []
        for m, out in zip(msgs, outs):
            ctx = tracing.from_headers(m.headers) if m.headers else None
            if ctx is not None:
                hop = ctx.fork()
                hop.mark("streamproc")
                fwd.append((out[0], out[1], out[2],
                            tracing.headers_for(hop)))
            else:
                fwd.append(out)
        return fwd

    def process_available(self, chunk: int = 4096) -> int:
        """Consume and transform everything currently available.

        Offsets are committed after EACH successfully processed chunk (not
        only at end-of-stream), so a failure in a later chunk — with the
        engine's rewind-to-committed retry — re-emits at most the failed
        chunk, never the whole backlog."""
        n = 0
        while True:
            msgs = self.consumer.poll(chunk)
            if not msgs:
                self.consumer.commit()
                return n
            if not tracing.ENABLED:
                # the raw produce leg, for tasks that have one
                handled = self.process_raw(msgs)
                if handled is not None:
                    n += handled
                    self.consumer.commit()
                    continue
            outs = self.process(msgs)
            if outs:
                if tracing.ENABLED:
                    outs = self._forward_traces(msgs, outs)
                # one bulk append per chunk; per-record semantics
                # (key-hash partitioning, append order, retention) by
                # produce_many's contract
                self.broker.produce_many(self.dst, outs)
                n += len(outs)
            self.consumer.commit()


class JsonToAvro(StreamTask):
    """SENSOR_DATA_S_AVRO: JSON sensor records → Confluent-framed Avro.

    Field matching is case-insensitive and accepts both producer names
    (`tire_pressure_1_1`) and KSQL names (`TIRE_PRESSURE11`), mirroring
    KSQL's case-insensitive column resolution.

    ``schema_version=2`` writes the evolved schema (REGION cohort tag,
    `core.schema.KSQL_CAR_SCHEMA_V2`) framed under its own id — the
    rolling-upgrade shape where SOME converter instances emit the new
    schema onto the live topic while v1 readers keep consuming it
    through Avro schema resolution (`ops.avro.ResolvingCodec`).
    """

    def __init__(self, broker: Broker, src: str = "sensor-data",
                 dst: str = "SENSOR_DATA_S_AVRO",
                 schema_version: int = 1, **kw):
        super().__init__(broker, src, dst, **kw)
        from ..core.schema import WRITER_VERSIONS

        if schema_version not in WRITER_VERSIONS:
            raise ValueError(f"unknown writer schema version "
                             f"{schema_version} "
                             f"(have: {sorted(WRITER_VERSIONS)})")
        self.schema, self.schema_id = WRITER_VERSIONS[schema_version]
        self.codec = AvroCodec(self.schema)
        # lookup: lowercase alias → KSQL field name
        self._alias: Dict[str, str] = {}
        for f_prod, f_ksql in zip(CAR_SCHEMA.fields,
                                  self.schema.sensor_fields):
            self._alias[f_prod.name.lower()] = f_ksql.name
            self._alias[f_ksql.name.lower()] = f_ksql.name
        self._alias["failure_occurred"] = "FAILURE_OCCURRED"
        for name in self.schema.meta_fields:  # v2: region → REGION
            self._alias[name.lower()] = name

    def process(self, messages):
        out = []
        for m in messages:
            try:
                obj = json.loads(m.value)
                if not isinstance(obj, dict):
                    raise ValueError(f"expected JSON object, got "
                                     f"{type(obj).__name__}")
                rec = {}
                for k, v in obj.items():
                    name = self._alias.get(k.lower())
                    if name is None:
                        continue
                    f = self.schema.field(name)
                    if v is None:
                        rec[name] = None
                    elif f.avro_type in ("int", "long"):
                        rec[name] = int(v)
                    elif f.avro_type == "string":
                        rec[name] = str(v)
                    else:
                        rec[name] = float(v)
                val = frame(self.codec.encode(rec), self.schema_id)
            except (ValueError, TypeError, KeyError) as e:
                # poisoned sensor JSON dead-letters and the stream
                # keeps flowing
                self.dead_letter(m, e)
                continue
            out.append((m.key, val, m.timestamp_ms))
        return out


class RekeyByCar(StreamTask):
    """SENSOR_DATA_S_AVRO_REKEY: partition the stream by car id.

    The reference's `SELECT ROWKEY as CAR, * ... PARTITION BY CAR`: the MQTT
    client id rides as the message key, so re-keying is routing every record
    to the key-hashed partition of the output topic (keyed partitioning in
    `Broker.produce`), giving per-car ordering — the property sequence models
    need.
    """

    def process(self, messages):
        return [(m.key, m.value, m.timestamp_ms) for m in messages]


class TumblingCounter(StreamTask):
    """SENSOR_DATA_EVENTS_PER_5MIN_T: tumbling-window event count per car.

    Counts land in output as JSON {"CAR", "WINDOW_START_MS", "EVENT_COUNT"}.
    Like KSQL tables, counts for a window are emitted as updates: every
    `process_available()` round emits the current count for windows touched
    in that round (KSQL's continuous refinement), so the latest record per
    (car, window) key is the table value.
    """

    def __init__(self, broker: Broker, src: str = "SENSOR_DATA_S_AVRO_REKEY",
                 dst: str = "SENSOR_DATA_EVENTS_PER_5MIN_T",
                 window_ms: int = 5 * 60 * 1000, **kw):
        super().__init__(broker, src, dst, **kw)
        self.window_ms = window_ms
        self.counts: Dict[tuple, int] = {}

    def process(self, messages):
        touched = set()
        for m in messages:
            car = (m.key or b"").decode() or "unknown"
            win = (m.timestamp_ms // self.window_ms) * self.window_ms
            k = (car, win)
            self.counts[k] = self.counts.get(k, 0) + 1
            touched.add(k)
        out = []
        for car, win in sorted(touched):
            payload = json.dumps({"CAR": car, "WINDOW_START_MS": win,
                                  "EVENT_COUNT": self.counts[(car, win)]}).encode()
            out.append((car.encode(), payload, win))
        return out

    def table(self) -> Dict[tuple, int]:
        """Materialized view of (car, window_start_ms) → count."""
        return dict(self.counts)


class DelimitedToAvro(StreamTask):
    """KSQL DELIMITED→AVRO recipe for the CSV fixture topic.

    The reference replays `car-sensor-data.csv` through a FileStreamSource
    into `car-data-csv`, declares a DELIMITED stream over it, and CSASes it
    to Avro (reference `test_file_source_and _testdata.sh:49-61`).  Input
    lines are `time,car,<18 sensors>`; output is Confluent-framed KSQL-schema
    Avro keyed by car id, with the label defaulted to "false" (the fixture
    has no failure column).
    """

    def __init__(self, broker: Broker, src: str = "car-data-csv",
                 dst: str = "SENSOR_DATA_S_AVRO", label: str = "false", **kw):
        super().__init__(broker, src, dst, **kw)
        self.codec = AvroCodec(KSQL_CAR_SCHEMA)
        self.label = label

    def process(self, messages):
        out = []
        for m in messages:
            try:
                parts = m.value.decode().split(",")
            except UnicodeDecodeError as e:
                self.dead_letter(m, e)  # poisoned bytes: DLQ, don't halt
                continue
            if parts[0] == "time":
                continue  # replayed header: expected shape, not poison
            if len(parts) != 2 + len(CAR_SCHEMA.fields):
                self.dead_letter(
                    m, f"expected {2 + len(CAR_SCHEMA.fields)} columns, "
                       f"got {len(parts)}")  # KSQL would null-fill; we DLQ
                continue
            rec = {}
            try:
                for f_prod, f_ksql, raw in zip(CAR_SCHEMA.fields,
                                               KSQL_CAR_SCHEMA.sensor_fields,
                                               parts[2:]):
                    rec[f_ksql.name] = int(float(raw)) \
                        if f_ksql.avro_type in ("int", "long") else float(raw)
            except ValueError as e:
                self.dead_letter(m, f"non-numeric sensor value: {e}")
                continue
            rec["FAILURE_OCCURRED"] = self.label
            key = parts[1].encode()
            out.append((key, frame(self.codec.encode(rec)), m.timestamp_ms))
        return out
