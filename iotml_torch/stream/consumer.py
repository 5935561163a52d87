"""Offset-cursored stream consumer (``iotml.stream.consumer``'s twin).

The reference consumes with ``kafka_io.KafkaDataset(["topic:partition:offset"],
group=..., eof=True)`` (cardata-v3.py:46-47): an absolute-offset cursor over
one partition, EOF when the log end is reached, re-readable from the same
offset every epoch.  ``StreamConsumer`` keeps those semantics over the
port's ``Broker`` or, unchanged, over the wire client
(``kafka_wire.KafkaWireBroker``, whose fetch raises the same
``OffsetOutOfRangeError`` with the earliest offset the server retains),
and adds multi-partition specs, committed-offset resume and ``seek``.
``poll_decoded`` is the fused poll over a broker with ``fetch_decode``
(the native client, ``stream.native_kafka``).

Instrumented as the JAX consumer is: ``poll`` folds each batch's event
time into the consume watermark and the per-partition ranges that
``take_event_time`` hands the scorer and the trainers (``poll_decoded``
too, from the native client's ``last_event_time``; with the watermarks
off, ``IOTML_WATERMARK=0``, neither computes the bounds), beats the
``consume`` stage's liveness under tracing, and observes
``iotml_fetch_batch_size``; auto-resets count into
``iotml_consumer_autoresets_total``; ``commit`` refreshes
``iotml_consumer_lag_records`` and times ``iotml_commit_seconds``.

``poll_into`` is the columnar ring's poll: raw frame batches
(``fetch_raw``: a durable broker's segment bytes, or RAW_FETCH over the
wire) decoded by ``stream.native.FrameDecoder`` straight into the
caller's buffers, no per-record object; its event-time bounds come off
the decoder's frame walk.  It stops for the caller's per-record leg at
an evolved writer's frame, jumps a recovery hole, resets a trimmed
cursor and, against a server without RAW_FETCH, switches itself off for
good.  Under tracing, a raw batch's first-frame trace context is marked
``consume`` and held for ``take_batch_traces``.
"""

from __future__ import annotations

import collections
import operator
from struct import error as struct_error
from typing import List, Sequence

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs import tracing, watermark
from .broker import (Broker, Message, OffsetOutOfRangeError,
                     SchemaIdMismatchError)
from .native import LABEL_STRIDE


#: a ``Message``'s timestamp_ms, read at C speed
_TIMESTAMP = operator.itemgetter(Message._fields.index("timestamp_ms"))


def parse_spec(spec: str) -> tuple:
    """Parse the reference's "topic:partition:offset" subscription string."""
    parts = spec.split(":")
    if len(parts) == 1:
        return parts[0], 0, 0
    if len(parts) == 2:
        return parts[0], int(parts[1]), 0
    return parts[0], int(parts[1]), int(parts[2])


class StreamConsumer:
    """Cursor over one or more (topic, partition) logs.

    Args:
      broker: the port's ``Broker``.
      specs: "topic:partition:offset" strings (reference subscription format).
      group: consumer-group id for offset commits.
      eof: if True, iteration ends once all cursors hit the log end
           (reference eof=True batch mode); if False, callers may poll
           again as data arrives.

    ``autoresets`` counts cursors moved to the earliest retained offset
    after retention trimmed past them.  A poll never raises for trimmed
    history: a cursor that retention outruns on every reset is parked at
    the earliest offset and the chase goes on at the next poll.
    """

    def __init__(self, broker: Broker, specs: Sequence[str],
                 group: str = "iotml", eof: bool = True):
        self.broker = broker
        self.group = group
        self.eof = eof
        self._cursors = [list(parse_spec(s)) for s in specs]
        self._start = [c[2] for c in self._cursors]
        self._rr = 0
        self.autoresets = 0
        #: per-(topic, partition) [min_ts, max_ts] of records consumed
        #: since the last take_event_time()
        self._event_ts: dict = {}
        #: trace contexts of raw batches' first frames (poll_into under
        #: tracing), bounded, drained by the batcher
        self._batch_traces: collections.deque = collections.deque(
            maxlen=1024)
        #: a wire server without RAW_FETCH: poll_into is off for good
        self._raw_unsupported = False

    @classmethod
    def from_committed(cls, broker: Broker, topic: str,
                       partitions: Sequence[int], group: str,
                       fallback_offset: int = 0, **kw):
        """Resume from committed group offsets (cursor-checkpoint restart)."""
        specs = []
        for p in partitions:
            off = broker.committed(group, topic, p)
            specs.append(f"{topic}:{p}:"
                         f"{off if off is not None else fallback_offset}")
        return cls(broker, specs, group=group, **kw)

    def rewind_to_committed(self) -> None:
        """Reset the cursors to the last committed offsets (or the start
        offsets when nothing was committed): a processing round that
        aborts mid-chunk retries its records (at-least-once)."""
        for i, cur in enumerate(self._cursors):
            off = self.broker.committed(self.group, cur[0], cur[1])
            cur[2] = off if off is not None else self._start[i]

    # ------------------------------------------- event-time watermarks
    def _note_event_ts(self, topic: str, part: int,
                       ts_min: int, ts_max: int) -> None:
        """Fold one consumed batch's event-time bounds into the
        per-partition ranges and publish the consume-stage watermark
        (group-labelled: a trainer and a scorer of one partition in one
        process are two frontiers)."""
        if ts_max is None or ts_max < 0:
            return
        lo = ts_min if ts_min is not None and ts_min >= 0 else ts_max
        cur = self._event_ts.get((topic, part))
        if cur is None:
            self._event_ts[(topic, part)] = [lo, ts_max]
        else:
            if lo < cur[0]:
                cur[0] = lo
            if ts_max > cur[1]:
                cur[1] = ts_max
        watermark.observe("consume", topic, part, lo, ts_max,
                          group=self.group)

    def take_event_time(self) -> dict:
        """{(topic, partition): (ts_min, ts_max)} of event time consumed
        since the last take, cleared on read: a processing stage takes
        it where consumed has become processed and hands it to
        ``watermark.observe_taken(stage, ...)``.  With the watermarks
        off (``IOTML_WATERMARK=0``) a poll folds nothing and this is
        empty."""
        out = {k: tuple(v) for k, v in self._event_ts.items()}
        self._event_ts.clear()
        return out

    def take_batch_traces(self) -> list:
        """Drain the trace contexts ``poll_into`` took off raw batches'
        first frames: the batcher queues them for the pipeline's closer
        (the scorer or the train step), as it does record traces."""
        out: list = []
        while True:
            try:
                out.append(self._batch_traces.popleft())
            except IndexError:
                return out

    def record_lag(self) -> int:
        """Refresh ``iotml_consumer_lag_records{group,topic,partition}``
        from each partition's end offset and return the total lag.
        Telemetry on the commit path: a broker error here skips the
        refresh, never fails the drain."""
        total = 0
        for topic, part, off in self._cursors:
            try:
                hwm = self.broker.end_offset(topic, part)
            except (KeyError, RuntimeError, OSError):
                continue
            lag = max(int(hwm) - int(off), 0)
            total += lag
            obs_metrics.consumer_lag_records.set(
                lag, group=self.group, topic=topic, partition=part)
        return total

    def _fetch_autoreset(self, topic: str, part: int, off: int,
                         max_messages: int) -> tuple:
        """One fetch; a cursor below the retained base auto-resets to
        EARLIEST (``auto.offset.reset=earliest``) and fetches again, up to
        four times, since retention may trim again between the calls.
        Outrun every time, it returns an empty batch with the cursor
        parked at the last earliest offset.  Returns (batch,
        effective_offset)."""
        for _ in range(4):
            try:
                return self.broker.fetch(topic, part, off, max_messages), off
            except OffsetOutOfRangeError as e:
                off = max(e.earliest, self.broker.begin_offset(topic, part))
                self.autoresets += 1
                obs_metrics.consumer_autoresets.inc(topic=topic)
        return [], off

    # --------------------------------------------------------------- read
    def poll(self, max_messages: int = 1024) -> List[Message]:
        """Fetch up to max_messages across cursors, round-robin between
        partitions so one hot partition cannot starve the rest."""
        out: List[Message] = []
        n = len(self._cursors)
        attempts = 0
        while len(out) < max_messages and attempts < n:
            cur = self._cursors[self._rr % n]
            self._rr += 1
            attempts += 1
            batch, cur[2] = self._fetch_autoreset(cur[0], cur[1], cur[2],
                                                  max_messages - len(out))
            if batch:
                cur[2] = batch[-1].offset + 1
                out.extend(batch)
                attempts = 0  # progress: give the others another turn
                if watermark.ENABLED:
                    # true min/max: event times are not append-monotone
                    ts = list(map(_TIMESTAMP, batch))
                    self._note_event_ts(cur[0], cur[1], min(ts), max(ts))
                tracing.touch("consume")
        if out:
            # only non-empty polls observe: idle polling would flood the
            # first bucket
            obs_metrics.fetch_batch_size.observe(len(out))
        return out

    def poll_decoded(self, codec, strip: int = 5, max_messages: int = 4096,
                     with_keys: bool = False):
        """Fused poll: fetch, framing strip and Avro decode in one native
        call a partition (the broker's ``fetch_decode``, or
        ``fetch_decode_keys`` with ``with_keys``), round-robin as
        ``poll``.  Returns (numeric [n, F] float64, labels [n, S] bytes),
        with keys [n] bytes third under ``with_keys``, or None when the
        broker has no such call; n == 0 is the end of the poll, as an
        empty ``poll()`` is.  A trimmed cursor resets to the earliest
        retained offset.  At an evolved writer's frame
        (``SchemaIdMismatchError``) it returns what decoded before it,
        or raises when nothing did, with the cursor on that frame."""
        fd = getattr(self.broker,
                     "fetch_decode_keys" if with_keys else "fetch_decode",
                     None)
        if fd is None:
            return None
        event_time = getattr(self.broker, "last_event_time", None)
        nums, labs, keys = [], [], []
        got = 0
        n = len(self._cursors)
        attempts = 0
        while got < max_messages and attempts < n:
            cur = self._cursors[self._rr % n]
            self._rr += 1
            attempts += 1
            topic, part, off = cur
            try:
                res = fd(topic, part, off, codec, strip=strip,
                         max_rows=max_messages - got)
            except OffsetOutOfRangeError as e:
                cur[2] = max(e.earliest, self.broker.begin_offset(topic, part))
                self.autoresets += 1
                obs_metrics.consumer_autoresets.inc(topic=topic)
                continue
            except SchemaIdMismatchError:
                if got:
                    break
                raise
            numeric = res[0]
            if len(numeric):
                cur[2] = res[-1]
                nums.append(numeric)
                labs.append(res[1])
                if with_keys:
                    keys.append(res[2])
                got += len(numeric)
                attempts = 0
                if event_time is not None and watermark.ENABLED:
                    # the client's bounds of this decode: the fused leg's
                    # consume watermark, as the JAX columnar leg's
                    self._note_event_ts(topic, part, *event_time())
                tracing.touch("consume")
        if got:
            obs_metrics.fetch_batch_size.observe(got)
        if not nums:
            empty = (np.zeros((0, codec.n_numeric)),
                     np.zeros((0, codec.n_strings), f"S{LABEL_STRIDE}"))
            return empty + (np.zeros((0,), "S1"),) if with_keys else empty
        out = (np.concatenate(nums), np.concatenate(labs))
        return out + (np.concatenate(keys),) if with_keys else out

    def poll_into(self, decoder, out_numeric, out_labels, out_keys=None,
                  max_rows: int = 4096, max_bytes: int = 1 << 20):
        """Columnar poll over raw frame batches, round-robin as ``poll``:
        ``fetch_raw`` from each cursor, decoded by ``decoder``
        (``stream.native.FrameDecoder``) straight into the caller's
        buffers.  The one decode entry of live consume and
        timestamp-replay backfill alike (a backfill is this after
        ``seek_to_timestamp``).

        Returns ``(rows, fallback)``: the rows decoded (the cursors moved
        past exactly those), and ``fallback=True`` when a cursor is
        parked on a chunk this path must not decode (an evolved writer's
        id, or bytes only the per-record leg reads): the caller takes
        ONE ``poll`` chunk and comes back.  Returns None when the broker
        has no raw reads.  A trimmed cursor resets to the earliest
        retained offset and fetches again."""
        fr = getattr(self.broker, "fetch_raw", None)
        if fr is None or self._raw_unsupported:
            return None
        from .native import FRAMES_STOP_SCHEMA, FRAMES_STOP_TORN

        rows = 0
        n = len(self._cursors)
        attempts = 0
        while rows < max_rows and attempts < n:
            cur = self._cursors[self._rr % n]
            self._rr += 1
            attempts += 1
            topic, part, off = cur
            raw = None
            for _ in range(4):  # _fetch_autoreset's retry envelope
                try:
                    raw = fr(topic, part, off, max_bytes=max_bytes)
                    break
                except NotImplementedError:
                    # a wire server without RAW_FETCH: back to the other
                    # legs for good (rows already decoded stand)
                    self._raw_unsupported = True
                    return (rows, False) if rows else None
                except OffsetOutOfRangeError as e:
                    # reset to earliest, then fetch again: a retention
                    # trim must not read as the end of the stream
                    off = max(e.earliest,
                              self.broker.begin_offset(topic, part))
                    cur[2] = off
                    self.autoresets += 1
                    obs_metrics.consumer_autoresets.inc(topic=topic)
            if raw is None:
                continue
            got, next_off, flags, _skipped = decoder.decode_into(
                raw.data, off, out_numeric[rows:], out_labels[rows:],
                out_keys[rows:] if out_keys is not None else None,
                cap_rows=max_rows - rows)
            if got or next_off > off:
                # progress: rows decoded and/or tombstones skipped; the
                # event-time bounds fall out of the decoder's walk
                cur[2] = next_off
                rows += got
                attempts = 0
                if watermark.ENABLED:
                    self._note_event_ts(topic, part, decoder.last_ts_min,
                                        decoder.last_ts_max)
                if tracing.ENABLED:
                    tracing.touch("consume")
                    self._extract_batch_trace(raw, topic, part, off,
                                              next_off, got)
                continue
            if flags & FRAMES_STOP_SCHEMA:
                # an evolved writer at the cursor: the caller resolves
                # one chunk by name, then comes back
                return rows, True
            if flags & FRAMES_STOP_TORN:
                # parked on bytes the raw scan cannot cross: a recovery
                # hole (the probe jumps it), a record only the per-record
                # leg reads (fall back one chunk), or an append in flight
                # (no data yet).  One bounded one-record probe.
                probe, eff = self._fetch_autoreset(topic, part, off, 1)
                cur[2] = eff
                if probe and probe[0].offset > eff:
                    cur[2] = probe[0].offset  # hole jumped: raw again
                    continue
                if probe:
                    return rows, True
        if rows:
            obs_metrics.fetch_batch_size.observe(rows)
        return rows, False

    def _extract_batch_trace(self, raw, topic: str, part: int,
                             first_off: int, next_off: int,
                             got: int) -> None:
        """A sampled raw batch carries a trace context in its first
        frame's headers: one first-frame parse a raw fetch, under
        tracing only.  The context is marked ``consume`` with the batch's
        offset range and held for the pipeline's closer.  A batch head
        served again below ``first_off`` (the sparse-index alignment) is
        not a new batch and is skipped."""
        from ..ops.framing import first_frame_headers

        try:
            hdrs = first_frame_headers(raw.data, at_or_after=first_off)
        except (ValueError, struct_error):
            return
        ctx = tracing.from_headers(hdrs)
        if ctx is None:
            return
        tracing.mark_batch(ctx, "consume", topic, part, first_off,
                           next_off - 1, got)
        if len(self._batch_traces) == self._batch_traces.maxlen:
            tracing.spans_dropped.inc()
        self._batch_traces.append(ctx)

    def at_end(self) -> bool:
        return all(off >= self.broker.end_offset(t, p)
                   for t, p, off in self._cursors)

    def __iter__(self):
        """Iterate to EOF (reference eof=True semantics)."""
        while True:
            batch = self.poll()
            if not batch and (self.eof or self.at_end()):
                return
            yield from batch

    # ------------------------------------------------------------- cursor
    def seek_to_start(self) -> None:
        """Rewind to the construction offsets (per-epoch stream re-read)."""
        for cur, off in zip(self._cursors, self._start):
            cur[2] = off

    def seek_to_timestamp(self, timestamp_ms: int) -> None:
        """Move every cursor to the first record at or after
        ``timestamp_ms`` (the broker's timestamp index, ListOffsets by
        timestamp on the wire): the replay entry for training backfill.
        A broker without ``offset_for_timestamp`` leaves the cursors as
        they are."""
        oft = getattr(self.broker, "offset_for_timestamp", None)
        if oft is None:
            return
        for cur in self._cursors:
            cur[2] = oft(cur[0], cur[1], timestamp_ms)

    def seek(self, topic: str, partition: int, offset: int) -> None:
        for cur in self._cursors:
            if cur[0] == topic and cur[1] == partition:
                cur[2] = offset
                return
        raise KeyError((topic, partition))

    def positions(self) -> List[tuple]:
        """Current (topic, partition, next_offset) cursors — the stream
        half of a resume checkpoint."""
        return [tuple(c) for c in self._cursors]

    def commit(self) -> None:
        """Commit every cursor, one ``Broker.commit_many`` per topic; the
        drain boundary refreshes the lag gauge first."""
        self.record_lag()
        with obs_metrics.commit_seconds.time():
            by_topic: dict = {}
            for t, p, off in self._cursors:
                by_topic.setdefault(t, []).append((p, off))
            for t, entries in by_topic.items():
                self.broker.commit_many(self.group, t, entries)
