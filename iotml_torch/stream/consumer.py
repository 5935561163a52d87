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
(the native client, ``stream.native_kafka``).  Tracing, watermarks, lag
gauges and the columnar ring poll are not ported.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .broker import (Broker, Message, OffsetOutOfRangeError,
                     SchemaIdMismatchError)
from .native import LABEL_STRIDE


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
        if not nums:
            empty = (np.zeros((0, codec.n_numeric)),
                     np.zeros((0, codec.n_strings), f"S{LABEL_STRIDE}"))
            return empty + (np.zeros((0,), "S1"),) if with_keys else empty
        out = (np.concatenate(nums), np.concatenate(labs))
        return out + (np.concatenate(keys),) if with_keys else out

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
        """Commit every cursor, one ``Broker.commit_many`` per topic."""
        by_topic: dict = {}
        for t, p, off in self._cursors:
            by_topic.setdefault(t, []).append((p, off))
        for t, entries in by_topic.items():
            self.broker.commit_many(self.group, t, entries)
