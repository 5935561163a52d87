"""Durable consumer-group offsets (``iotml.store.offsets``): the
__consumer_offsets equivalent.

The broker's ``commit`` table is the resume cursor for every consumer in
the framework (SURVEY §5: "the offset is the checkpoint"), so a durable
log without durable offsets would re-serve history to consumers that
already committed past it.  This file is the compacted key→value store
Kafka keeps in ``__consumer_offsets``: each commit appends one framed
record (``segment.py`` frame; key = ``group\\0topic\\0partition``, value
= offset as decimal ASCII), and when the appended history outgrows the
live key set by ``compact_ratio`` the whole file is rewritten with one
record per key and atomically renamed into place.  The keep/discard
decision is ``store.compact``'s (`latest_offsets` + `keep`) — the same
one implementation that compacts ``cleanup.policy=compact`` topic
segments, applied here to a single-file log.

Crash behavior is the segment format's: a torn tail record is dropped at
load (the commit it carried was never acknowledged as durable under
``fsync=always``; under laxer policies the consumer re-reads a slice —
at-least-once, the framework-wide delivery contract).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

from . import segment as seg
from .segment import SegmentWriter

_FILENAME = "offsets"


class OffsetsFile:
    """Append + compact store for {(group, topic, partition): next_offset}."""

    def __init__(self, dir: str, fsync: str = "interval",
                 compact_ratio: int = 4, fsync_interval_s: float = 0.05):
        import time

        os.makedirs(dir, exist_ok=True)
        self.path = os.path.join(dir, _FILENAME)
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self._last_fsync = time.monotonic()
        self.compact_ratio = max(int(compact_ratio), 2)
        self._table: Dict[Tuple[str, str, int], int] = {}
        self._records = 0  # appended records since the last compaction
        self.recovered_truncated_bytes = 0
        self._load()
        self._writer = SegmentWriter(self.path, fsync=fsync)

    # ------------------------------------------------------------- load
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        data = seg.read_file(self.path)
        valid_end = 0
        for _pos, end, _off, key, value, _ts, _h in seg.scan_records(data):
            group, topic, part = key.decode().split("\x00")
            self._table[(group, topic, int(part))] = int(value)
            self._records += 1
            valid_end = end
        if valid_end < len(data):
            from .log import store_recovery_truncated

            torn = len(data) - valid_end
            self.recovered_truncated_bytes += torn
            store_recovery_truncated.inc(torn)  # same ledger as segments
            w = SegmentWriter(self.path, fsync=self.fsync)
            w.truncate_to(valid_end)
            w.close(sync=self.fsync != "never")

    # ------------------------------------------------------------ write
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int, sync: bool = True) -> None:
        key = f"{group}\x00{topic}\x00{partition}".encode()
        frame = seg.encode_record(0, key, str(int(next_offset)).encode(),
                                  0, None)
        self._writer.append(frame)
        if self.fsync == "always":
            if sync:
                self._writer.sync()
        elif self.fsync == "interval":
            # same cadence contract as SegmentedLog.append: loss bounded
            # to the interval, not to "whenever compaction happens"
            import time

            now = time.monotonic()
            if now - self._last_fsync >= self.fsync_interval_s:
                self._writer.sync()
                self._last_fsync = now
        self._table[(group, topic, int(partition))] = int(next_offset)
        self._records += 1
        if self._records >= self.compact_ratio * max(len(self._table), 1):
            self.compact()

    def commit_many(self, group: str, topic: str, entries) -> None:
        """Commit [(partition, next_offset), ...] with ONE fsync."""
        for p, off in entries:
            self.commit(group, topic, p, off, sync=False)
        if self.fsync == "always":
            self._writer.sync()

    def compact(self) -> None:
        """Rewrite one record per live key; atomic-rename publication.

        Routes the keep/discard decision through the generic compactor
        (store.compact) so key-compaction semantics exist exactly once.
        Survivors are re-framed from the in-memory table — it IS the
        latest-per-key set (`_load` rebuilds it, ``get`` serves it), so
        this commit-hot path never re-reads the file from disk.  Frames
        are byte-identical to ``commit``'s (same key/value encoding,
        ts 0, no headers); offsets collapse to 0 — this file is a
        table, not an offset-addressed log, so renumbering is free.
        Tombstones never appear here (commits are never null), so the
        grace window is moot."""
        from . import compact as _compact

        records = [
            (i, f"{g}\x00{t}\x00{p}".encode(), str(off).encode(), 0, None)
            for i, ((g, t, p), off) in enumerate(self._table.items())]
        latest = _compact.latest_offsets(records)
        blob = b"".join(
            seg.encode_record(0, key, value, ts, headers)
            for off, key, value, ts, headers in records
            if _compact.keep((off, key, value, ts, headers), latest,
                             newest_ts=-1, grace_ms=None))
        self._writer.close(sync=False)
        seg.atomic_write(self.path, blob, fsync=self.fsync != "never")
        self._writer = SegmentWriter(self.path, fsync=self.fsync)
        self._records = len(self._table)

    # ------------------------------------------------------------- read
    def table(self) -> Dict[Tuple[str, str, int], int]:
        return dict(self._table)

    def get(self, group: str, topic: str, partition: int):
        return self._table.get((group, topic, int(partition)))

    def flush(self) -> None:
        if self.fsync != "never":
            self._writer.sync()
        else:
            self._writer.flush()

    def close(self) -> None:
        self._writer.close(sync=self.fsync != "never")
