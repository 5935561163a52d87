"""Append-only segmented log with crash recovery and timestamp replay
(``iotml.store.log``).

The durable partition: what ``stream.broker._Partition`` keeps in a Python
list, on disk, so "training straight from the commit log, no data lake"
survives a process death instead of dying with it.  Directories, file
names, sidecars and frames are the JAX package's byte for byte.

Layout of one partition directory::

    <dir>/00000000000000000000.log        records (segment.py frame)
    <dir>/00000000000000000000.index      sparse offset index (sealed)
    <dir>/00000000000000000000.timeindex  timestamp index (sealed)
    <dir>/00000000000000000123.log        ... next segment, named by its
                                          base offset (Kafka's layout)

The highest-named segment is ACTIVE (appends go there); all others are
sealed.  Sealed segments carry size-stamped sidecar indexes, trusted at
mount only when the stamp matches the log file exactly (so restart cost
is O(tail), not O(total retained bytes)); the active segment's indexes
live in memory and its sidecars are written at roll.  A sidecar that is
missing or disagrees with its log is ignored and the index rebuilt from
the log — the log is the only ground truth (the index/log-mismatch
recovery test pins this).

Recovery (mount time): the ACTIVE segment, and any sealed one whose
sidecars are missing or disagree with it, is CRC-scanned; the first torn
or corrupt frame truncates the file there (the expected artifact of
dying mid-write) and the dropped bytes are counted in
``iotml_store_recovery_truncated_bytes``.  Later segments' records are
still served (their frames are self-describing), which keeps recovery
monotone: nothing valid is ever dropped.

Retention is segment-granular (delete whole sealed segments), by total
bytes and by age against the newest record timestamp — the reference's
``retention.ms`` analog (its topics ran retention.ms=100000,
reference 01_installConfluentPlatform.sh:180-183).

Thread-safety: none here.  The broker serializes every call under its
own lock, exactly as it does for the in-memory list.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from . import segment as seg
from .segment import SegmentWriter

store_segment_bytes = obs_metrics.default_registry.gauge(
    "iotml_store_segment_bytes",
    "on-disk bytes per durable partition (all segments)")
store_recovery_truncated = obs_metrics.default_registry.counter(
    "iotml_store_recovery_truncated_bytes",
    "bytes of torn/corrupt tail dropped by crash recovery")
store_replay_records = obs_metrics.default_registry.counter(
    "iotml_store_replay_records_total",
    "records served by the replay API (read_from / read_since)")

_LOG_SUFFIX = ".log"
_IDX_SUFFIX = ".index"
_TIDX_SUFFIX = ".timeindex"


def _seg_name(base_offset: int) -> str:
    return f"{base_offset:020d}"


class StorePolicy:
    """Per-log knobs (the `store.*` config section, minus the dir)."""

    def __init__(self, fsync: str = "interval",
                 fsync_interval_s: float = 0.05,
                 segment_bytes: int = 16 * 1024 * 1024,
                 segment_age_s: float = 0.0,
                 retention_bytes: int = 0,
                 retention_ms: int = 0,
                 retention_messages: int = 0,
                 index_interval_bytes: int = 4096,
                 compact_min_dirty_ratio: float = 0.5,
                 compact_grace_ms: int = 60_000,
                 compact_interval_s: float = 5.0):
        if fsync not in ("never", "interval", "always"):
            raise ValueError(f"fsync policy must be never|interval|always, "
                             f"got {fsync!r}")
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_bytes = int(segment_bytes)
        self.segment_age_s = float(segment_age_s)
        self.retention_bytes = int(retention_bytes)
        self.retention_ms = int(retention_ms)
        self.retention_messages = int(retention_messages)
        self.index_interval_bytes = int(index_interval_bytes)
        #: compaction trigger (min.cleanable.dirty.ratio) and tombstone
        #: retention (delete.retention.ms against the newest record ts)
        #: for cleanup.policy=compact topics
        self.compact_min_dirty_ratio = float(compact_min_dirty_ratio)
        self.compact_grace_ms = int(compact_grace_ms)
        #: background StoreCompactor cadence (the platform's thread)
        self.compact_interval_s = float(compact_interval_s)

    @classmethod
    def from_config(cls, store_cfg) -> "StorePolicy":
        """Build from the `store.*` config section (config.StoreConfig)."""
        return cls(fsync=store_cfg.fsync,
                   fsync_interval_s=store_cfg.fsync_interval_s,
                   segment_bytes=store_cfg.segment_bytes,
                   segment_age_s=store_cfg.segment_age_s,
                   retention_bytes=store_cfg.retention_bytes,
                   retention_ms=store_cfg.retention_ms,
                   retention_messages=getattr(store_cfg,
                                              "retention_messages", 0),
                   index_interval_bytes=store_cfg.index_interval_bytes,
                   compact_min_dirty_ratio=getattr(
                       store_cfg, "compact_min_dirty_ratio", 0.5),
                   compact_grace_ms=getattr(store_cfg,
                                            "compact_grace_ms", 60_000),
                   compact_interval_s=getattr(store_cfg,
                                              "compact_interval_s", 5.0))


class _Segment:
    """One sealed-or-active segment and its in-memory indexes."""

    __slots__ = ("base_offset", "path", "size", "next_offset",
                 "index", "timeindex", "max_ts")

    def __init__(self, base_offset: int, path: str):
        self.base_offset = base_offset
        self.path = path
        self.size = 0
        self.next_offset = base_offset
        #: sparse [(offset, file_pos)] — one entry per index_interval_bytes
        self.index: List[Tuple[int, int]] = []
        #: [(timestamp_ms, offset)] — appended when ts advances
        self.timeindex: List[Tuple[int, int]] = []
        self.max_ts = -1


class SegmentedLog:
    """One partition's durable log.  See the module docstring."""

    def __init__(self, dir: str, policy: Optional[StorePolicy] = None,
                 metric_labels: Optional[dict] = None):
        self.dir = dir
        self.policy = policy or StorePolicy()
        # mounted logs label by topic/partition (store/mount.py); a BARE
        # construction gets the unlabeled series — labeling by the raw
        # directory path was a cardinality leak (one series per tmp dir,
        # forever), exactly the class the closed-vocabulary test rejects
        self._labels = metric_labels or {}
        os.makedirs(dir, exist_ok=True)
        self._segments: List[_Segment] = []
        self._writer: Optional[SegmentWriter] = None
        self._last_fsync = time.monotonic()
        self._active_opened = time.monotonic()
        self.recovered_truncated_bytes = 0
        self._total_bytes = 0  # maintained incrementally (gauge hot path)
        #: offset frontier of the last compaction pass (compact.py):
        #: sealed segments wholly below it are "clean" for the dirty-
        #: ratio trigger.  Not persisted — a remount re-compacts at
        #: worst (idempotent), never under-compacts silently.
        self._clean_through = 0
        self._recover()

    # ---------------------------------------------------------- recovery
    def _recover(self) -> None:
        from .compact import sweep_cleaned

        # a compaction pass killed before its swap leaves a `.cleaned`
        # rewrite tmp beside the live segment; the live segment is still
        # the truth, the tmp is dead weight
        sweep_cleaned(self.dir)
        names = sorted(n for n in os.listdir(self.dir)
                       if n.endswith(_LOG_SUFFIX))
        for i, name in enumerate(names):
            base = int(name[:-len(_LOG_SUFFIX)])
            path = os.path.join(self.dir, name)
            s = None
            if i + 1 < len(names):
                # sealed segment: its size-stamped sidecars, when they
                # agree with the file, replace the full CRC scan — this
                # is what keeps mount time O(tail), not O(total retained
                # bytes).  Any disagreement falls back to the scan.
                nxt_base = int(names[i + 1][:-len(_LOG_SUFFIX)])
                s = self._load_sealed(base, path, nxt_base)
            if s is None:
                s = self._scan_segment(base, path)
            if s.next_offset == base and self._segments:
                # an empty tail segment (crashed right after a roll):
                # drop the file, the previous segment resumes as active
                os.remove(path)
                self._remove_sidecars(base)
                continue
            self._segments.append(s)
        if not self._segments:
            self._segments.append(
                _Segment(0, os.path.join(self.dir, _seg_name(0) + _LOG_SUFFIX)))
        self._total_bytes = sum(s.size for s in self._segments)
        self._open_writer()
        self._persist_sidecars()  # sealed segments re-publish clean indexes
        self._update_size_gauge()

    def _scan_segment(self, base: int, path: str) -> _Segment:
        """Full CRC scan of one segment: rebuild indexes from the log
        (the only ground truth) and truncate the first torn/corrupt
        frame.  A truncated SEALED segment's sidecars are removed so the
        stale ones can never shadow the truncation."""
        s = _Segment(base, path)
        data = seg.read_file(path)
        valid_end = 0
        for pos, end, off, _k, _v, ts, _h in seg.scan_records(data):
            if not s.index or pos - s.index[-1][1] >= \
                    self.policy.index_interval_bytes:
                s.index.append((off, pos))
            if ts > s.max_ts:
                s.timeindex.append((ts, off))
                s.max_ts = ts
            s.next_offset = off + 1
            valid_end = end
        if valid_end < len(data):
            torn = len(data) - valid_end
            self.recovered_truncated_bytes += torn
            store_recovery_truncated.inc(torn)
            w = SegmentWriter(path, fsync=self.policy.fsync)
            w.truncate_to(valid_end)
            w.close(sync=self.policy.fsync != "never")
            self._remove_sidecars(base)
        s.size = valid_end
        return s

    def _load_sealed(self, base: int, path: str,
                     next_base: int) -> Optional[_Segment]:
        """Build a sealed segment from its sidecars without scanning the
        log.  Returns None (→ full scan) unless BOTH sidecars exist,
        parse, and their stamped log size matches the file exactly."""
        import struct

        try:
            size = os.path.getsize(path)
            s = _Segment(base, path)
            s.size = size
            s.next_offset = next_base  # the roll invariant for sealed
            for suffix, target in ((_IDX_SUFFIX, s.index),
                                   (_TIDX_SUFFIX, s.timeindex)):
                p = os.path.join(self.dir, _seg_name(base) + suffix)
                blob = seg.read_file(p)
                (stamped,) = struct.unpack_from(">q", blob, 0)
                if stamped != size or (len(blob) - 8) % 16:
                    return None
                for off in range(8, len(blob), 16):
                    target.append(struct.unpack_from(">qq", blob, off))
            s.max_ts = s.timeindex[-1][0] if s.timeindex else -1
            return s
        except (OSError, struct.error):
            return None

    def _open_writer(self) -> None:
        active = self._segments[-1]
        self._writer = SegmentWriter(active.path, fsync=self.policy.fsync)
        self._active_opened = time.monotonic()

    def _remove_sidecars(self, base: int) -> None:
        for suffix in (_IDX_SUFFIX, _TIDX_SUFFIX):
            p = os.path.join(self.dir, _seg_name(base) + suffix)
            if os.path.exists(p):
                os.remove(p)

    def _persist_sidecars(self) -> None:
        """Write index sidecars for every SEALED segment that lacks
        them.  Format: ``>q`` stamped log size, then ``>qq`` entries —
        the stamp is the mount-time trust check (`_load_sealed`): a
        sidecar that disagrees with its log's size is ignored and the
        log rescanned, so sidecars can accelerate recovery but never
        override the log."""
        import struct

        for s in self._segments[:-1]:
            head = struct.pack(">q", s.size)
            p = os.path.join(self.dir, _seg_name(s.base_offset) + _IDX_SUFFIX)
            if not os.path.exists(p):
                blob = head + b"".join(struct.pack(">qq", o, pos)
                                       for o, pos in s.index)
                seg.atomic_write(p, blob, fsync=self.policy.fsync == "always")
            p = os.path.join(self.dir, _seg_name(s.base_offset) + _TIDX_SUFFIX)
            if not os.path.exists(p):
                blob = head + b"".join(struct.pack(">qq", ts, o)
                                       for ts, o in s.timeindex)
                seg.atomic_write(p, blob, fsync=self.policy.fsync == "always")

    # ------------------------------------------------------------- state
    @property
    def base_offset(self) -> int:
        return self._segments[0].base_offset

    @property
    def end_offset(self) -> int:
        return self._segments[-1].next_offset

    def __len__(self) -> int:
        return self.end_offset - self.base_offset

    def total_bytes(self) -> int:
        return self._total_bytes

    def _update_size_gauge(self) -> None:
        store_segment_bytes.set(self.total_bytes(), **self._labels)

    @property
    def active_path(self) -> str:
        return self._segments[-1].path

    # ------------------------------------------------------------ append
    def append(self, key: Optional[bytes], value: bytes, timestamp_ms: int,
               headers: Optional[tuple] = None, sync: bool = True) -> int:
        """Append one record; under ``fsync=always`` the record is
        durable when this returns.  ``sync=False`` defers the fsync to a
        caller-owned ``sync_batch()`` — how a bulk produce acks once per
        batch instead of once per record (the ack still happens after
        the sync, so acked⇒durable is intact)."""
        self._maybe_roll()
        active = self._segments[-1]
        off = active.next_offset
        frame = seg.encode_record(off, key, value, timestamp_ms, headers)
        pos = self._writer.append(frame)
        if not active.index or pos - active.index[-1][1] >= \
                self.policy.index_interval_bytes:
            active.index.append((off, pos))
        if timestamp_ms > active.max_ts:
            active.timeindex.append((timestamp_ms, off))
            active.max_ts = timestamp_ms
        active.next_offset = off + 1
        active.size += len(frame)
        self._total_bytes += len(frame)
        if self.policy.fsync == "always":
            if sync:
                self._writer.sync()
            self._last_fsync = time.monotonic()
        elif self.policy.fsync == "interval":
            now = time.monotonic()
            if now - self._last_fsync >= self.policy.fsync_interval_s:
                self._writer.sync()
                self._last_fsync = now
        self._update_size_gauge()
        return off

    def append_at(self, offset: int, key: Optional[bytes], value,
                  timestamp_ms: int, headers: Optional[tuple] = None,
                  sync: bool = True) -> int:
        """Append one record AT an explicit offset at/after the log end —
        the replica's mirror path for COMPACTED topics, whose fetches
        carry offset holes (compaction punched out shadowed records).
        Appending them contiguously would renumber the survivors and
        silently break the offsets-identical failover contract; jumping
        the active segment's next_offset forward reproduces the hole."""
        offset = int(offset)
        end = self.end_offset
        if offset < end:
            raise ValueError(f"append_at({offset}) behind log end {end}: "
                             f"offsets only move forward")
        if offset > end:
            self._segments[-1].next_offset = offset
        return self.append(key, value, timestamp_ms, headers, sync=sync)

    def append_raw(self, blob: bytes, count: int, first_offset: int,
                   last_offset: int, max_ts: int,
                   sync: bool = True) -> int:
        """Append a VALIDATED raw frame batch verbatim — the zero-copy
        write path (RAW_PRODUCE landing, replica mirror leg, fused
        produce_many framing): the batch's bytes become the segment's
        bytes in one write, no per-record re-serialisation.  The caller
        (Broker) has already CRC-validated the whole batch and stamped
        the offsets; ``first_offset`` past the log end reproduces an
        offset hole (the compacted-mirror case), exactly like
        ``append_at``.  Indexing is batch-granular: one sparse-index
        candidate at the batch head and one timeindex entry at the
        batch's max timestamp — both are conservative lower bounds, so
        reads only ever start earlier, never skip records."""
        if count <= 0:
            return first_offset
        self._maybe_roll()
        active = self._segments[-1]
        if first_offset < active.next_offset:
            raise ValueError(
                f"append_raw({first_offset}) behind log end "
                f"{active.next_offset}: offsets only move forward")
        pos = self._writer.append(blob)
        if not active.index or pos - active.index[-1][1] >= \
                self.policy.index_interval_bytes:
            active.index.append((first_offset, pos))
        if max_ts > active.max_ts:
            active.timeindex.append((max_ts, first_offset))
            active.max_ts = max_ts
        active.next_offset = last_offset + 1
        active.size += len(blob)
        self._total_bytes += len(blob)
        if self.policy.fsync == "always":
            if sync:
                self._writer.sync()
            self._last_fsync = time.monotonic()
        elif self.policy.fsync == "interval":
            now = time.monotonic()
            if now - self._last_fsync >= self.policy.fsync_interval_s:
                self._writer.sync()
                self._last_fsync = now
        self._update_size_gauge()
        return first_offset

    def sync_batch(self) -> None:
        """The deferred half of ``append(sync=False)`` under
        ``fsync=always``; cheap no-op otherwise."""
        if self.policy.fsync == "always":
            self._writer.sync()

    def _maybe_roll(self) -> None:
        active = self._segments[-1]
        if active.size == 0:
            return
        age = time.monotonic() - self._active_opened
        if active.size >= self.policy.segment_bytes or (
                self.policy.segment_age_s
                and age >= self.policy.segment_age_s):
            self.roll()

    def roll(self) -> None:
        """Seal the active segment and start a new one at end_offset."""
        active = self._segments[-1]
        if active.size == 0:
            return
        self._writer.close(sync=self.policy.fsync != "never")
        base = active.next_offset
        s = _Segment(base, os.path.join(self.dir,
                                        _seg_name(base) + _LOG_SUFFIX))
        self._segments.append(s)
        self._open_writer()
        self._persist_sidecars()

    def flush(self, sync: bool = True) -> None:
        w = self._writer  # readers flush lock-free; a roll may swap it
        if w is not None:
            try:
                if sync and self.policy.fsync != "never":
                    w.sync()
                else:
                    w.flush()
            except ValueError:
                pass  # closed mid-roll by the appender — the roll's own
                # close() flushed everything this reader needed

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close(sync=self.policy.fsync != "never")
            self._writer = None

    # -------------------------------------------------------------- read
    @staticmethod
    def _segment_for(segments: List[_Segment],
                     offset: int) -> Optional[_Segment]:
        lo, hi = 0, len(segments) - 1
        ans = None
        while lo <= hi:
            mid = (lo + hi) // 2
            if segments[mid].base_offset <= offset:
                ans = segments[mid]
                lo = mid + 1
            else:
                hi = mid - 1
        return ans

    def read_from(self, offset: int, max_records: int = 1024,
                  _count_replay: bool = False) -> List[tuple]:
        """Records from `offset` (inclusive), at most `max_records`:
        [(offset, key, value, timestamp_ms, headers)].  Raises
        LookupError when `offset` is below the retained base — the
        caller (broker fetch) maps it to its own out-of-range signal.

        Safe to call WITHOUT the broker lock: the segment list is
        snapshotted, appends only grow files (a torn in-flight frame
        parks the scan exactly like a crash artifact would), and a
        segment deleted by concurrent retention reads as trimmed
        history (skipped), never an error."""
        if offset < self.base_offset:
            raise LookupError(
                f"offset {offset} below retained base {self.base_offset}")
        out: List[tuple] = []
        self.flush(sync=False)  # reads see every append, fsync'd or not
        segments = list(self._segments)  # snapshot vs concurrent roll/trim
        end = segments[-1].next_offset
        while len(out) < max_records and offset < end:
            s = self._segment_for(segments, offset)
            if s is None:
                break
            if offset >= s.next_offset:
                # a recovery-truncated SEALED segment leaves an offset
                # hole before its successor's base; jump it — the
                # monotone-recovery promise is that every intact later
                # record still serves, never that a reader stalls at
                # the hole forever.  But only at the START of a batch:
                # a returned batch must never hide a gap mid-list (the
                # replica's realignment check reads msgs[0].offset only,
                # so an internal gap would be mirrored contiguously and
                # shift every later offset in the follower's log)
                if out:
                    break
                nxt = [x for x in segments if x.base_offset > offset]
                if not nxt:
                    break
                offset = nxt[0].base_offset
                continue
            start_pos = 0
            for o, pos in reversed(s.index):
                if o <= offset:
                    start_pos = pos
                    break
            # bounded, streaming I/O: seek to the sparse-index position
            # and decode in chunks, stopping at max_records — neither a
            # 16MB active segment per poll nor read-to-EOF per
            # sequential-replay round
            filled = False
            scanned_to = start_pos
            try:
                for _pos, _end, off, key, value, ts, hdrs in \
                        seg.iter_frames(s.path, start_pos):
                    scanned_to = _end
                    if off < offset:
                        continue
                    out.append((off, key, value, ts, hdrs))
                    offset = off + 1
                    if len(out) >= max_records:
                        filled = True
                        break
            except FileNotFoundError:
                # retention deleted it mid-read: trimmed history.  Stop
                # if records were already collected — same no-mid-batch-
                # gap rule as the hole jump above
                if out:
                    break
            if not filled:
                if scanned_to < s.size and out:
                    # the scan stopped at a CORRUPT frame mid-segment
                    # (sidecar-trusted mount discovers corruption at
                    # read time): end the batch here so the skipped
                    # region starts the next batch, never hides inside
                    # this one
                    break
                offset = s.next_offset  # exhausted this segment; next one
        if _count_replay and out:
            store_replay_records.inc(len(out))
        return out

    def read_raw(self, offset: int, max_bytes: int = 1 << 20
                 ) -> Optional[Tuple[bytes, int]]:
        """RAW frame bytes from `offset` — the zero-copy read: one
        bounded pread of the owning segment, NO per-record parsing (the
        caller's columnar decoder walks the frames).  Returns
        ``(frame_bytes, aligned_start_offset)`` or None at/after the log
        end; raises LookupError below the retained base (broker fetch
        maps it to its out-of-range signal).

        The returned range starts at the sparse-index position at/before
        `offset` (leading frames are skipped by the decoder via their
        self-describing offsets), or at `offset`'s own frame when the
        window from that position would end before it (a batch larger
        than ``max_bytes``: a deviation from ``iotml.store.log``, whose
        readers fall back to FETCH there), and may end mid-frame (the decoder
        treats the torn tail exactly like crash recovery: batch ends
        there, the next poll resumes).  Safe without the broker lock for
        the same reasons as ``read_from``: the segment list is
        snapshotted, appends only grow files, and a concurrent trim
        surfaces as FileNotFoundError → trimmed history."""
        if offset < self.base_offset:
            raise LookupError(
                f"offset {offset} below retained base {self.base_offset}")
        self.flush(sync=False)  # raw reads see every append too
        segments = list(self._segments)
        end = segments[-1].next_offset
        if offset >= end:
            return None
        s = self._segment_for(segments, offset)
        start_pos = 0
        want = 0
        for _ in range(len(segments) + 1):
            if s is None or offset >= s.next_offset:
                # recovery-truncated hole before the next segment: serve
                # the successor from its base (same monotone-recovery
                # promise as read_from's hole jump)
                nxt = [x for x in segments if x.base_offset > offset]
                if not nxt:
                    return None
                s = nxt[0]
                offset = s.base_offset
            start_pos, start_off = 0, -1
            for o, pos in reversed(s.index):
                if o <= offset:
                    start_pos, start_off = pos, o
                    break
            cap = max(int(max_bytes), seg.MIN_BODY + 8)
            want = min(cap, s.size - start_pos)
            if want > 0:
                break
            # a compaction-emptied segment (zero bytes, base/next_offset
            # preserved to keep the log head stable): jump past it like
            # the hole case — returning None here would read as log end
            # and park every raw reader forever
            offset = s.next_offset
            s = self._segment_for(segments, offset)
        if want <= 0:
            return None
        try:
            with open(s.path, "rb") as fh:
                if start_off < offset:
                    # deep inside one large batch (one index entry) the
                    # window from the entry may end before `offset`'s
                    # frame: start it at that frame instead, or the
                    # reader finds nothing past its cursor and falls
                    # back to the per-record FETCH
                    at = seg.frame_at(fh, start_pos, s.size, offset)
                    if at is not None and at[1] > start_pos + want and \
                            at[1] - at[0] <= cap:
                        start_pos = at[0]
                        want = min(cap, s.size - start_pos)
                fh.seek(start_pos)
                data = fh.read(want)
        except FileNotFoundError:
            return None  # retention deleted it mid-read: trimmed history
        return data, offset

    def offset_for_timestamp(self, timestamp_ms: int) -> int:
        """Earliest offset whose record timestamp is >= `timestamp_ms`
        (end_offset when no such record) — the `retention.ms`-era replay
        cursor: 'give me everything since T'."""
        self.flush(sync=False)
        segments = list(self._segments)  # snapshot, like read_from
        for s in segments:
            if s.max_ts < timestamp_ms:
                continue
            # first timeindex entry at/after the target bounds the scan;
            # stream frames and stop at the first match — never decode
            # (or materialize) the rest of the segment
            start = s.base_offset
            for ts, off in s.timeindex:
                if ts >= timestamp_ms:
                    break
                start = off
            start_pos = 0
            for o, pos in reversed(s.index):
                if o <= start:
                    start_pos = pos
                    break
            try:
                for _pos, _end, off, _key, _value, ts, _hdrs in \
                        seg.iter_frames(s.path, start_pos):
                    if off >= start and ts >= timestamp_ms:
                        return off
            except FileNotFoundError:
                continue  # retention deleted it mid-scan: trimmed
        return segments[-1].next_offset

    def read_since(self, timestamp_ms: int,
                   max_records: int = 1024) -> List[tuple]:
        """Replay every record with timestamp >= `timestamp_ms`."""
        return self.read_from(self.offset_for_timestamp(timestamp_ms),
                              max_records=max_records, _count_replay=True)

    # -------------------------------------------------------- compaction
    def compact(self, grace_ms: Optional[int] = None, lock=None):
        """Key-based compaction over the sealed segments (compact.py):
        keeps the latest record per key, drops tombstones past the grace
        window, preserves offsets.  ``lock`` (the broker lock) is taken
        only around each swap + segment-list update — the scan/rewrite
        I/O runs outside it so compaction never stalls produce/fetch."""
        from . import compact as _compact

        return _compact.compact_log(self, grace_ms=grace_ms, lock=lock)

    def dirty_ratio(self) -> float:
        """Sealed bytes appended since the last compaction over total
        sealed bytes — the ``min.cleanable.dirty.ratio`` trigger input."""
        from . import compact as _compact

        return _compact.dirty_ratio(self)

    # --------------------------------------------------------- retention
    def enforce_retention(self) -> int:
        """Delete whole sealed segments past the byte/count/age budget;
        returns records dropped.  The active segment is never deleted —
        the head of the log trims, the tail keeps appending.  Count
        retention is segment-granular like the others: the head segment
        goes once the REMAINING segments alone satisfy the cap (Kafka's
        own delete-whole-segments semantics, a slight over-retention
        rather than record-exact trimming)."""
        dropped = 0
        pol = self.policy
        newest_ts = max((s.max_ts for s in self._segments), default=-1)
        while len(self._segments) > 1:
            head = self._segments[0]
            over_bytes = pol.retention_bytes and \
                self.total_bytes() > pol.retention_bytes
            over_count = pol.retention_messages and \
                (self.end_offset - self._segments[1].base_offset
                 >= pol.retention_messages)
            over_age = pol.retention_ms and newest_ts >= 0 and \
                0 <= head.max_ts < newest_ts - pol.retention_ms
            if not (over_bytes or over_count or over_age):
                break
            dropped += head.next_offset - head.base_offset
            self._total_bytes -= head.size
            os.remove(head.path)
            self._remove_sidecars(head.base_offset)
            self._segments.pop(0)
        if dropped:
            self._update_size_gauge()
        return dropped

    # ------------------------------------------------- replica/test hooks
    def align_base(self, offset: int) -> None:
        """Seed an EMPTY log's base offset (replica bootstrap parity
        with the in-memory partition)."""
        if len(self):
            raise ValueError("log not empty; base is immutable")
        base = int(offset)
        old = self._segments[-1]
        if old.base_offset == base:
            return
        self.close()
        os.remove(old.path)
        self._remove_sidecars(old.base_offset)
        s = _Segment(base, os.path.join(self.dir,
                                        _seg_name(base) + _LOG_SUFFIX))
        self._segments = [s]
        self._open_writer()

    def reset(self, base_offset: int) -> None:
        """Drop everything and restart at `base_offset` (replica
        realignment after the leader's retention outran replication)."""
        self.close()
        for s in self._segments:
            if os.path.exists(s.path):
                os.remove(s.path)
            self._remove_sidecars(s.base_offset)
        s = _Segment(int(base_offset),
                     os.path.join(self.dir,
                                  _seg_name(int(base_offset)) + _LOG_SUFFIX))
        self._segments = [s]
        self._total_bytes = 0
        self._open_writer()
        self._update_size_gauge()

    def simulate_torn_write(self, blob: Optional[bytes] = None) -> int:
        """Append a deliberately torn frame to the active segment — the
        on-disk artifact of a process killed mid-write.  Chaos/test-only
        (production appends can't emit an invalid frame); lives here so
        even crash simulation goes through SegmentWriter.
        Returns the byte count recovery must truncate."""
        if blob is None:
            # a length prefix promising far more bytes than follow
            blob = seg._LEN.pack(1 << 20) + b"\xde\xad\xbe\xef" * 4
        self._writer.write_blob(blob)
        self._writer.flush()
        return len(blob)

    def index_entries(self) -> Dict[int, int]:
        """{offset: file_pos} of the active segment's sparse index —
        test introspection for index density assertions."""
        return dict(self._segments[-1].index)
