"""Key-based log compaction (``iotml.store.compact``): Kafka's
``cleanup.policy=compact``.

A compacted topic is a changelog: the log's *meaning* is the latest
record per key, so any record shadowed by a later one with the same key
is dead weight the store may reclaim.  This module owns the ONE
keep/discard decision in the codebase (`latest_offsets` + `keep` — the
consumer-offsets file and the segment compactor both route through it)
and the segment-level rewrite machinery:

- Only SEALED segments are compacted; the active segment keeps
  appending untouched, so compaction never contends with produce.
- Surviving records are copied as their ORIGINAL frame bytes (offset,
  CRC and all) into ``<base>.log.cleaned``, then atomically swapped
  over the sealed segment with ``os.replace`` — a reader mid-scan keeps
  its open fd on the old inode, a reader arriving after sees only the
  new file, and a crash between swaps leaves every segment either
  fully-old or fully-new (each is independently valid: frames are
  self-describing, offsets are preserved).  Leftover ``.cleaned`` tmp
  files are swept at mount.
- Offsets are PRESERVED (Kafka's contract): compaction punches holes in
  the offset sequence, it never renumbers.  Consumer cursors, committed
  offsets and the replica's offset-identical mirroring all survive.
- A TOMBSTONE (null-value record, segment attrs bit 1) deletes its key:
  it survives compaction long enough for slow readers to observe the
  delete, then is dropped once older than ``grace_ms`` against the
  log's NEWEST record timestamp — record-time, not wall-clock, so the
  same log compacts to the same bytes anywhere (the determinism rule
  the chaos schedules already follow).
- Triggering is by DIRTY RATIO: bytes appended since the last clean
  pass over total sealed bytes, Kafka's ``min.cleanable.dirty.ratio``.

Unkeyed records are never compacted away — with no key there is no
"latest per key", and silently dropping them would turn a mis-keyed
producer into data loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

from ..chaos import faults as chaos
from ..obs import metrics as obs_metrics
from . import segment as seg
from .segment import SegmentWriter

compaction_runs = obs_metrics.default_registry.counter(
    "iotml_store_compaction_runs_total",
    "segment compaction passes completed")
compaction_reclaimed = obs_metrics.default_registry.counter(
    "iotml_store_compaction_reclaimed_bytes",
    "bytes reclaimed by key-based compaction (dirty -> clean)")
compaction_removed = obs_metrics.default_registry.counter(
    "iotml_store_compaction_records_removed_total",
    "records removed by compaction (shadowed values + expired tombstones)")
compaction_seconds = obs_metrics.default_registry.histogram(
    "iotml_store_compaction_seconds", "one full compaction pass over a log")
compaction_errors = obs_metrics.default_registry.counter(
    "iotml_store_compaction_errors_total",
    "background compaction passes that failed (thread survives, retries "
    "next interval)")

#: suffix of the rewrite tmp file; never a valid segment name (the
#: recovery listing matches ``*.log`` exactly) and swept at mount.
CLEANED_SUFFIX = ".cleaned"


# ------------------------------------------------------- the ONE decision
def latest_offsets(records: Iterable[tuple]) -> Dict[bytes, int]:
    """{key: offset of its newest record} over ``(offset, key, value,
    ts, headers)`` tuples in offset order.  Unkeyed records never enter
    the map (they are unconditionally kept)."""
    latest: Dict[bytes, int] = {}
    for off, key, _value, _ts, _headers in records:
        if key is not None:
            latest[key] = off
    return latest


def keep(record: tuple, latest: Dict[bytes, int], newest_ts: int,
         grace_ms: Optional[int]) -> bool:
    """The keep/discard rule — shared by the segment compactor and the
    consumer-offsets file so there is exactly one compaction semantics:

    - unkeyed records are kept;
    - a keyed record survives iff it IS its key's latest;
    - a tombstone (value None), even when latest, is dropped once its
      timestamp is more than ``grace_ms`` behind the log's newest
      record timestamp (``grace_ms=None`` keeps tombstones forever).
    """
    off, key, value, ts, _headers = record
    if key is None:
        return True
    if latest.get(key) != off:
        return False
    if value is None and grace_ms is not None and newest_ts - ts > grace_ms:
        return False
    return True


@dataclasses.dataclass
class CompactionStats:
    segments_rewritten: int = 0
    records_removed: int = 0
    bytes_reclaimed: int = 0

    def merged(self, other: "CompactionStats") -> "CompactionStats":
        return CompactionStats(
            self.segments_rewritten + other.segments_rewritten,
            self.records_removed + other.records_removed,
            self.bytes_reclaimed + other.bytes_reclaimed)


# ------------------------------------------------------ segment compactor
def _scan_frames(path: str):
    """(frame_bytes, (offset, key, value, ts, headers)) per valid frame.
    Raw bytes ride along so survivors are copied verbatim — same CRC,
    same byte form, which is what makes compacted reads byte-stable."""
    data = seg.read_file(path)
    for pos, end, off, key, value, ts, headers in seg.scan_records(data):
        yield data[pos:end], (off, key, value, ts, headers)


def compact_log(slog, grace_ms: Optional[int] = None,
                lock=None) -> CompactionStats:
    """One full compaction pass over a SegmentedLog's sealed segments.

    ``lock`` (the broker lock) is held only around each atomic swap and
    the segment-list update — the expensive part (scanning every
    segment, rewriting dirty ones to ``.cleaned`` tmps with fsync) runs
    WITHOUT it, so a multi-hundred-MB pass never stalls produce/fetch.
    That is safe against concurrent appends because the keep/discard
    decision is conservative in exactly one direction: a record is only
    removed when its newer shadow existed at scan time, and shadows
    never un-exist — appends during the pass can only make the kept set
    slightly stale (extra survivors), never lose a latest record.  A
    segment deleted by concurrent retention mid-pass is skipped (its
    rewrite tmp discarded).  ``lock=None`` (tests driving a bare log)
    degrades to lock-free single-threaded behavior.

    Crash safety: the swap of each segment is one atomic ``os.replace``.
    Dying before it leaves a stale ``.cleaned`` tmp (swept at mount);
    dying between segments leaves a prefix of segments compacted — every
    key's latest record is still present (compaction only removes
    records whose newer shadow exists elsewhere in the log), so a
    remount serves the same latest-per-key table.
    """
    t0 = time.perf_counter()
    stats = CompactionStats()
    lock = lock if lock is not None else contextlib.nullcontext()
    with lock:
        segments = list(slog._segments)
    sealed = segments[:-1]
    if not sealed:
        return stats
    # the offset map spans the WHOLE log (active segment included): a key
    # rewritten in the active segment makes its sealed copies dead.  A
    # torn in-flight frame at the active tail just stops that scan early
    # — conservative (fewer shadows known -> more records kept).
    latest: Dict[bytes, int] = {}
    newest_ts = -1
    for s in segments:
        try:
            frames = list(_scan_frames(s.path))
        except FileNotFoundError:
            continue  # retention deleted it mid-pass
        for _frame, rec in frames:
            off, key, _v, ts, _h = rec
            if key is not None:
                latest[key] = off
            if ts > newest_ts:
                newest_ts = ts
    # make the shadow map's active-tail evidence DURABLE before any
    # destructive swap: the scan above reads flushed-but-unfsynced
    # appends, and a shadow torn off by a power loss must not have
    # already erased its sealed (fsynced) victim — that would turn the
    # bounded-recent-loss fsync=interval contract into old-durable-data
    # loss.  One fsync per pass; under the lock so a concurrent roll
    # cannot swap the writer mid-sync.
    with lock:
        w = slog._writer
        if w is not None:
            w.sync()
    for i, s in enumerate(sealed):
        kept_frames = []
        removed = 0
        try:
            frames = list(_scan_frames(s.path))
        except FileNotFoundError:
            continue
        for frame, rec in frames:
            if keep(rec, latest, newest_ts, grace_ms):
                kept_frames.append(frame)
            else:
                removed += 1
        if not removed:
            continue
        tmp = s.path + CLEANED_SUFFIX
        if os.path.exists(tmp):
            os.remove(tmp)  # stale leftover of a killed pass
        w = SegmentWriter(tmp, fsync=slog.policy.fsync)
        for frame in kept_frames:
            w.write_blob(frame)
        w.close(sync=slog.policy.fsync != "never")
        # the chaos kill point: a scheduled error here simulates dying
        # between the durable rewrite and its publication — the .cleaned
        # tmp exists, the live segment is untouched
        chaos.point("store.compact_swap")
        with lock:
            if s not in slog._segments:
                os.remove(tmp)  # retention won the race; nothing to swap
                continue
            old_size = s.size
            if not kept_frames and i > 0:
                # fully-dead non-head segment: drop it outright (the same
                # shape mount-time recovery gives an empty sealed
                # segment).  The HEAD segment is kept even when empty so
                # base_offset — and with it every consumer's out-of-range
                # contract — is compaction-invariant.
                os.remove(tmp)
                os.remove(s.path)
                slog._remove_sidecars(s.base_offset)
                new = None
            else:
                os.replace(tmp, s.path)
                slog._remove_sidecars(s.base_offset)
                new = slog._scan_segment(s.base_offset, s.path)
                if not kept_frames:
                    # empty head segment: preserve the roll invariant so
                    # the next segment's records stay reachable
                    new.next_offset = s.next_offset
            # publish the swap into the live segment list IN the same
            # lock hold, so no reader ever pairs new file bytes with the
            # old segment's metadata
            segs = list(slog._segments)
            idx = segs.index(s)
            if new is None:
                segs.pop(idx)
            else:
                segs[idx] = new
            slog._segments = segs
            slog._total_bytes = sum(x.size for x in segs)
        stats.segments_rewritten += 1
        stats.records_removed += removed
        stats.bytes_reclaimed += old_size - (new.size if new else 0)
    with lock:
        if stats.segments_rewritten:
            slog._persist_sidecars()
            slog._update_size_gauge()
            compaction_reclaimed.inc(stats.bytes_reclaimed)
            compaction_removed.inc(stats.records_removed)
        slog._clean_through = sealed[-1].next_offset
    compaction_runs.inc()
    compaction_seconds.observe(time.perf_counter() - t0)
    return stats


def dirty_ratio(slog) -> float:
    """Sealed bytes appended since the last clean pass over total sealed
    bytes — 0.0 for a log with no sealed segments or nothing new."""
    sealed = slog._segments[:-1]
    if not sealed:
        return 0.0
    total = sum(s.size for s in sealed)
    if not total:
        return 0.0
    clean_through = getattr(slog, "_clean_through", slog.base_offset)
    dirty = sum(s.size for s in sealed if s.next_offset > clean_through)
    return dirty / total


def sweep_cleaned(dir: str) -> int:
    """Remove leftover ``.cleaned`` rewrite tmps (a compaction pass died
    before its swap).  Called by SegmentedLog recovery; returns count."""
    n = 0
    for name in os.listdir(dir):
        if name.endswith(CLEANED_SUFFIX):
            os.remove(os.path.join(dir, name))
            n += 1
    return n


# --------------------------------------------------- background compactor
class StoreCompactor:
    """Background dirty-ratio-driven compaction for one broker.

    Periodically calls ``broker.run_compaction()`` (which takes the
    broker lock per partition and applies the dirty-ratio gate).  Owned
    thread is registered with ``supervise.registry``; ``run_once`` is
    the deterministic entry tests and drills drive directly."""

    def __init__(self, broker, interval_s: float = 5.0):
        self.broker = broker
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> Dict[Tuple[str, int], CompactionStats]:
        return self.broker.run_compaction()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except (OSError, RuntimeError, ValueError):
                # a transient pass failure (ENOSPC while writing a
                # .cleaned tmp — disk pressure is exactly when
                # compaction matters — or a mid-pass remount) must not
                # kill the thread: count it, retry next interval
                compaction_errors.inc()

    def start(self) -> "StoreCompactor":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._loop, daemon=True, name="iotml-store-compactor"))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
