"""Tiered log (``iotml.store.tiered``): local hot segments + ArtifactStore
cold tier, one log.

`TieredLog` extends `SegmentedLog` with a remote tier (remote.py):
sealed segments upload in the background (`TierUploader`), local
retention becomes a hot-tier cache with its own eviction policy, and
every read API — ``read_from`` / ``read_raw`` / ``read_since`` /
``offset_for_timestamp`` — falls through to the remote tier when the
requested offset is below the local base.  The fall-through is
*transparent* by construction: ``base_offset`` reports the EARLIEST
offset retained in either tier, so the broker's out-of-range check
and the consumer's auto-reset accounting see one log that simply
retains weeks instead of hours.  Remote segments are served through a
bounded `RemoteSegmentCache` that mounts each download as a read-only
single-segment `SegmentedLog`: the SAME frame scan, sparse index and
raw-read path as local segments (a call-counted test pins it).

Segment lifecycle across tiers::

    active ──roll──▶ sealed ──upload+commit──▶ sealed+remote ──evict──▶ remote-only
                        │                          │                       │
                        │ (compaction rewrites:    │ (local retention /    │ (remote
                        │  size changes → the      │  hot-byte eviction    │  retention
                        │  uploader re-uploads,    │  may drop the local   │  drops the
                        │  same base replaces      │  copy — ONLY after    │  manifest
                        │  the manifest entry)     │  the manifest commit) │  entry, then
                        ▼                          ▼                       ▼  the blobs)

Two invariants the tests pin:

- the LOCAL copy is authoritative until the remote manifest commits —
  local retention and hot eviction refuse to drop a segment the
  manifest does not list byte-for-byte;
- ``tier_sync(ceiling=)`` tiers out only sealed bytes below the
  ceiling (a replicated leader's broker passes its quorum high-water
  mark, an unreplicated one None).

Knobs ride the ``tier.*`` config section (``IOTML_TIER_URI``,
``IOTML_TIER_LOCAL_HOT_BYTES``, ``IOTML_TIER_UPLOAD_LAG_S``,
``IOTML_TIER_REMOTE_RETENTION_MS``, ``IOTML_TIER_CACHE_SEGMENTS``,
``IOTML_TIER_INTERVAL_S``).
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from .log import (SegmentedLog, StorePolicy, _seg_name, store_replay_records)
from .remote import RemoteSegmentMeta, RemoteTier

tier_remote_records = obs_metrics.default_registry.counter(
    "iotml_tier_remote_records_total",
    "records served from remote-tier segments (read fall-through)")
tier_hot_evicted = obs_metrics.default_registry.counter(
    "iotml_tier_hot_evicted_bytes_total",
    "local hot-tier bytes evicted after their remote manifest commit")
tier_errors = obs_metrics.default_registry.counter(
    "iotml_tier_errors_total",
    "tier upload/sweep pass failures (logged, retried next interval)")

_CACHE_DIR = ".tiercache"


class TierPolicy:
    """The ``tier.*`` knobs (config.TierConfig's runtime mirror)."""

    def __init__(self, uri: str = "", local_hot_bytes: int = 0,
                 upload_lag_s: float = 0.0, remote_retention_ms: int = 0,
                 cache_segments: int = 4, interval_s: float = 5.0):
        self.uri = uri
        #: hot-tier byte budget per partition; 0 = never evict (the
        #: remote tier is then a pure replica of local history)
        self.local_hot_bytes = int(local_hot_bytes)
        #: minimum time a segment stays sealed before upload — lets the
        #: compactor's first pass over fresh seals win the race so the
        #: tier mostly stores compacted bytes
        self.upload_lag_s = float(upload_lag_s)
        #: age cap for remote history (0 = keep forever — "weeks" is
        #: the point); anchored at the log-wide newest timestamp
        self.remote_retention_ms = int(remote_retention_ms)
        #: bounded RemoteSegmentCache entries per partition
        self.cache_segments = int(cache_segments)
        #: background TierUploader cadence
        self.interval_s = float(interval_s)

    @classmethod
    def from_config(cls, tier_cfg) -> "TierPolicy":
        return cls(uri=tier_cfg.uri,
                   local_hot_bytes=tier_cfg.local_hot_bytes,
                   upload_lag_s=tier_cfg.upload_lag_s,
                   remote_retention_ms=tier_cfg.remote_retention_ms,
                   cache_segments=tier_cfg.cache_segments,
                   interval_s=tier_cfg.interval_s)

    def __bool__(self) -> bool:
        return bool(self.uri)


class RemoteSegmentCache:
    """Bounded LRU of downloaded remote segments, each mounted as a
    read-only single-segment `SegmentedLog`.

    The mount's full CRC scan doubles as the serve gate: a blob that
    passed the size/CRC check but holds a torn frame would be truncated
    by recovery — we refuse to serve that too (`recovered_truncated_
    bytes` must be zero), so a remote read can never return bytes the
    manifest didn't commit."""

    def __init__(self, dir: str, max_segments: int = 4):
        self.dir = dir
        self.max_segments = max(1, int(max_segments))
        self._entries: "OrderedDict[int, SegmentedLog]" = OrderedDict()

    def get(self, meta: RemoteSegmentMeta, remote: RemoteTier) -> SegmentedLog:
        log = self._entries.get(meta.base)
        if log is not None:
            self._entries.move_to_end(meta.base)
            return log
        dest = os.path.join(self.dir, _seg_name(meta.base))
        remote.fetch_segment(meta, dest)
        log = SegmentedLog(dest, policy=StorePolicy(fsync="never"))
        if log.recovered_truncated_bytes or log.total_bytes() != meta.size:
            log.close()
            shutil.rmtree(dest, ignore_errors=True)
            raise OSError(f"remote segment {meta.base} failed the frame "
                          f"scan; refusing to serve uncommitted bytes")
        self._entries[meta.base] = log
        while len(self._entries) > self.max_segments:
            _base, old = self._entries.popitem(last=False)
            old.close()
            shutil.rmtree(old.dir, ignore_errors=True)
        return log

    def drop(self, base: int) -> None:
        """Invalidate one entry (its remote blob was replaced by a
        compacted re-upload, or retention dropped it)."""
        log = self._entries.pop(base, None)
        if log is not None:
            log.close()
            shutil.rmtree(log.dir, ignore_errors=True)

    def clear(self) -> None:
        for base in list(self._entries):
            self.drop(base)

    def __len__(self) -> int:
        return len(self._entries)


class TieredLog(SegmentedLog):
    """SegmentedLog + a remote tier.  See the module docstring.

    Thread-safety matches the base class: the broker serializes
    mutation under its lock; reads snapshot.  `tier_sync` (the uploader
    thread's entry) does its blob I/O OUTSIDE any lock and publishes
    manifest/segment-list updates under the lock it is handed."""

    def __init__(self, dir: str, policy: Optional[StorePolicy] = None,
                 remote: Optional[RemoteTier] = None,
                 tier: Optional[TierPolicy] = None,
                 metric_labels: Optional[dict] = None):
        self.remote = remote
        self.tier = tier or TierPolicy()
        self._remote_metas: List[RemoteSegmentMeta] = []
        #: base → monotonic time first seen sealed (upload-lag clock;
        #: monotonic on purpose: wall-clock jumps must not upload early)
        self._sealed_seen: Dict[int, float] = {}
        self.cache = RemoteSegmentCache(
            os.path.join(dir, _CACHE_DIR),
            max_segments=self.tier.cache_segments)
        super().__init__(dir, policy=policy, metric_labels=metric_labels)
        if self.remote is not None:
            try:
                self._remote_metas = self.remote.load()
            except (OSError, ValueError):
                # unreachable/garbled tier at mount: local history still
                # serves; the uploader's next pass re-reads the manifest
                self._remote_metas = []

    # ------------------------------------------------------------- state
    @property
    def base_offset(self) -> int:
        """Earliest offset retained in EITHER tier — what the broker's
        out-of-range check (and the consumer's auto-reset) sees."""
        local = self._segments[0].base_offset
        metas = self._remote_metas
        if metas and metas[0].base < local:
            return metas[0].base
        return local

    @property
    def local_base_offset(self) -> int:
        return self._segments[0].base_offset

    def remote_metas(self) -> List[RemoteSegmentMeta]:
        return list(self._remote_metas)

    @staticmethod
    def _meta_for(metas: List[RemoteSegmentMeta],
                  offset: int) -> Optional[RemoteSegmentMeta]:
        ans = None
        for m in metas:
            if m.base <= offset:
                ans = m
            else:
                break
        return ans

    def _local_floor(self) -> int:
        """First offset the LOCAL segments can serve.  Normally the
        local base; on a cold mount whose local log is still empty
        (a bootstrapping follower pointed at an existing tier)
        everything committed lives remotely, so the floor is the
        remote end."""
        local = self._segments[0].base_offset
        if self._remote_metas and self.end_offset <= local:
            return max(local, self._remote_metas[-1].next)
        return local

    def _remote_below_local(self) -> List[RemoteSegmentMeta]:
        local = self._local_floor()
        return [m for m in self._remote_metas if m.base < local]

    # -------------------------------------------------------------- read
    def read_from(self, offset: int, max_records: int = 1024,
                  _count_replay: bool = False) -> List[tuple]:
        local = self._local_floor()
        if self.remote is None or offset >= local:
            return super().read_from(offset, max_records, _count_replay)
        metas = self._remote_below_local()
        if not metas or offset < metas[0].base:
            raise LookupError(
                f"offset {offset} below retained base {self.base_offset}")
        out: List[tuple] = []
        remote_served = 0
        while len(out) < max_records and offset < local:
            m = self._meta_for(metas, offset)
            if m is None or offset >= m.next:
                # a hole between remote segments (remote retention, or a
                # compaction-punched gap): jump it — but only at the
                # START of a batch, the same no-mid-batch-gap rule as
                # the local scan (read_from's hole jump)
                if out:
                    break
                nxt = [x for x in metas if x.base > offset]
                offset = nxt[0].base if nxt else local
                continue
            try:
                cached = self.cache.get(m, self.remote)
            except (OSError, ValueError):
                if out:
                    break
                raise LookupError(
                    f"remote segment {m.base} unavailable; offset "
                    f"{offset} reads as trimmed history") from None
            chunk = cached.read_from(offset, max_records - len(out))
            if not chunk:
                offset = m.next
                continue
            if out and chunk[0][0] != out[-1][0] + 1:
                break  # never hide a gap mid-batch
            out.extend(chunk)
            remote_served += len(chunk)
            offset = chunk[-1][0] + 1
        if len(out) < max_records and offset >= local:
            if not out:
                return super().read_from(offset, max_records, _count_replay)
            # remote→local crossing inside one batch: only if contiguous
            try:
                more = super().read_from(offset, max_records - len(out))
            except LookupError:
                more = []
            if more and more[0][0] == out[-1][0] + 1:
                out.extend(more)
        if remote_served:
            tier_remote_records.inc(remote_served)
        if _count_replay and out:
            store_replay_records.inc(len(out))
        return out

    def read_raw(self, offset: int, max_bytes: int = 1 << 20
                 ) -> Optional[Tuple[bytes, int]]:
        local = self._local_floor()
        if self.remote is None or offset >= local:
            return super().read_raw(offset, max_bytes)
        metas = self._remote_below_local()
        if not metas or offset < metas[0].base:
            raise LookupError(
                f"offset {offset} below retained base {self.base_offset}")
        for _ in range(len(metas) + 1):
            if offset >= local:
                return super().read_raw(offset, max_bytes)
            m = self._meta_for(metas, offset)
            if m is None or offset >= m.next:
                nxt = [x for x in metas if x.base > offset]
                offset = nxt[0].base if nxt else local
                continue
            try:
                cached = self.cache.get(m, self.remote)
            except (OSError, ValueError):
                raise LookupError(
                    f"remote segment {m.base} unavailable; offset "
                    f"{offset} reads as trimmed history") from None
            res = cached.read_raw(offset, max_bytes)
            if res is not None:
                return res
            offset = m.next  # compaction-emptied remote segment: jump
        return super().read_raw(local, max_bytes)

    def offset_for_timestamp(self, timestamp_ms: int) -> int:
        if self.remote is not None:
            for m in self._remote_below_local():
                if m.max_ts < timestamp_ms:
                    continue
                try:
                    cached = self.cache.get(m, self.remote)
                except (OSError, ValueError):
                    continue  # trimmed-history semantics: later wins
                off = cached.offset_for_timestamp(timestamp_ms)
                if off < cached.end_offset:
                    return off
        return super().offset_for_timestamp(timestamp_ms)

    # --------------------------------------------------------- retention
    def _committed_remotely(self, s) -> bool:
        """True when the manifest lists this exact local segment —
        base, next_offset AND size byte-for-byte.  A compacted rewrite
        changes the size, so a not-yet-re-uploaded rewrite is NOT
        covered and the local copy stays authoritative."""
        m = self._meta_for(self._remote_metas, s.base_offset)
        return m is not None and m.base == s.base_offset \
            and m.next == s.next_offset and m.size == s.size

    def enforce_retention(self) -> int:
        if self.remote is None:
            return super().enforce_retention()
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
            if not self._committed_remotely(head):
                # local is authoritative until the remote manifest
                # commits: retention WAITS rather than losing the only
                # copy (the uploader's next pass unblocks it)
                break
            dropped += head.next_offset - head.base_offset
            self._drop_head_segment()
        if dropped:
            self._update_size_gauge()
        return dropped

    def _drop_head_segment(self) -> None:
        head = self._segments[0]
        self._total_bytes -= head.size
        os.remove(head.path)
        self._remove_sidecars(head.base_offset)
        self._segments.pop(0)
        self._sealed_seen.pop(head.base_offset, None)

    def evict_hot(self, budget_bytes: Optional[int] = None) -> int:
        """Evict remote-committed head segments past the hot-tier byte
        budget (``tier.local_hot_bytes``); the records stay readable
        through the remote fall-through.  An explicit ``budget_bytes``
        overrides the policy (0 = evict every covered sealed segment —
        the cold-backfill bench and the trim tests use this)."""
        if self.remote is None:
            return 0
        budget = self.tier.local_hot_bytes if budget_bytes is None \
            else int(budget_bytes)
        if budget_bytes is None and not budget:
            return 0
        evicted = 0
        while len(self._segments) > 1 and self._total_bytes > budget:
            head = self._segments[0]
            if not self._committed_remotely(head):
                break  # manifest first, eviction second — always
            evicted += head.size
            self._drop_head_segment()
        if evicted:
            self._update_size_gauge()
            tier_hot_evicted.inc(evicted)
        return evicted

    # ------------------------------------------------------------ upload
    def tier_sync(self, ceiling: Optional[int] = None, lock=None,
                  upload_lag_s: Optional[float] = None) -> dict:
        """One tiering pass: upload eligible sealed segments, evict the
        hot tier, enforce remote retention, sweep garbage.  Blob I/O
        runs outside ``lock`` (the broker lock); manifest/segment-list
        publication happens inside it.  ``ceiling`` bounds what may
        tier out (the quorum HWM — only replicated bytes leave the hot
        tier); None = unreplicated, everything sealed is eligible."""
        if self.remote is None:
            return {"uploaded": 0, "bytes": 0, "evicted": 0,
                    "retained": 0, "retired": 0, "swept": 0}
        lock = lock if lock is not None else threading.Lock()
        lag = self.tier.upload_lag_s if upload_lag_s is None \
            else float(upload_lag_s)
        now = time.monotonic()
        with lock:
            self._persist_sidecars()  # uploads ship index sidecars too
            sealed = list(self._segments[:-1])
            metas_by_base = {m.base: m for m in self._remote_metas}
        uploaded, up_bytes = 0, 0
        for s in sealed:
            if ceiling is not None and s.next_offset > ceiling:
                break  # above the quorum HWM: not durable enough to tier
            first_seen = self._sealed_seen.setdefault(s.base_offset, now)
            if lag and now - first_seen < lag:
                continue
            m = metas_by_base.get(s.base_offset)
            if m is not None and m.next == s.next_offset \
                    and m.size == s.size:
                continue  # already committed, byte-for-byte
            idx = os.path.join(self.dir, _seg_name(s.base_offset) + ".index")
            tidx = os.path.join(self.dir,
                                _seg_name(s.base_offset) + ".timeindex")
            meta = self.remote.upload_segment(
                s.path, idx, tidx, base=s.base_offset,
                next_offset=s.next_offset, max_ts=s.max_ts)
            with lock:
                self._remote_metas = sorted(
                    [x for x in self._remote_metas if x.base != meta.base]
                    + [meta], key=lambda x: x.base)
                # a re-upload (compacted rewrite) invalidates any cached
                # download of the old blob
                self.cache.drop(meta.base)
            uploaded += 1
            up_bytes += meta.size
        # Compaction can MERGE sealed segments away entirely (their
        # survivors rewritten into a neighbor base).  A manifest entry
        # whose base lies inside the locally-covered sealed range but
        # matches no local segment is such an orphan: no re-upload will
        # ever replace it, and once the hot tier evicts it would serve
        # shadowed pre-compaction records.  Retire it BEFORE eviction
        # can make it reachable.  Entries below the local base are the
        # evicted history — those are the point of the tier; keep them.
        with lock:
            sealed_now = list(self._segments[:-1])
            local_bases = {s.base_offset for s in sealed_now}
            stale = []
            if sealed_now:
                lo = sealed_now[0].base_offset
                hi = sealed_now[-1].next_offset
                stale = [m for m in self._remote_metas
                         if lo <= m.base < hi and m.base not in local_bases]
        retired = 0
        if stale:
            dropped = self.remote.retire([m.base for m in stale])
            with lock:
                gone = {m.base for m in dropped}
                self._remote_metas = [m for m in self._remote_metas
                                      if m.base not in gone]
                for base in gone:
                    self.cache.drop(base)
            retired = len(dropped)
        with lock:
            evicted = self.evict_hot()
        retained = 0
        if self.tier.remote_retention_ms:
            newest_ts = max(
                [s.max_ts for s in self._segments]
                + [m.max_ts for m in self._remote_metas] or [-1])
            dropped = self.remote.enforce_retention(
                self.tier.remote_retention_ms, newest_ts)
            if dropped:
                with lock:
                    gone = {m.base for m in dropped}
                    self._remote_metas = [m for m in self._remote_metas
                                          if m.base not in gone]
                    for base in gone:
                        self.cache.drop(base)
                retained = len(dropped)
        swept = self.remote.sweep()
        return {"uploaded": uploaded, "bytes": up_bytes,
                "evicted": evicted, "retained": retained,
                "retired": retired, "swept": swept}

    def close(self) -> None:
        self.cache.clear()
        super().close()


# ---------------------------------------------------- background uploader
class TierUploader:
    """Background tiering for one broker: periodically runs
    ``broker.run_tiering()`` (upload → evict → remote retention →
    sweep per tiered partition).  Same supervised-thread discipline as
    `StoreCompactor`; ``run_once`` is the deterministic entry
    tests, drills and the chaos runner drive directly."""

    def __init__(self, broker, interval_s: float = 5.0):
        self.broker = broker
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def run_once(self) -> dict:
        return self.broker.run_tiering()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except (OSError, RuntimeError, ValueError):
                # a transient pass failure (unreachable bucket, ENOSPC
                # on the stage copy, a chaos kill) must not stop the
                # tier: count it, retry next interval — the local copy
                # is still authoritative
                tier_errors.inc()

    def start(self) -> "TierUploader":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._loop, daemon=True, name="iotml-tier-uploader"))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
