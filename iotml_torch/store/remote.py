"""Remote tier (``iotml.store.remote``): sealed segments in an
ArtifactStore, manifest-committed.

The object-store half of tiered log storage (Kafka's tiered-storage shape
on the reference's own GCS bucket): sealed segment files and their index
sidecars upload as opaque blobs, and a per-partition ``manifest.json``
— written atomically (`ArtifactStore.put_text`) — is the ONE commit
marker.  Readers trust exactly what the manifest lists; a blob the
manifest does not name does not exist, no matter how many bytes of it
landed.  That is the same manifest-as-commit-marker protocol the model
registry uses, applied to log segments:

    upload ``<base>.stage`` marker        (intent, sweepable)
    upload ``<base>.log/.index/.timeindex``  (blobs, each atomic)
    --- crash here leaves garbage, never a servable segment ---
    commit manifest (atomic text write)   (the segment now EXISTS)
    delete the stage marker               (cleanup, best-effort)

Remote layout under one tier root::

    tiered/<topic_dir>/<partition>/manifest.json
    tiered/<topic_dir>/<partition>/00000000000000000000.log
    tiered/<topic_dir>/<partition>/00000000000000000000.index
    tiered/<topic_dir>/<partition>/00000000000000000000.timeindex

Manifest entries carry the log blob's size and CRC32C; the fetch path
verifies both before a downloaded segment is ever mounted, so a torn
blob (a backend without atomic puts, a truncated download) is an error,
never data.  `sweep()` garbage-collects everything unreferenced —
the blobs of a killed mid-upload, stale ``.stage`` markers, segments
dropped by remote retention.  One writer per partition prefix is
guaranteed upstream by the store dir's process lock (mount.py), so the
sweeper can never race an upload it didn't schedule itself.
"""

from __future__ import annotations

import json
import os
from typing import List, NamedTuple, Optional

from ..chaos import faults as chaos
from ..obs import metrics as obs_metrics
from . import segment as seg

_MANIFEST = "manifest.json"
_STAGE_SUFFIX = ".stage"
_LOG_SUFFIX = ".log"
_SIDECAR_SUFFIXES = (".index", ".timeindex")

tier_uploads = obs_metrics.default_registry.counter(
    "iotml_tier_uploads_total",
    "sealed segments committed to the remote tier (manifest commits)")
tier_upload_bytes = obs_metrics.default_registry.counter(
    "iotml_tier_upload_bytes_total",
    "log-segment bytes shipped to the remote tier")
tier_remote_fetches = obs_metrics.default_registry.counter(
    "iotml_tier_remote_fetch_total",
    "remote segments downloaded (and CRC-verified) into the local cache")
tier_swept_blobs = obs_metrics.default_registry.counter(
    "iotml_tier_swept_blobs_total",
    "unreferenced remote blobs garbage-collected (torn uploads, stage "
    "markers, retention-dropped segments)")


class RemoteSegmentMeta(NamedTuple):
    """One committed remote segment, exactly as the manifest records it."""

    base: int       # base offset (names the blobs, Kafka layout)
    next: int       # next_offset — the roll invariant, holes included
    size: int       # log blob bytes (fetch-time torn-blob check)
    max_ts: int     # newest record timestamp (remote retention anchor)
    crc: int        # CRC32C of the log blob (fetch-time corruption check)


def _seg_name(base: int) -> str:
    return f"{base:020d}"


def _file_crc(path: str) -> int:
    return seg.crc32c(seg.read_file(path))


class RemoteTier:
    """One partition's remote-tier view: blobs + the manifest commit.

    ``store`` is an ArtifactStore duck (upload/download/put_text/
    get_text/list/delete — the hardened interface); ``prefix`` is this
    partition's blob namespace.  All methods are synchronous I/O; the
    caller (TierUploader thread / the read path's cache fill) owns
    scheduling."""

    def __init__(self, store, prefix: str):
        self.store = store
        self.prefix = prefix.rstrip("/")

    # ------------------------------------------------------------ names
    def _blob(self, base: int, suffix: str) -> str:
        return f"{self.prefix}/{_seg_name(base)}{suffix}"

    @property
    def _manifest_name(self) -> str:
        return f"{self.prefix}/{_MANIFEST}"

    # --------------------------------------------------------- manifest
    def load(self) -> List[RemoteSegmentMeta]:
        """Committed segments, sorted by base offset.  [] when the tier
        has never committed (or the manifest is unreadable — an
        unreachable tier degrades to local-only serving, never an
        error at mount)."""
        text = self.store.get_text(self._manifest_name)
        if text is None:
            return []
        doc = json.loads(text)
        metas = [RemoteSegmentMeta(int(e["base"]), int(e["next"]),
                                   int(e["size"]), int(e["max_ts"]),
                                   int(e["crc"]))
                 for e in doc.get("segments", [])]
        return sorted(metas, key=lambda m: m.base)

    def _commit(self, metas: List[RemoteSegmentMeta]) -> None:
        doc = {"segments": [m._asdict() for m in
                            sorted(metas, key=lambda m: m.base)]}
        self.store.put_text(self._manifest_name,
                            json.dumps(doc, indent=2, sort_keys=True))

    # ------------------------------------------------------------ upload
    def upload_segment(self, log_path: str, index_path: str,
                       timeindex_path: str, base: int, next_offset: int,
                       max_ts: int) -> RemoteSegmentMeta:
        """Stage-then-commit one sealed segment (or a compacted rewrite
        of one — same base replaces the old entry).  A kill anywhere
        before the manifest commit leaves only unreferenced blobs and a
        stage marker for `sweep()`; the local copy stays authoritative
        because nothing below is servable until the commit."""
        size = os.path.getsize(log_path)
        crc = _file_crc(log_path)
        # intent marker first: a sweep finding this without a matching
        # manifest entry knows the blobs beside it are a torn upload
        self.store.put_text(self._blob(base, _STAGE_SUFFIX),
                            json.dumps({"base": base, "size": size}))
        self.store.upload(log_path, self._blob(base, _LOG_SUFFIX))
        for path, suffix in ((index_path, ".index"),
                             (timeindex_path, ".timeindex")):
            self.store.upload(path, self._blob(base, suffix))
        # the kill-mid-upload faultpoint: blobs landed, manifest NOT
        # committed — the exact window the commit-marker protocol exists
        # for (chaos scenario `tier-upload-crash` kills here)
        chaos.point("store.tier_upload")
        meta = RemoteSegmentMeta(base, int(next_offset), size,
                                 int(max_ts), crc)
        metas = [m for m in self.load() if m.base != base]
        metas.append(meta)
        self._commit(metas)
        try:
            self.store.delete(self._blob(base, _STAGE_SUFFIX))
        except OSError:
            pass  # sweep() collects it; the commit already happened
        tier_uploads.inc()
        tier_upload_bytes.inc(size)
        return meta

    # ------------------------------------------------------------- fetch
    def fetch_segment(self, meta: RemoteSegmentMeta, dest_dir: str) -> str:
        """Download one committed segment (+ sidecars) into `dest_dir`
        under its canonical names; the log blob must match the
        manifest's size AND CRC exactly or nothing is left behind —
        "no torn remote segment is ever served" is enforced here, not
        hoped for at the backend."""
        os.makedirs(dest_dir, exist_ok=True)
        log_dst = os.path.join(dest_dir, _seg_name(meta.base) + _LOG_SUFFIX)
        try:
            self.store.download(self._blob(meta.base, _LOG_SUFFIX), log_dst)
            if os.path.getsize(log_dst) != meta.size \
                    or _file_crc(log_dst) != meta.crc:
                raise OSError(
                    f"remote segment {meta.base} is torn/corrupt "
                    f"(size/CRC mismatch vs manifest); refusing to serve")
            for suffix in _SIDECAR_SUFFIXES:
                dst = os.path.join(dest_dir, _seg_name(meta.base) + suffix)
                try:
                    self.store.download(self._blob(meta.base, suffix), dst)
                except (OSError, FileNotFoundError):
                    # sidecars are an accelerator, never ground truth
                    # (same trust rule as the local mount): the cache
                    # mount rebuilds indexes from the log
                    if os.path.exists(dst):
                        os.remove(dst)
        except Exception:
            for name in os.listdir(dest_dir) if os.path.isdir(dest_dir) \
                    else ():
                os.remove(os.path.join(dest_dir, name))
            raise
        tier_remote_fetches.inc()
        return log_dst

    # -------------------------------------------------------- retention
    def enforce_retention(self, retention_ms: int,
                          newest_ts: int) -> List[RemoteSegmentMeta]:
        """Drop committed segments whose newest record aged past
        ``retention_ms`` against `newest_ts` (the log-wide newest
        timestamp — Kafka's rule, same anchor as local retention).
        The manifest shrinks FIRST (the drop commits), then blobs are
        deleted; a crash between the two leaves unreferenced blobs for
        `sweep()`.  Returns the dropped metas."""
        if not retention_ms or newest_ts < 0:
            return []
        cutoff = newest_ts - int(retention_ms)
        metas = self.load()
        keep = [m for m in metas if not (0 <= m.max_ts < cutoff)]
        dropped = [m for m in metas if 0 <= m.max_ts < cutoff]
        if not dropped:
            return []
        self._commit(keep)
        for m in dropped:
            for suffix in (_LOG_SUFFIX,) + _SIDECAR_SUFFIXES:
                try:
                    self.store.delete(self._blob(m.base, suffix))
                except OSError:
                    pass  # sweep() retries
        return dropped

    def retire(self, bases) -> List[RemoteSegmentMeta]:
        """Remove committed entries whose local segments a compaction
        pass merged away entirely — the rewrite landed in a NEIGHBOR
        base, so no re-upload will ever replace these and they would
        keep serving shadowed pre-compaction records.  Same ordering
        as retention: the manifest shrinks first (the drop commits),
        blobs after; a crash in between leaves `sweep()` work, never
        servable stale data.  Returns the dropped metas."""
        bases = set(bases)
        metas = self.load()
        keep = [m for m in metas if m.base not in bases]
        dropped = [m for m in metas if m.base in bases]
        if not dropped:
            return []
        self._commit(keep)
        for m in dropped:
            for suffix in (_LOG_SUFFIX,) + _SIDECAR_SUFFIXES:
                try:
                    self.store.delete(self._blob(m.base, suffix))
                except OSError:
                    pass  # sweep() retries
        return dropped

    # ------------------------------------------------------------- sweep
    def sweep(self) -> int:
        """Delete every blob under this partition's prefix the manifest
        does not reference — torn mid-upload leftovers, stale stage
        markers, retention stragglers.  Safe because the store dir's
        process lock makes this thread the only writer: an upload can
        never be in flight while its own thread sweeps."""
        referenced = {self._manifest_name}
        for m in self.load():
            for suffix in (_LOG_SUFFIX,) + _SIDECAR_SUFFIXES:
                referenced.add(self._blob(m.base, suffix))
        swept = 0
        for name in self.store.list(self.prefix):
            full = name if name.startswith(self.prefix) \
                else f"{self.prefix}/{name}"
            if full in referenced:
                continue
            try:
                if self.store.delete(full):
                    swept += 1
            except OSError:
                pass  # next pass retries
        if swept:
            tier_swept_blobs.inc(swept)
        return swept


def artifact_store_for(uri: str):
    """Build the ArtifactStore backend for a tier URI (a local directory
    or ``gs://…``).  Imported lazily: the train package hauls in the
    model stack, and a store mount without a tier must not pay for it."""
    from ..train.artifacts import ArtifactStore

    return ArtifactStore(uri)
