"""Store mount (``iotml.store.mount``): one durable directory serving one
broker.

Directory layout::

    <store_dir>/topics.json                      topic manifest
    <store_dir>/offsets                          consumer-group offsets
    <store_dir>/segments/<topic>/<partition>/    one SegmentedLog each

The manifest records every topic's partition count and retention so a
restarted broker re-creates the same TopicSpecs before serving (a
consumer must never observe a mounted broker with fewer partitions than
it committed against).  Topic names are sanitized into directory names
conservatively; the manifest keeps the real name, so lookups never
depend on the sanitized form being reversible.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

from . import segment as seg
from .log import SegmentedLog, StorePolicy
from .offsets import OffsetsFile

_MANIFEST = "topics.json"
_UNSAFE = re.compile(r"[^A-Za-z0-9._-]")


def _dirname_for(topic: str) -> str:
    """Filesystem-safe directory name.  When sanitization had to change
    anything, a CRC of the REAL name is appended so two topics that
    sanitize identically ("a b" vs "a_b") can never share a directory —
    two SegmentedLogs interleaving one active segment is unrecoverable."""
    import zlib

    safe = _UNSAFE.sub("_", topic)
    if safe == topic:
        return safe
    return f"{safe or '_'}-{zlib.crc32(topic.encode()):08x}"


class StoreMount:
    """Owns the manifest, the offsets file and every partition log of
    one store directory.  The broker calls in under its own lock."""

    def __init__(self, dir: str, policy: Optional[StorePolicy] = None,
                 tier=None):
        self.dir = dir
        self.policy = policy or StorePolicy()
        #: TierPolicy with a uri → every partition log mounts as a
        #: TieredLog over one shared ArtifactStore backend; falsy →
        #: plain local SegmentedLogs (the seed behavior, zero cost)
        self.tier = tier if tier else None
        self._tier_store = None
        if self.tier is not None:
            from .remote import artifact_store_for

            self._tier_store = artifact_store_for(self.tier.uri)
        os.makedirs(dir, exist_ok=True)
        self._acquire_dir_lock()
        self._logs: Dict[tuple, SegmentedLog] = {}
        self._manifest: Dict[str, dict] = {}
        self._load_manifest()
        self.offsets = OffsetsFile(dir, fsync=self.policy.fsync,
                                   fsync_interval_s=self.policy
                                   .fsync_interval_s)

    def _acquire_dir_lock(self) -> None:
        """One broker PROCESS per store dir (Kafka's .lock file): two
        writers interleaving frames in one active segment is exactly the
        corruption recovery cannot undo.  POSIX record locks (lockf) on
        purpose — they conflict across processes but not within one, so
        a crash-simulating remount in the same process (the chaos
        runner's kill) still mounts, and the kernel drops the lock when
        a dead process's fds close (no stale-lockfile recovery needed)."""
        self._lock_fd = os.open(os.path.join(self.dir, ".lock"),
                                os.O_CREAT | os.O_RDWR, 0o644)
        try:
            import fcntl

            fcntl.lockf(self._lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except ImportError:  # non-POSIX: single-writer is unenforced
            pass
        except OSError:
            os.close(self._lock_fd)
            self._lock_fd = None
            raise RuntimeError(
                f"store dir {self.dir!r} is locked by another broker "
                f"process; two writers would corrupt the segments "
                f"(stop the other platform, or use a different "
                f"--store-dir)") from None

    # ---------------------------------------------------------- manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def _load_manifest(self) -> None:
        path = self._manifest_path()
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as fh:
                self._manifest = json.load(fh)

    def _save_manifest(self) -> None:
        blob = json.dumps(self._manifest, indent=2, sort_keys=True).encode()
        seg.atomic_write(self._manifest_path(), blob,
                         fsync=self.policy.fsync != "never")

    def topics(self) -> List[dict]:
        """Manifest entries for mount-time topic re-creation:
        [{name, partitions, retention_*}]."""
        return [dict(doc, name=name)
                for name, doc in sorted(self._manifest.items())]

    def register_topic(self, name: str, partitions: int,
                       retention_messages=None, retention_bytes=None,
                       retention_ms=None,
                       cleanup_policy: str = "delete") -> None:
        doc = {
            "dir": _dirname_for(name),
            "partitions": int(partitions),
            "retention_messages": retention_messages,
            "retention_bytes": retention_bytes,
            "retention_ms": retention_ms,
            "cleanup_policy": cleanup_policy,
        }
        if self._manifest.get(name) == doc:
            return  # mount-time re-registration: no rewrite+fsync per topic
        self._manifest[name] = doc
        self._save_manifest()

    # -------------------------------------------------------------- logs
    def log_for(self, topic: str, partition: int) -> SegmentedLog:
        key = (topic, int(partition))
        log = self._logs.get(key)
        if log is None:
            doc = self._manifest.get(topic) or {"dir": _dirname_for(topic)}
            pdir = os.path.join(self.dir, "segments", doc["dir"],
                                str(int(partition)))
            labels = {"topic": topic, "partition": str(partition)}
            if self._tier_store is not None:
                from .remote import RemoteTier
                from .tiered import TieredLog

                remote = RemoteTier(
                    self._tier_store,
                    prefix=f"tiered/{doc['dir']}/{int(partition)}")
                log = TieredLog(pdir, policy=self.policy, remote=remote,
                                tier=self.tier, metric_labels=labels)
            else:
                log = SegmentedLog(pdir, policy=self.policy,
                                   metric_labels=labels)
            self._logs[key] = log
        return log

    def recovered_truncated_bytes(self) -> int:
        return sum(l.recovered_truncated_bytes
                   for l in self._logs.values()) + \
            self.offsets.recovered_truncated_bytes

    def flush(self) -> None:
        for log in self._logs.values():
            log.flush()
        self.offsets.flush()

    def close(self) -> None:
        for log in self._logs.values():
            log.close()
        self.offsets.close()
        if getattr(self, "_lock_fd", None) is not None:
            os.close(self._lock_fd)  # releases the lockf lock
            self._lock_fd = None
