"""Versioned model registry (``iotml.mlops.registry``'s twin): the GCS
bucket, grown a commit protocol.

The reference hands models from train to predict as one mutable GCS
object name (cardata-v3.py:227-232, :255-261): no versions, no lineage,
no record of WHAT data a blob was trained through, and a redeploy as
the only rollback.  This registry is that handoff made operable:

- **monotonic versions**: every publish gets the next integer id; a
  version directory is immutable once committed;
- **manifest as commit marker**: artifacts are staged into a hidden
  directory, renamed into place, and only then does ``manifest.json``
  land (via the store's ``atomic_write`` tmp+rename+fsync discipline).
  A crash anywhere mid-publish leaves a manifest-less directory that
  readers never see and ``recover()`` sweeps — the torn-tail tolerance
  of ``iotml.store``, applied to model state;
- **offsets in the manifest**: each version records the exact
  ``(topic, partition, next_offset)`` cursors it was trained through
  (offsets-as-checkpoint, ARCHITECTURE §7) plus metrics and parent
  lineage, so model state and stream position move as ONE atomic unit;
- **channels**: tiny atomic pointer files (``serving``, ``candidate``)
  name the version each role should run; ``promote``/``rollback`` are
  pointer flips recorded in an append-only history, and every serving
  flip is ALSO published through a ``supervise.Topology`` cell
  (version id as the epoch) so in-process watchers detect a new model
  the same way clients detect a new leader.

The directory layout, the file names and the JSON fields are the JAX
package's, so each package reads, resumes from and follows the other's
registry.  A publish passes the chaos point ``registry.commit`` between
the artifacts' rename and the manifest write (a crash there is a torn
publish) and counts into ``iotml_registry_publishes_total``; sweeps and
prunes count into ``iotml_registry_torn_recovered_total`` and
``iotml_registry_pruned_total``; a publish or a serving flip sets
``iotml_model_version{component}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..chaos import faults as chaos
from ..obs import metrics as obs_metrics
from ..store.segment import atomic_write, fsync_dir
from ..supervise.topology import Topology

#: channels a pointer file may name — a typo'd channel write would
#: otherwise mint a pointer no reader ever resolves
CHANNELS = ("serving", "candidate")

_VERSION_FMT = "v{:010d}"


def _version_dirname(version: int) -> str:
    return _VERSION_FMT.format(version)


def _parse_version(name: str) -> Optional[int]:
    if not name.startswith("v") or not name[1:].isdigit():
        return None
    return int(name[1:])


class Manifest:
    """One committed version's metadata (parsed manifest.json)."""

    __slots__ = ("version", "parent", "created_ts", "offsets", "metrics",
                 "artifacts", "step")

    def __init__(self, version: int, parent: Optional[int],
                 created_ts: float, offsets: List[Tuple[str, int, int]],
                 metrics: Dict[str, float], artifacts: Dict[str, dict],
                 step: int = 0):
        self.version = version
        self.parent = parent
        self.created_ts = created_ts
        self.offsets = offsets
        self.metrics = metrics
        self.artifacts = artifacts
        self.step = step

    def to_dict(self) -> dict:
        return {"version": self.version, "parent": self.parent,
                "created_ts": self.created_ts, "step": self.step,
                "offsets": [list(o) for o in self.offsets],
                "metrics": self.metrics, "artifacts": self.artifacts}

    @classmethod
    def from_dict(cls, doc: dict) -> "Manifest":
        return cls(version=int(doc["version"]),
                   parent=(None if doc.get("parent") is None
                           else int(doc["parent"])),
                   created_ts=float(doc.get("created_ts", 0.0)),
                   offsets=[(str(t), int(p), int(o))
                            for t, p, o in doc.get("offsets", [])],
                   metrics=dict(doc.get("metrics", {})),
                   artifacts=dict(doc.get("artifacts", {})),
                   step=int(doc.get("step", 0)))


class ModelRegistry:
    """Filesystem-backed registry: versions/, channels/, history.jsonl.

    Single-process writers are the expected shape (ONE trainer owns
    publication, like ONE SegmentWriter owns a store dir); readers are
    arbitrary.  All mutation goes through this class."""

    def __init__(self, root: str, component: str = "trainer"):
        self.root = os.path.abspath(root)
        #: the ``model_version`` gauge's role label for this process
        self.component = component
        self._versions_dir = os.path.join(self.root, "versions")
        self._channels_dir = os.path.join(self.root, "channels")
        os.makedirs(self._versions_dir, exist_ok=True)
        os.makedirs(self._channels_dir, exist_ok=True)
        #: in-process change feed: serving flips publish
        #: (version-name, epoch=version) exactly like leader promotions,
        #: so a watcher polls one generation counter, not the disk
        serving = self.channel("serving")
        self.cell = Topology(leader=_version_dirname(serving or 0),
                             epoch=serving or 0)

    # ------------------------------------------------------------ paths
    def version_dir(self, version: int) -> str:
        return os.path.join(self._versions_dir, _version_dirname(version))

    def artifact_path(self, version: int, name: str) -> str:
        return os.path.join(self.version_dir(version), name)

    # ---------------------------------------------------------- reading
    def versions(self) -> List[int]:
        """Committed (manifest-intact) versions, ascending.  A version
        directory without a parseable manifest is a torn publish —
        invisible here, swept by ``recover()``."""
        out = []
        try:
            names = os.listdir(self._versions_dir)
        except FileNotFoundError:
            return []
        for name in names:
            v = _parse_version(name)
            if v is None:
                continue
            if self._read_manifest(v) is not None:
                out.append(v)
        return sorted(out)

    def latest(self) -> Optional[int]:
        vs = self.versions()
        return vs[-1] if vs else None

    def _read_manifest(self, version: int) -> Optional[Manifest]:
        path = os.path.join(self.version_dir(version), "manifest.json")
        try:
            with open(path, "rb") as fh:
                doc = json.loads(fh.read().decode())
            m = Manifest.from_dict(doc)
        except (FileNotFoundError, NotADirectoryError, ValueError,
                KeyError, TypeError):
            return None
        if m.version != version:
            return None
        return m

    def manifest(self, version: int) -> Manifest:
        m = self._read_manifest(version)
        if m is None:
            raise KeyError(f"no committed version {version} in {self.root}")
        return m

    def load_bytes(self, version: int, name: str) -> bytes:
        """Read one artifact, verified against the manifest checksum —
        a bit-rotted or truncated blob fails loudly, never loads."""
        m = self.manifest(version)
        if name not in m.artifacts:
            raise KeyError(f"version {version} has no artifact {name!r} "
                           f"(have: {sorted(m.artifacts)})")
        with open(self.artifact_path(version, name), "rb") as fh:
            data = fh.read()
        want = m.artifacts[name].get("sha256")
        if want and hashlib.sha256(data).hexdigest() != want:
            raise ValueError(
                f"artifact {name!r} of version {version} fails its "
                f"manifest checksum (torn or corrupted blob)")
        return data

    # --------------------------------------------------------- channels
    def channel(self, channel: str) -> Optional[int]:
        """Resolve a channel pointer to a committed version.

        A pointer naming a torn/missing version (crash between a sweep
        and a re-point, or manual surgery) falls back to the newest
        intact version instead of serving nothing."""
        self._check_channel(channel)
        try:
            with open(os.path.join(self._channels_dir, channel)) as fh:
                v = _parse_version(fh.read().strip())
        except FileNotFoundError:
            return None
        if v is not None and self._read_manifest(v) is not None:
            return v
        return self.latest()

    @staticmethod
    def _check_channel(channel: str) -> None:
        if channel not in CHANNELS:
            raise ValueError(f"unknown channel {channel!r} "
                             f"(have: {CHANNELS})")

    def set_channel(self, channel: str, version: int,
                    event: str = "set") -> None:
        self._check_channel(channel)
        if self._read_manifest(version) is None:
            raise KeyError(f"cannot point {channel!r} at uncommitted "
                           f"version {version}")
        atomic_write(os.path.join(self._channels_dir, channel),
                     _version_dirname(version).encode())
        self._history({"event": event, "channel": channel,
                       "version": version, "t": time.time()})
        if channel == "serving":
            # epochs only move forward in a Topology; a rollback is a
            # NEW term serving an OLD version, exactly like a failover
            # is a new epoch serving the old log — so the epoch is
            # max(version, current+1), and the leader string names the
            # version being served
            epoch = max(version, self.cell.epoch + 1)
            self.cell.publish(_version_dirname(version), epoch)
            obs_metrics.model_version.set(version,
                                          component=self.component)

    def promote(self, version: int) -> None:
        """candidate → serving (the rollout gate's accept edge)."""
        self.set_channel("serving", version, event="promote")

    def rollback(self, version: int) -> None:
        """serving → an older committed version (the reject edge)."""
        self.set_channel("serving", version, event="rollback")

    def history(self) -> List[dict]:
        """Parsed history events; a torn last line (crash mid-append)
        is skipped, not fatal."""
        out = []
        try:
            with open(os.path.join(self.root, "history.jsonl")) as fh:
                for line in fh:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail
        except FileNotFoundError:
            pass
        return out

    def _history(self, event: dict) -> None:
        with open(os.path.join(self.root, "history.jsonl"), "a") as fh:
            fh.write(json.dumps(event, sort_keys=True) + "\n")

    # --------------------------------------------------------- writing
    def next_version(self) -> int:
        latest = self.latest()
        return 1 if latest is None else latest + 1

    def publish(self, artifacts: Dict[str, bytes], *,
                offsets: Sequence[Tuple[str, int, int]] = (),
                metrics: Optional[Dict[str, float]] = None,
                step: int = 0,
                parent: Optional[int] = None) -> Manifest:
        """Commit a new version.  Crash-safe by construction:

        1. artifacts land (fsynced) in a hidden ``.stage-*`` dir;
        2. the stage dir is renamed to ``versions/vN`` — visible but
           NOT committed (no manifest yet; readers skip it);
        3. ``manifest.json`` is atomic-written LAST: its appearance IS
           the commit, after which the version is immutable.

        A kill at any point leaves either a stage dir or a manifest-less
        version dir; both are invisible to readers and swept by
        ``recover()``, which also means version ids of failed publishes
        are reused — ids number COMMITS, not attempts."""
        version = self.next_version()
        if parent is None:
            parent = self.channel("serving") or self.latest()
        stage = os.path.join(self.root,
                             f".stage-{_version_dirname(version)}-{os.getpid()}")
        os.makedirs(stage, exist_ok=True)
        art_meta = {}
        for name, data in artifacts.items():
            if name == "manifest.json" or os.sep in name:
                raise ValueError(f"illegal artifact name {name!r}")
            atomic_write(os.path.join(stage, name), data)
            art_meta[name] = {"sha256": hashlib.sha256(data).hexdigest(),
                              "bytes": len(data)}
        final = self.version_dir(version)
        if os.path.isdir(final):
            # a previous torn publish of this reused id (manifest-less
            # by definition, or versions() would have numbered past it)
            shutil.rmtree(final)
        os.replace(stage, final)
        # a crash HERE leaves a manifest-less version dir: the torn
        # publish readers never serve and recover() sweeps
        chaos.point("registry.commit")
        manifest = Manifest(version=version, parent=parent,
                            created_ts=time.time(),
                            offsets=[tuple(o) for o in offsets],
                            metrics=dict(metrics or {}),
                            artifacts=art_meta, step=step)
        atomic_write(os.path.join(final, "manifest.json"),
                     json.dumps(manifest.to_dict(), indent=2,
                                sort_keys=True).encode())
        # two direntry flushes, both load-bearing: the manifest's
        # rename lives in vN/ (without it a power cut can undo the
        # commit AFTER the group commit trailed it — committed offsets
        # past the newest durable manifest), the stage->vN rename in
        # versions/
        fsync_dir(final)
        fsync_dir(self._versions_dir)
        self._history({"event": "publish", "version": version,
                       "parent": parent, "t": manifest.created_ts})
        obs_metrics.registry_publishes.inc()
        obs_metrics.model_version.set(version, component=self.component)
        return manifest

    # --------------------------------------------------------- recovery
    def recover(self) -> int:
        """Sweep torn publishes: stage dirs and manifest-less version
        dirs (a writer died mid-commit).  Returns dirs removed.  Safe
        to run on every mount — committed versions are never touched."""
        removed = 0
        for name in os.listdir(self.root):
            if name.startswith(".stage-"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
                removed += 1
        for name in os.listdir(self._versions_dir):
            v = _parse_version(name)
            if v is None:
                continue
            if self._read_manifest(v) is None:
                shutil.rmtree(os.path.join(self._versions_dir, name),
                              ignore_errors=True)
                removed += 1
        if removed:
            obs_metrics.registry_torn_recovered.inc(removed)
        # a pointer may now name a swept version; channel() already
        # falls back on read, but re-anchor the in-process cell too
        serving = self.channel("serving")
        if serving is not None and \
                _version_dirname(serving) != self.cell.leader:
            self.cell.publish(_version_dirname(serving),
                              max(serving, self.cell.epoch + 1))
        return removed

    def prune(self, keep: int) -> int:
        """Bound the registry: remove committed versions older than the
        newest ``keep``, never a channel target (a rolled-back serving
        version stays restorable for as long as it serves).  Returns
        versions removed.  Version ids stay monotonic — ``latest()``
        survives every prune, so ``next_version`` never reuses an id.
        Bounding the version count also bounds ``versions()``'s
        manifest sweep, keeping publish cost flat over a trainer's
        lifetime."""
        if keep <= 0:
            return 0
        vs = self.versions()
        pinned = {self.channel(c) for c in CHANNELS}
        removed = 0
        for v in vs[:-keep] if len(vs) > keep else []:
            if v in pinned:
                continue
            shutil.rmtree(self.version_dir(v), ignore_errors=True)
            removed += 1
        if removed:
            fsync_dir(self._versions_dir)
            self._history({"event": "prune", "removed": removed,
                           "t": time.time()})
            obs_metrics.registry_pruned.inc(removed)
        return removed

    # ------------------------------------------------------ introspection
    def describe(self) -> dict:
        vs = self.versions()
        return {
            "root": self.root,
            "versions": vs,
            "serving": self.channel("serving"),
            "candidate": self.channel("candidate"),
            "latest": vs[-1] if vs else None,
        }
