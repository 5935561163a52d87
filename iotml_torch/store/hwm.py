"""Quorum high-water-mark checkpoint file (``iotml.store.hwm``'s copy):
the replication HWM persisted across a remount.

Kafka keeps each partition's high-water mark in a
``replication-offset-checkpoint`` file, so a restarted broker knows how
far the quorum had committed before the crash.  This is the same: one
small JSON document a store directory, ``"topic:partition"`` → quorum
HWM, written through the store's own ``atomic_write`` (every byte under
a store directory has one writer package).  The bytes are the JAX
package's.

On a remount crash recovery may bring back records PAST the persisted
HWM (appended by the old leader, never quorum-acked).  They are kept,
but the replication state re-anchors its fetch ceiling at the persisted
mark, so consumers cannot read that tail until followers have mirrored
it and the quorum HWM passes it again.  A torn or corrupt file reads as
no checkpoint (the ceiling re-anchors at the log end) rather than
refusing the mount.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from . import segment

_FILENAME = "replication-hwm.json"


class HwmFile:
    """Atomic-rewrite checkpoint of per-partition quorum HWMs.  Not
    thread-safe by itself: its one caller, the replication state's
    persist path, serializes stores (and never writes under its tracking
    lock)."""

    def __init__(self, store_dir: str):
        self.path = os.path.join(store_dir, _FILENAME)

    def load(self) -> Dict[Tuple[str, int], int]:
        """{(topic, partition): hwm}; empty when absent or torn."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        out: Dict[Tuple[str, int], int] = {}
        for key, v in doc.get("hwm", {}).items():
            topic, _, part = key.rpartition(":")
            try:
                out[(topic, int(part))] = int(v)
            except ValueError:
                continue  # one malformed row never poisons the rest
        return out

    def store(self, hwms: Dict[Tuple[str, int], int]) -> None:
        """Persist the whole map (tmp + rename + fsync, as the topic
        manifest is published)."""
        doc = {"hwm": {f"{t}:{p}": int(v)
                       for (t, p), v in sorted(hwms.items())}}
        segment.atomic_write(self.path,
                             json.dumps(doc, sort_keys=True).encode())


def hwm_file_for(store_dir: Optional[str]) -> Optional[HwmFile]:
    """The store directory's HWM checkpoint (None in memory: nothing
    survives the process anyway)."""
    return HwmFile(store_dir) if store_dir else None
