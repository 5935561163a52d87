"""Durability helper of ``iotml.store.segment``: ``fsync_dir``.

The segmented log itself is not ported; the port's artifact store and
checkpoints publish files by ``os.replace`` and call this so the rename
survives a host crash.
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a completed rename survives power loss.

    ``os.replace`` makes publication atomic against readers; making it
    durable needs the parent directory's metadata flushed too."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
