"""Durability helpers of ``iotml.store.segment``: ``atomic_write`` and
``fsync_dir``.

The segmented log itself is not ported; the port's artifact store,
checkpoints and model registry publish files by ``os.replace`` and call
these so a reader never sees a torn file and the rename survives a host
crash.
"""

from __future__ import annotations

import os


def atomic_write(path: str, data: bytes, fsync: bool = True) -> None:
    """tmp + rename publication: a reader never observes a half-written
    file."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        if fsync:
            fh.flush()
            os.fsync(fh.fileno())
    os.replace(tmp, path)


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so a completed rename survives power loss.

    ``os.replace`` makes publication atomic against readers; making it
    durable needs the parent directory's metadata flushed too."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
