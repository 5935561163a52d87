"""Durable segmented log storage for the stream broker (``iotml.store``).

The reference's pipeline trains straight from the commit log, "no data
lake", which holds only if the log retains and re-serves history across
process deaths.  This package is that retention: an append-only
segmented log per partition (CRC32C-framed records, configurable fsync,
size/age segment roll, byte, age and count retention, sparse offset and
timestamp indexes), crash recovery that truncates torn tails, a
compacted consumer-offsets file, key-based log compaction for
``cleanup.policy=compact`` topics, a remote tier for sealed segments, and
a replay API (``read_from`` / ``read_since``) for training backfill.

Mounted by ``stream.broker.Broker(store_dir=...)``; every knob rides the
``store.*`` and ``tier.*`` config sections.  The on-disk format is the
JAX package's byte for byte, the replication high-water-mark checkpoint
(``hwm``) included.
"""

from .compact import CompactionStats, StoreCompactor
from .hwm import HwmFile, hwm_file_for
from .log import SegmentedLog, StorePolicy
from .mount import StoreMount
from .offsets import OffsetsFile
from .remote import RemoteSegmentMeta, RemoteTier
from .segment import (SegmentWriter, atomic_write, crc32c, fsync_dir,
                      fsync_file)
from .tiered import RemoteSegmentCache, TieredLog, TierPolicy, TierUploader

__all__ = ["SegmentedLog", "StorePolicy", "StoreMount", "OffsetsFile",
           "SegmentWriter", "atomic_write", "crc32c", "fsync_dir",
           "fsync_file", "CompactionStats", "StoreCompactor", "RemoteTier",
           "RemoteSegmentMeta", "TieredLog", "TierPolicy", "TierUploader",
           "RemoteSegmentCache", "HwmFile", "hwm_file_for"]
