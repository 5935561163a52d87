"""On-disk segment format (``iotml.store.segment``): the durable record
frame and its writer.

One segment is one append-only file holding length-prefixed records:

    u32  length        bytes after this field (frame body)
    u32  crc32c        Castagnoli CRC over every byte after this field
    u8   attrs         bit 0: record carries headers
                       bit 1: null value (a TOMBSTONE, compaction's
                       delete marker; value_len is 0 and the decoded
                       value is None, never b"")
    i64  offset        absolute log offset (self-describing: recovery
                       and index rebuilds never need external state)
    i64  timestamp_ms  record timestamp (the timestamp index key)
    i32  key_len       -1 = null key
    ..   key
    u32  value_len
    ..   value
    [headers when attrs bit 0:
      u16 n; per header: u16 key_len, key, u32 val_len, val]

The layout is shared with the JAX package byte for byte: a store
directory written by one package mounts in the other.  CRC32C is the
native engine's (``cpp/frame_engine.cc``, through
``stream.native.crc32c``); ``_crc32c_py`` is its plain version, run
only when called by name.

``SegmentWriter`` owns every byte written under a store directory: the
file descriptor, the fsync policy (``never`` | ``interval`` |
``always``) and the ``iotml_store_fsync_seconds`` accounting, so
durability promises are made in one place.

Torn writes are the expected crash artifact: a process dying mid-append
leaves a record whose length prefix promises more bytes than the file
holds, or whose CRC does not match.  ``scan_records`` stops at the first
such record; recovery (``log.SegmentedLog``) truncates there and counts
the rest as ``iotml_store_recovery_truncated_bytes``.

Header values: an object that knows its byte form (``.encode()``, e.g.
``obs.tracing.TraceContext``) is stored encoded and comes back as
``bytes``, which ``tracing.from_headers`` accepts, so traces survive a
durable hop as they survive a wire hop.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional, Tuple

from ..obs import metrics as obs_metrics
from ..stream import native

store_fsync_seconds = obs_metrics.default_registry.histogram(
    "iotml_store_fsync_seconds", "segment/offsets fsync latency")

#: frame geometry
_LEN = struct.Struct(">I")
_HEAD = struct.Struct(">IBqqi")    # crc, attrs, offset, timestamp, key_len
_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")
_ATTR_HEADERS = 0x01
_ATTR_NULL_VALUE = 0x02  # tombstone: value_len 0, decoded value None

#: the smallest possible frame body: crc+attrs+offset+ts+key_len + value_len
MIN_BODY = _HEAD.size + _U32.size


# ------------------------------------------------------------------ crc32c
def _make_crc32c_table() -> tuple:
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return tuple(table)


_CRC32C_TABLE = _make_crc32c_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Software CRC32C (Castagnoli): the plain version of ``crc32c``."""
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data`` continuing ``crc``, by the native engine (built
    at first use; a failed build raises)."""
    return native.crc32c(data, crc)


# ------------------------------------------------------------ record codec
def _encode_headers(headers) -> bytes:
    out = [_U16.pack(len(headers))]
    for key, value in headers:
        kb = key.encode() if isinstance(key, str) else bytes(key)
        enc = getattr(value, "encode", None)
        if isinstance(value, (bytes, bytearray)):
            vb = bytes(value)
        elif enc is not None:
            vb = value.encode()  # TraceContext et al: transport byte form
            if isinstance(vb, str):
                vb = vb.encode()
        else:
            vb = str(value).encode()
        out.append(_U16.pack(len(kb)))
        out.append(kb)
        out.append(_U32.pack(len(vb)))
        out.append(vb)
    return b"".join(out)


def _decode_headers(body: bytes, pos: int) -> Optional[tuple]:
    (n,) = _U16.unpack_from(body, pos)
    pos += _U16.size
    out = []
    for _ in range(n):
        (klen,) = _U16.unpack_from(body, pos)
        pos += _U16.size
        key = body[pos:pos + klen].decode()
        pos += klen
        (vlen,) = _U32.unpack_from(body, pos)
        pos += _U32.size
        out.append((key, body[pos:pos + vlen]))
        pos += vlen
    return tuple(out)


def encode_record(offset: int, key: Optional[bytes], value: Optional[bytes],
                  timestamp_ms: int, headers: Optional[tuple]) -> bytes:
    """One framed record (length prefix included).  ``value=None`` frames
    a tombstone (attrs bit 1): byte-distinct from an empty value."""
    attrs = _ATTR_HEADERS if headers else 0
    if value is None:
        attrs |= _ATTR_NULL_VALUE
        value = b""
    parts = [_HEAD.pack(0, attrs, offset, timestamp_ms,
                        -1 if key is None else len(key))]
    if key is not None:
        parts.append(key)
    parts.append(_U32.pack(len(value)))
    parts.append(value)
    if headers:
        parts.append(_encode_headers(headers))
    body = bytearray(b"".join(parts))
    crc = crc32c(bytes(body[_U32.size:]))
    body[:_U32.size] = _U32.pack(crc)
    return _LEN.pack(len(body)) + bytes(body)


def decode_record(body: bytes) -> Tuple[int, Optional[bytes], bytes, int,
                                        Optional[tuple]]:
    """Frame body (length prefix stripped, CRC verified by the caller)
    → (offset, key, value, timestamp_ms, headers)."""
    _crc, attrs, offset, ts, key_len = _HEAD.unpack_from(body, 0)
    pos = _HEAD.size
    key = None
    if key_len >= 0:
        key = body[pos:pos + key_len]
        pos += key_len
    (vlen,) = _U32.unpack_from(body, pos)
    pos += _U32.size
    value = None if attrs & _ATTR_NULL_VALUE else body[pos:pos + vlen]
    pos += vlen
    headers = _decode_headers(body, pos) if attrs & _ATTR_HEADERS else None
    return offset, key, value, ts, headers


def scan_records(data: bytes):
    """Yield (file_pos, next_pos, offset, key, value, ts, headers) for
    every VALID record in ``data``, stopping at the first torn/corrupt
    frame; callers take the last yielded ``next_pos`` as the valid prefix
    length."""
    pos = 0
    n = len(data)
    while pos + _LEN.size <= n:
        (length,) = _LEN.unpack_from(data, pos)
        body_start = pos + _LEN.size
        end = body_start + length
        if length < MIN_BODY or end > n:
            return  # torn: the length prefix promises bytes we don't have
        body = data[body_start:end]
        (crc,) = _U32.unpack_from(body, 0)
        if crc32c(body[_U32.size:]) != crc:
            return  # corrupt frame: recovery truncates here
        offset, key, value, ts, headers = decode_record(body)
        yield pos, end, offset, key, value, ts, headers
        pos = end


# ---------------------------------------------------------------- writer
class SegmentWriter:
    """Owner of every byte written under a store directory.

    Wraps one file opened for append plus the fsync policy.  ``append``
    returns the file position the frame landed at (the offset-index
    entry); the owner (``SegmentedLog``, ``OffsetsFile``) applies the
    fsync cadence.
    """

    def __init__(self, path: str, fsync: str = "interval"):
        if fsync not in ("never", "interval", "always"):
            raise ValueError(f"fsync policy must be never|interval|always, "
                             f"got {fsync!r}")
        self.path = path
        self.fsync = fsync
        self._fh = open(path, "ab")
        self.position = self._fh.tell()

    def append(self, frame: bytes) -> int:
        """Buffered write; batch appends ack once per batch, after the
        owner's sync, so acked ⇒ durable holds under ``fsync=always``."""
        pos = self.position
        self._fh.write(frame)
        self.position = pos + len(frame)
        return pos

    def write_blob(self, blob: bytes) -> int:
        """Raw bytes straight to the file: the offsets/manifest writer
        and the torn-tail injection (a deliberately invalid frame is
        still a write the store must own)."""
        return self.append(blob)

    def sync(self) -> None:
        self._fh.flush()
        t0 = time.perf_counter()
        os.fsync(self._fh.fileno())
        store_fsync_seconds.observe(time.perf_counter() - t0)

    def flush(self) -> None:
        self._fh.flush()

    def truncate_to(self, size: int) -> None:
        """Drop everything past ``size`` (recovery's torn-tail cut)."""
        self._fh.flush()
        self._fh.truncate(size)
        self._fh.seek(0, os.SEEK_END)
        self.position = size

    def close(self, sync: bool = False) -> None:
        if self._fh.closed:
            return
        if sync and self.fsync != "never":
            self.sync()
        else:
            self._fh.flush()
        self._fh.close()


def read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


_SCAN_CHUNK = 256 * 1024


def iter_frames(path: str, pos: int):
    """Stream valid frames from ``pos`` in bounded chunks: a reader that
    stops early (max_records, first timestamp match) never pays for the
    rest of the segment.  Yields ``scan_records``' tuples with absolute
    file positions.  A frame split across a chunk boundary is completed
    by the next read; scanning stops at a corrupt frame (recovery
    truncates there)."""
    buf = b""
    base = pos  # absolute file position of buf[0]
    with open(path, "rb") as fh:
        fh.seek(pos)
        while True:
            chunk = fh.read(_SCAN_CHUNK)
            buf += chunk
            last_end = 0
            for fpos, fend, off, key, value, ts, hdrs in scan_records(buf):
                last_end = fend
                yield (base + fpos, base + fend, off, key, value, ts, hdrs)
            if not chunk:
                return  # EOF: whatever remains is torn/partial
            if last_end == 0 and len(buf) >= _LEN.size:
                # nothing validated: the head frame's own length prefix
                # says whether we are mid-frame (keep reading) or parked
                # on a corrupt frame (stop: nothing after a bad frame is
                # served, recovery's exact contract)
                (claimed,) = _LEN.unpack_from(buf, 0)
                if claimed < MIN_BODY or len(buf) >= _LEN.size + claimed:
                    return
            buf = buf[last_end:]
            base += last_end


_OFFSET = struct.Struct(">q")
#: where a frame's record offset sits: the length prefix, crc and attrs
_OFFSET_AT = _LEN.size + _U32.size + 1


def frame_at(fh, pos: int, end: int, offset: int) -> Optional[Tuple[int, int]]:
    """``(start, stop)`` file positions of the first frame at/after record
    ``offset``, walking length prefixes from ``pos`` (a frame boundary)
    without parsing or CRC-checking bodies; None when no whole frame
    lies before ``end`` or a length prefix is impossible (the readers'
    own walk stops there)."""
    buf = b""
    base = pos  # absolute file position of buf[0]
    while pos + _LEN.size + MIN_BODY <= end:
        rel = pos - base
        if rel + _OFFSET_AT + _OFFSET.size > len(buf):
            fh.seek(pos)
            buf = fh.read(min(_SCAN_CHUNK, end - pos))
            base, rel = pos, 0
            if len(buf) < _OFFSET_AT + _OFFSET.size:
                return None
        (length,) = _LEN.unpack_from(buf, rel)
        if length < MIN_BODY:
            return None
        stop = pos + _LEN.size + length
        if _OFFSET.unpack_from(buf, rel + _OFFSET_AT)[0] >= offset:
            return (pos, stop) if stop <= end else None
        pos = stop
    return None


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
