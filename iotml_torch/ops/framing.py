"""Confluent Schema-Registry wire framing and the store's frame batches
(``iotml.ops.framing``, cut to its head and its write path).

Records on the Kafka topic the ML layer consumes are not bare Avro: the
Schema Registry serializer prepends a 5-byte header — magic byte ``0``
plus a big-endian uint32 schema id.  The reference strips it in-graph
with ``tf.strings.substr(e, 5, -1)`` (cardata-v3.py:50).  The format is
kept byte-compatible so the port's stream interoperates with real
Confluent payloads.

A frame batch is contiguous segmented-log frames (``store.segment``'s
layout).  ``frame_entries`` frames a produce batch in one call of the
native engine (``cpp/frame_engine.cc``), the durable broker's fused
``produce_many``; a failed engine build raises, nothing falls back.
Entries with headers (traced records) take the per-record codec
(``encode_frame_batch``), their only encoder, as in the JAX package.
The raw fetch and produce legs (restamp, validate, the columnar decode)
are not ported.
"""

from __future__ import annotations

import struct

MAGIC = 0
SCHEMA_ID_DEFAULT = 1
_HDR = struct.Struct(">bI")


def frame(payload: bytes, schema_id: int = SCHEMA_ID_DEFAULT) -> bytes:
    """Prepend the Confluent 5-byte header."""
    return _HDR.pack(MAGIC, schema_id) + payload


def unframe(message: bytes) -> tuple:
    """Split a framed message into (schema_id, payload).

    Raises ValueError on a non-Confluent magic byte — callers that want the
    reference's permissive substr(5) behavior should use ``strip_frame``.
    """
    magic, schema_id = _HDR.unpack_from(message)
    if magic != MAGIC:
        raise ValueError(f"bad Confluent magic byte: {magic}")
    return schema_id, message[5:]


def strip_frame(message: bytes) -> bytes:
    """Reference-equivalent framing strip: drop the first 5 bytes blindly."""
    return message[5:]


class CorruptFrameError(ValueError):
    """A pre-framed batch failed CRC/offset validation at frame `index`:
    the whole batch is rejected and nothing is appended."""

    def __init__(self, index: int, detail: str = ""):
        super().__init__(
            f"corrupt frame batch at frame {index}"
            + (f": {detail}" if detail else "")
            + " — whole batch rejected, nothing appended")
        self.index = index


def encode_frame_batch(entries) -> bytes:
    """[(offset, key, value, timestamp_ms, headers)] → contiguous frame
    bytes through the store's per-record codec (``encode_record``): the
    plain version of ``frame_entries`` and the encoder of traced
    records."""
    from ..store import segment as seg

    return b"".join(
        seg.encode_record(off, key, value, ts, headers)
        for off, key, value, ts, headers in entries)


def iter_frame_entries(buf: bytes):
    """Yield (offset, key, value, timestamp_ms, headers) for every valid
    frame in ``buf``, through the store's one frame parser."""
    from ..store import segment as seg

    for _pos, _end, off, key, value, ts, hdrs in seg.scan_records(buf):
        yield off, key, value, ts, hdrs


def frame_entries(entries, base_offset: int = 0) -> bytes:
    """[(key, value, timestamp_ms[, headers])] → contiguous store frames
    stamped ``base_offset + i``: one native engine call when no entry
    carries headers, the per-record codec otherwise.  The bytes are the
    same either way (pinned by tests)."""
    from ..stream import native

    entries = entries if isinstance(entries, list) else list(entries)
    if any(len(e) > 3 and e[3] for e in entries):
        return encode_frame_batch(
            (base_offset + i, e[0], e[1], e[2], e[3] if len(e) > 3 else None)
            for i, e in enumerate(entries))
    return native.frames_encode_values(entries, base_offset)
