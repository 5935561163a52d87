"""Confluent Schema-Registry wire framing (``iotml.ops.framing``'s head).

Records on the Kafka topic the ML layer consumes are not bare Avro: the
Schema Registry serializer prepends a 5-byte header — magic byte ``0``
plus a big-endian uint32 schema id.  The reference strips it in-graph
with ``tf.strings.substr(e, 5, -1)`` (cardata-v3.py:50).  The format is
kept byte-compatible so the port's stream interoperates with real
Confluent payloads.  The store's raw frame batches are not ported.
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
