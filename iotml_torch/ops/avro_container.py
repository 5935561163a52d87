"""Avro Object Container File (OCF) writer and reader
(``iotml.ops.avro_container``'s copy).

The reference's data-lake path sinks the `SENSOR_DATA_S_AVRO` topic to GCS
"in Avro format" via the Kafka Connect GCS connector (reference
`infrastructure/kafka-connect/gcs/README.md:21-43`): standard `.avro`
container files any Avro tool can read.  A file is the magic `Obj\\x01`, a
metadata map carrying the writer schema and codec, a 16-byte sync marker,
then blocks of `(record_count, byte_length, records..., sync)`.  This is
that format (null codec) over the port's own zigzag codec; the bytes equal
the JAX package's for the same path (or the same ``sync``) and records.
"""

from __future__ import annotations

import hashlib
import io
from typing import List, Tuple

from ..core.schema import RecordSchema
from .avro import AvroCodec, zigzag_decode, zigzag_encode

MAGIC = b"Obj\x01"


def _encode_bytes(b: bytes) -> bytes:
    return zigzag_encode(len(b)) + b


def _encode_meta(meta: dict) -> bytes:
    out = bytearray()
    out += zigzag_encode(len(meta))
    for k, v in meta.items():
        out += _encode_bytes(k.encode())
        out += _encode_bytes(v if isinstance(v, bytes) else v.encode())
    out += zigzag_encode(0)  # end of map
    return bytes(out)


def _decode_bytes(buf: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = zigzag_decode(buf, pos)
    return buf[pos:pos + n], pos + n


def _decode_meta(buf: bytes, pos: int) -> Tuple[dict, int]:
    meta = {}
    while True:
        count, pos = zigzag_decode(buf, pos)
        if count == 0:
            return meta, pos
        if count < 0:  # block-size variant: a long byte size follows
            _, pos = zigzag_decode(buf, pos)
            count = -count
        for _ in range(count):
            k, pos = _decode_bytes(buf, pos)
            v, pos = _decode_bytes(buf, pos)
            meta[k.decode()] = v


class ContainerWriter:
    """Write records (already binary-encoded, or dicts via a codec) to an
    OCF file.  One block per `write_block` call."""

    def __init__(self, path: str, schema: RecordSchema, sync: bytes = None):
        self.path = path
        self.schema = schema
        self.codec = AvroCodec(schema)
        # a marker derived from the path keeps files reproducible
        self.sync = sync if sync is not None else \
            hashlib.md5(path.encode()).digest()
        if len(self.sync) != 16:
            raise ValueError(
                f"sync marker must be 16 bytes, got {len(self.sync)}")
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)
        self._fh.write(_encode_meta({
            "avro.schema": schema.avro_json(),
            "avro.codec": "null",
        }))
        self._fh.write(self.sync)
        self.records_written = 0

    def write_block(self, records: List) -> int:
        """records: dicts (encoded via the schema codec) or raw bytes
        (already schema-encoded payloads, e.g. unframed stream messages)."""
        if not records:
            return 0
        body = io.BytesIO()
        for r in records:
            body.write(r if isinstance(r, bytes) else self.codec.encode(r))
        blob = body.getvalue()
        self._fh.write(zigzag_encode(len(records)))
        self._fh.write(zigzag_encode(len(blob)))
        self._fh.write(blob)
        self._fh.write(self.sync)
        self.records_written += len(records)
        return len(records)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "ContainerWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_container(path: str) -> Tuple[RecordSchema, List[dict]]:
    """Read a (null-codec) OCF file → (schema, records)."""
    from ..stream.registry import parse_avsc

    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:4] != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    meta, pos = _decode_meta(buf, 4)
    if meta.get("avro.codec", b"null") not in (b"null", "null"):
        raise ValueError(f"unsupported codec {meta['avro.codec']!r}")
    schema = parse_avsc(meta["avro.schema"].decode()
                        if isinstance(meta["avro.schema"], bytes)
                        else meta["avro.schema"])
    codec = AvroCodec(schema)
    sync = buf[pos:pos + 16]
    pos += 16
    records = []
    while pos < len(buf):
        count, pos = zigzag_decode(buf, pos)
        size, pos = zigzag_decode(buf, pos)
        block = buf[pos:pos + size]
        pos += size
        bpos = 0
        for _ in range(count):
            rec, bpos = codec._decode_at(block, bpos)
            records.append(rec)
        if buf[pos:pos + 16] != sync:
            raise ValueError(f"{path}: bad sync marker at {pos}")
        pos += 16
    return schema, records
