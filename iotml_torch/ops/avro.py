"""Schema-compiled Avro binary codec → columnar numpy blocks
(``iotml.ops.avro``'s pure codec).

The reference decodes with the C++ ``tensorflow_io.kafka.decode_avro`` op
(cardata-v3.py:53-74).  The port's data path decodes a whole poll in one
call of the native engine (``stream.native.NativeCodec``); this
pure-Python codec is that engine's plain version and the test oracle,
reached only by an explicit call.

Supported schema features are exactly what the car/KSQL schemas need:
primitives float/double/int/long/boolean/string/bytes and the nullable
2-branch union ``["null", T]`` with the Avro spec's zigzag-varint framing.
``ResolvingCodec`` reads a mixed-version topic: each framed message is
decoded with its writer's schema and projected onto the reader's by
field name (``needs_resolution`` is the per-message header test that
routes a chunk there).
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from ..core.schema import WRITER_SCHEMAS, Field, RecordSchema
from .framing import unframe

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


# ---------------------------------------------------------------- primitives
def zigzag_encode(n: int) -> bytes:
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def zigzag_decode(buf: bytes, pos: int) -> tuple:
    shift = 0
    acc = 0
    while True:
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return (acc >> 1) ^ -(acc & 1), pos


class AvroCodec:
    """Encoder/decoder for one record schema.

    ``decode_batch(messages)`` returns a dict {field_name: numpy array};
    string columns come back as object arrays.  ``encode(record)`` takes a
    dict keyed by field name (missing nullable fields encode as null).
    """

    def __init__(self, schema: RecordSchema):
        self.schema = schema
        self._fields: Sequence[Field] = schema.fields

    # ------------------------------------------------------------ encoding
    def encode(self, record: dict) -> bytes:
        out = bytearray()
        for f in self._fields:
            v = record.get(f.name)
            if f.nullable:
                if v is None:
                    out += zigzag_encode(0)  # union branch 0 = null
                    continue
                out += zigzag_encode(1)
            self._encode_prim(out, f.avro_type, v)
        return bytes(out)

    @staticmethod
    def _encode_prim(out: bytearray, t: str, v):
        if t == "float":
            out += _F32.pack(float(v))
        elif t == "double":
            out += _F64.pack(float(v))
        elif t in ("int", "long"):
            out += zigzag_encode(int(v))
        elif t == "boolean":
            out.append(1 if v else 0)
        elif t == "string":
            b = v.encode() if isinstance(v, str) else bytes(v)
            out += zigzag_encode(len(b)) + b
        elif t == "bytes":
            out += zigzag_encode(len(v)) + bytes(v)
        else:  # pragma: no cover
            raise TypeError(f"unsupported avro primitive {t}")

    # ------------------------------------------------------------ decoding
    def decode(self, message: bytes) -> dict:
        return self._decode_at(message, 0)[0]

    def _decode_at(self, buf: bytes, pos: int) -> tuple:
        """Decode one record starting at pos → (record, next_pos).  The
        position-tracking form lets container blocks hold many records."""
        rec = {}
        for f in self._fields:
            if f.nullable:
                branch, pos = zigzag_decode(buf, pos)
                if branch == 0:
                    rec[f.name] = None
                    continue
            rec[f.name], pos = self._decode_prim(buf, pos, f.avro_type)
        return rec, pos

    @staticmethod
    def _decode_prim(buf: bytes, pos: int, t: str):
        if t == "float":
            return _F32.unpack_from(buf, pos)[0], pos + 4
        if t == "double":
            return _F64.unpack_from(buf, pos)[0], pos + 8
        if t in ("int", "long"):
            return zigzag_decode(buf, pos)
        if t == "boolean":
            return bool(buf[pos]), pos + 1
        if t in ("string", "bytes"):
            n, pos = zigzag_decode(buf, pos)
            raw = buf[pos:pos + n]
            return (raw.decode() if t == "string" else raw), pos + n
        raise TypeError(f"unsupported avro primitive {t}")  # pragma: no cover

    def decode_batch(self, messages: List[bytes], null_fill=0.0) -> dict:
        """Decode many messages into columns.

        Nullable numeric fields decode nulls to ``null_fill``; nullable
        strings decode nulls to ``""`` (matching the reference's observed
        'no value' label case, cardata-v3.py:267).
        """
        n = len(messages)
        cols = {}
        for f in self._fields:
            if f.avro_type in ("string", "bytes"):
                cols[f.name] = np.empty((n,), object)
            else:
                cols[f.name] = np.zeros((n,), f.np_dtype)
        for i, msg in enumerate(messages):
            rec = self.decode(msg)
            for f in self._fields:
                v = rec[f.name]
                if v is None:
                    v = "" if f.avro_type in ("string", "bytes") else null_fill
                cols[f.name][i] = v
        return cols

    def sensor_matrix(self, cols: dict, dtype=np.float64) -> np.ndarray:
        """Stack the sensor columns (schema order, label excluded) into
        a [N, num_sensors] matrix — the decode→stack step the reference does
        in-graph (cardata-v3.py:150-168)."""
        names = [f.name for f in self.schema.sensor_fields]
        return np.stack([cols[n].astype(dtype) for n in names], axis=1)


# ------------------------------------------------------ schema evolution
#: the Confluent frame header every pre-evolution payload carries
#: (magic 0 + schema id 1)
_V1_HEADER = b"\x00\x00\x00\x00\x01"


def needs_resolution(value: bytes) -> bool:
    """True for a well-formed Confluent frame whose writer id is a KNOWN
    non-default schema; unknown ids and non-Confluent payloads return
    False, so their failure mode does not change."""
    if len(value) < 5 or value[:5] == _V1_HEADER or value[0] != 0:
        return False
    return int.from_bytes(value[1:5], "big") in WRITER_SCHEMAS


def resolve_record(rec: dict, reader: RecordSchema) -> dict:
    """Avro schema resolution by name: reader fields take the writer's
    value; writer-only fields are dropped; a nullable reader field the
    writer lacks becomes null, and a required one raises (an
    incompatible evolution)."""
    out = {}
    for f in reader.fields:
        if f.name in rec:
            out[f.name] = rec[f.name]
        elif f.nullable:
            out[f.name] = None
        else:
            raise ValueError(
                f"incompatible schema evolution: required reader field "
                f"{f.name!r} missing from writer record")
    return out


class ResolvingCodec:
    """Schema-id-dispatching decoder for mixed-version topics: every
    framed message is decoded with the codec of the writer its frame
    names, then projected onto the fixed reader schema."""

    def __init__(self, reader: RecordSchema):
        self.reader = reader
        self.codec = AvroCodec(reader)
        self.writers = {sid: (schema, AvroCodec(schema))
                        for sid, schema in WRITER_SCHEMAS.items()}

    def decode_framed(self, message: bytes) -> dict:
        """One framed message → a record in the reader's fields."""
        sid, payload = unframe(message)
        entry = self.writers.get(sid)
        if entry is None:
            raise ValueError(f"unknown writer schema id {sid}")
        schema, codec = entry
        rec = codec.decode(payload)
        if schema is self.reader:
            return rec
        return resolve_record(rec, self.reader)

    def decode_batch_framed(self, messages: List[bytes],
                            null_fill=0.0) -> dict:
        """Mixed-version batch → reader-schema columns (the
        ``AvroCodec.decode_batch`` contract, resolution included)."""
        n = len(messages)
        cols = {}
        for f in self.reader.fields:
            if f.avro_type in ("string", "bytes"):
                cols[f.name] = np.empty((n,), object)
            else:
                cols[f.name] = np.zeros((n,), f.np_dtype)
        for i, msg in enumerate(messages):
            rec = self.decode_framed(msg)
            for f in self.reader.fields:
                v = rec[f.name]
                if v is None:
                    v = "" if f.avro_type in ("string", "bytes") \
                        else null_fill
                cols[f.name][i] = v
        return cols
