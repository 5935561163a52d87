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
Schema resolution (an evolved writer read by name) is not ported.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from ..core.schema import RecordSchema, Field

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
