"""ctypes bindings for the port's C++ stream engine (``iotml.stream.native``).

Seven sources in ``iotml_torch/cpp/``, copies of the JAX package's engines,
build into one library:

- ``avro_engine.cc``: one call decodes a whole poll of Confluent-framed
  Avro messages into columnar numpy buffers (with a null bitmap, or in
  the strict mode that pass-through validation needs), and encodes the
  other way, with nulls (``NativeCodec``);
- ``json_engine.cc``: one call parses a whole poll of flat JSON objects
  into the same columnar layout (``NativeCodec.json_decode_batch``, the
  KSQL stage's JSON→AVRO leg), flagging each row it cannot reproduce
  exactly for the Python leg;
- ``fmt_engine.cc``: one call formats a drain's prediction rows
  byte-identical to ``np.array2string`` (``serve.fastfmt``);
- ``msgset_engine.cc``: one call encodes or decodes a Kafka MessageSet v1
  (``msgset_encode``, ``msgset_decode``: the wire client's produce
  requests and fetch responses, the wire server's the other way round);
- ``kafka_client.cc``: the native Kafka wire client and its fused
  fetch-and-decode (``stream.native_kafka.NativeKafkaBroker``), whose
  message sets go through ``msgset_engine.cc`` and whose decode is
  ``avro_engine.cc``'s;
- ``mqtt_ingest.cc``: the native MQTT ingest front, an epoll loop and
  frame parser that acks QoS 0/1 publishes and hands their (topic,
  payload) pairs to Python in bulk drains (``mqtt.native_ingest``);
- ``frame_engine.cc``: the store's frame codec: its CRC32C (``crc32c``);
  one call that frames a whole batch of records as ready-to-append
  segment frames (``frames_encode_values``, the durable broker's
  ``produce_many``) or encodes columnar rows straight into them
  (``NativeCodec.encode_frames``, the KSQL JSON leg's raw produce); one
  that validates a pre-framed batch whole and stamps its offsets
  (``frames_restamp``, the RAW_PRODUCE landing) or walks it
  (``frames_validate``); and the columnar decoder of raw frame batches
  (``FrameDecoder``, the columnar ring's one decode entry).

The library is built with g++ at first use, never at import:

    g++ -O3 -march=native -fPIC -shared -std=c++17 -Wall
        -o cpp/build/libiotml_torch_stream-<hash>.so avro_engine.cc \
        fmt_engine.cc msgset_engine.cc kafka_client.cc json_engine.cc \
        mqtt_ingest.cc frame_engine.cc

``<hash>`` covers the sources, the header, the flags, the compiler's
version and what ``-march=native`` means on this host, so an edited
source builds anew, and neither a stale library nor one built for
another CPU is ever loaded.  Each build
writes a name unique to its process and ``os.replace``s it into place,
so processes that build at once cannot tear each other's library.
There is no silent fallback: a failed build raises with the compiler's
output, and the pure codecs (``ops.avro``, ``kafka_wire``'s
``_encode_message_set_py`` / ``_decode_message_set_py``, the store's
``segment._crc32c_py`` and ``encode_record``) and the per-element
formatter (``fastfmt.format_rows_plain``) run only when called by name.

``stats`` counts the rows each engine call carried and the seconds it
took (``frame_decode`` the rows the columnar decoder wrote, ``frame_encode``
the frames either framing call wrote, ``frame_restamp`` the frames a
RAW_PRODUCE landing stamped) (the wire server's handler threads count into it too, under a
lock), and the rows the stream processor's native legs handed to their
Python leg for exactness (``*_fallback_rows``: ``json`` rows the JSON
parser flagged, ``decode`` rows of Avro source batches decoded in
Python, ``encode`` sink rows encoded in Python, ``rekey`` rows of
pass-through batches re-encoded in Python, ``count`` rows of COUNT
batches folded in Python); ``reset_stats()`` sets them to 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..core.schema import RecordSchema

CPP = Path(__file__).resolve().parent.parent / "cpp"
SOURCES = ("avro_engine.cc", "fmt_engine.cc", "msgset_engine.cc",
           "kafka_client.cc", "json_engine.cc", "mqtt_ingest.cc",
           "frame_engine.cc")
HEADERS = ("utf8_check.h",)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-Wall")

_TYPE_CODE = {"float": 0, "double": 1, "int": 2, "long": 3, "string": 4,
              "boolean": 5}
LABEL_STRIDE = 16  # fits "true"/"false"/"" labels with headroom
#: bytes a row for message keys in the fused decode (MQTT-topic car keys
#: fit with room; longer keys are cut at KEY_STRIDE - 1 bytes)
KEY_STRIDE = 64

_i64, _i8, _u8 = ctypes.c_int64, ctypes.c_int8, ctypes.c_uint8
_i32, _vp, _str = ctypes.c_int32, ctypes.c_void_p, ctypes.c_char_p
_P = ctypes.POINTER
#: every entry point's (restype, argtypes)
_SIGNATURES = {
    "iotml_decode_batch": (_i64, [
        ctypes.c_char_p, _P(_i64), _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_double), ctypes.c_char_p, _i64]),
    "iotml_decode_batch_nulls": (_i64, [
        ctypes.c_char_p, _P(_i64), _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_double), ctypes.c_char_p, _i64, _P(_u8)]),
    "iotml_decode_batch_strict": (_i64, [
        ctypes.c_char_p, _P(_i64), _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_double), ctypes.c_char_p, _i64]),
    "iotml_encode_batch": (_i64, [
        _P(ctypes.c_double), ctypes.c_char_p, _i64, _i64, _P(_i8), _P(_u8),
        _i64, _i64, _P(_u8), _i64, _P(_i64)]),
    "iotml_encode_batch_nulls": (_i64, [
        _P(ctypes.c_double), ctypes.c_char_p, _i64, _i64, _P(_i8), _P(_u8),
        _i64, _i64, _P(_u8), _i64, _P(_i64), _P(_u8)]),
    "iotml_json_decode_batch": (_i64, [
        ctypes.c_char_p, _P(_i64), _i64, ctypes.c_char_p, _P(_i64),
        _P(_i8), _P(_u8), _i64, _P(ctypes.c_double), _i64,
        ctypes.c_char_p, _i64, _i64, _P(_u8), _P(_u8)]),
    "iotml_format_rows_f32": (_i64, [
        _P(ctypes.c_float), _i64, _i64, ctypes.c_char_p, _i64, _P(_i64),
        _P(_u8)]),
    "iotml_format_rows_f64": (_i64, [
        _P(ctypes.c_double), _i64, _i64, ctypes.c_char_p, _i64, _P(_i64),
        _P(_u8)]),
    "iotml_msgset_encode": (_i64, [
        ctypes.c_char_p, _P(_i64), _P(_u8), ctypes.c_char_p, _P(_i64),
        _P(_u8), _P(_i64), _P(_i64), _i64, _P(_u8), _i64]),
    "iotml_msgset_decode": (_i64, [
        ctypes.c_char_p, _i64, _i64, _P(_i64), _P(_i64), _P(_i64), _P(_u8),
        _P(_u8), _i64, _P(_i64), _P(_u8), _P(_u8), _i64]),
    # the Kafka client (kafka_client.cc): without these ctypes would pass
    # handles and int64s as 32-bit ints
    "iotml_kafka_connect": (_vp, [_str, _i32, _str, _str, _str,
                                  ctypes.c_double]),
    "iotml_kafka_close": (None, [_vp]),
    "iotml_kafka_set_pinned_id_limit": (None, [_vp, _i64]),
    "iotml_kafka_metadata": (_i64, [_vp, _str]),
    "iotml_kafka_create_topic": (_i64, [_vp, _str, _i32, _str]),
    "iotml_kafka_list_offset": (_i64, [_vp, _str, _i32, _i64]),
    "iotml_kafka_produce": (_i64, [
        _vp, _str, _i32, _str, _P(_i64), _P(_u8), _str, _P(_i64), _P(_u8),
        _P(_i64), _i64]),
    "iotml_kafka_produce_raw": (_i64, [_vp, _str, _i32, _P(_u8), _i64]),
    "iotml_kafka_fetch": (_i64, [_vp, _str, _i32, _i64, _i64]),
    "iotml_kafka_staged_bytes": (_i64, [_vp, _P(_i64), _P(_i64)]),
    "iotml_kafka_staged_value_nulls": (_i64, [_vp, _P(_u8)]),
    "iotml_kafka_high_watermark": (_i64, [_vp]),
    "iotml_kafka_take": (_i64, [
        _vp, _str, _P(_i64), _str, _P(_i64), _P(_u8), _P(_i64), _P(_i64)]),
    "iotml_kafka_fetch_decode": (_i64, [
        _vp, _str, _i32, _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_double), _str, _i64, _i64, _P(_i64)]),
    "iotml_kafka_fetch_decode_keys": (_i64, [
        _vp, _str, _i32, _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_double), _str, _i64, _str, _i64, _i64, _P(_i64)]),
    "iotml_kafka_last_event_time": (_i64, [_vp, _P(_i64)]),
    "iotml_kafka_commit": (_i64, [_vp, _str, _str, _i32, _i64]),
    "iotml_kafka_commit_many": (_i64, [
        _vp, _str, _str, _P(_i32), _P(_i64), _i64]),
    "iotml_kafka_committed": (_i64, [_vp, _str, _str, _i32]),
    # the MQTT ingest front (mqtt_ingest.cc)
    "iotml_mqtt_ingest_create": (_vp, [ctypes.c_uint16]),
    "iotml_mqtt_ingest_port": (ctypes.c_int, [_vp]),
    "iotml_mqtt_ingest_conns": (ctypes.c_long, [_vp]),
    "iotml_mqtt_ingest_poll": (ctypes.c_long, [_vp, ctypes.c_int]),
    "iotml_mqtt_ingest_drain": (ctypes.c_long, [
        _vp, _P(_P(_u8)), _P(_P(_i32)), _P(_P(_i32))]),
    "iotml_mqtt_ingest_clear": (None, [_vp]),
    "iotml_mqtt_ingest_close": (None, [_vp]),
    # the store-frame writer (frame_engine.cc)
    "iotml_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, _i64,
                                       ctypes.c_uint32]),
    "iotml_frames_encode_values": (_i64, [
        ctypes.c_char_p, _P(_i64), ctypes.c_char_p, _P(_i64), _P(_u8),
        _P(_u8), _P(_i64), _i64, _i64, _P(_u8), _i64]),
    "iotml_frames_encode_columnar": (_i64, [
        _P(ctypes.c_double), ctypes.c_char_p, _i64, _i64, _P(_i8), _P(_u8),
        _i64, _i64, _P(_u8), _P(_u8), _P(_i64), _i64, _P(_u8), _P(_i64),
        _i64, _P(_u8), _i64]),
    "iotml_frames_decode_columnar_ts": (_i64, [
        ctypes.c_char_p, _i64, _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_float), _vp, _i64, _vp, _i64, _i64, _P(_i64),
        _P(_i64), _P(_i64), _P(_i64), _P(_i64)]),
    "iotml_frames_decode_columnar": (_i64, [
        ctypes.c_char_p, _i64, _i64, _P(_i8), _P(_u8), _i64, _i64,
        _P(ctypes.c_float), _vp, _i64, _vp, _i64, _i64, _P(_i64),
        _P(_i64), _P(_i64)]),
    "iotml_frames_restamp": (_i64, [_vp, _i64, _i64, _P(_i64)]),
    "iotml_frames_validate": (_i64, [
        ctypes.c_char_p, _i64, _i64, _i64, _P(_i64), _P(_i64), _P(_i64), _P(_i64),
        _P(_i64), _P(_i64)]),
}

#: rows carried by the engine and seconds spent in it, per entry
stats = {"decode_rows": 0, "decode_s": 0.0, "encode_rows": 0,
         "encode_s": 0.0, "format_rows": 0, "format_s": 0.0,
         "msgset_encode_rows": 0, "msgset_encode_s": 0.0,
         "msgset_decode_rows": 0, "msgset_decode_s": 0.0,
         "fetch_decode_rows": 0, "fetch_decode_s": 0.0,
         "json_decode_rows": 0, "json_decode_s": 0.0,
         "frame_encode_rows": 0, "frame_encode_s": 0.0,
         "frame_decode_rows": 0, "frame_decode_s": 0.0,
         "frame_restamp_rows": 0, "frame_restamp_s": 0.0,
         "json_fallback_rows": 0, "decode_fallback_rows": 0,
         "encode_fallback_rows": 0, "rekey_fallback_rows": 0,
         "count_fallback_rows": 0}
_stats_lock = threading.Lock()

_lib: Optional[ctypes.CDLL] = None


def reset_stats() -> None:
    with _stats_lock:
        for k in stats:
            stats[k] = 0 if k.endswith("_rows") else 0.0


def count_fallback(kind: str, rows: int) -> None:
    """Add ``rows`` handed from the ``kind`` native leg to its Python
    leg to ``stats["<kind>_fallback_rows"]``."""
    with _stats_lock:
        stats[f"{kind}_fallback_rows"] += rows


def tally(kind: str, rows: int, t0: float) -> None:
    """Add one engine call of ``kind`` (rows carried, started at ``t0``
    on ``time.perf_counter``) to ``stats``."""
    seconds = time.perf_counter() - t0
    with _stats_lock:
        stats[f"{kind}_rows"] += rows
        stats[f"{kind}_s"] += seconds


@functools.lru_cache(maxsize=None)
def _target_machine() -> bytes:
    """What ``-march=native`` resolves to on this host, and the compiler
    version: a library built for another CPU must never be loaded."""
    out = b""
    for query in (["-dumpfullversion"], ["-march=native", "-Q",
                                         "--help=target"]):
        try:
            proc = subprocess.run(["g++", *query], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, timeout=60)
        except FileNotFoundError as e:
            raise RuntimeError(f"the native stream engine needs g++: {e}") \
                from None
        if proc.returncode != 0:
            raise RuntimeError(f"g++ {' '.join(query)} failed (exit "
                               f"{proc.returncode}):\n"
                               f"{proc.stdout.decode(errors='replace')}")
        out += proc.stdout
    return out


def library_path(src_dir: Path = CPP) -> Path:
    """Where the library of ``src_dir``'s sources goes: named by the hash
    of the sources, the header, the compiler flags and the target machine
    (``_target_machine``)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(_target_machine())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((src_dir / name).read_bytes())
    return src_dir / "build" / \
        f"libiotml_torch_stream-{digest.hexdigest()[:16]}.so"


def build(src_dir: Path = CPP) -> Path:
    """Compile the engine unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output on a failed build."""
    target = library_path(src_dir)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.tmp{os.getpid()}")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp),
             *(str(src_dir / s) for s in SOURCES)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(f"the native stream engine needs g++: {e}") \
            from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native stream engine build failed (g++ exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    return target


def load() -> ctypes.CDLL:
    """The engine library, built at first use; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def _offsets(messages: List[bytes]) -> np.ndarray:
    offsets = np.zeros((len(messages) + 1,), np.int64)
    np.cumsum([len(m) for m in messages], out=offsets[1:])
    return offsets


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(_P(ctype))


class NativeCodec:
    """Schema-compiled batch codec over the C++ engine."""

    def __init__(self, schema: RecordSchema):
        self.schema = schema
        self.types = np.array([_TYPE_CODE[f.avro_type]
                               for f in schema.fields], np.int8)
        self.nullable = np.array([1 if f.nullable else 0
                                  for f in schema.fields], np.uint8)
        self.n_fields = len(schema.fields)
        self.n_strings = int((self.types == _TYPE_CODE["string"]).sum())
        self.n_numeric = self.n_fields - self.n_strings
        # the JSON parser's column names: upper-case, in schema order
        names = [f.name.upper().encode() for f in schema.fields]
        self._json_names = b"".join(names)
        self._json_name_offsets = _offsets(names)
        self._lib = load()

    def _decode(self, entry: str, messages: List[bytes], strip: int,
                stride: int, nulls: bool):
        n = len(messages)
        if n == 0:
            out = (np.zeros((0, self.n_numeric)),
                   np.zeros((0, self.n_strings), f"S{stride}"))
            return out + ((np.zeros((0, self.n_fields), np.uint8),)
                          if nulls else ())
        t0 = time.perf_counter()
        blob = b"".join(messages)
        offsets = _offsets(messages)
        numeric = np.empty((n, self.n_numeric), np.float64)
        labels = np.zeros((n, max(self.n_strings, 1)), f"S{stride}")
        args = [blob, _ptr(offsets, _i64), n, _ptr(self.types, _i8),
                _ptr(self.nullable, _u8), self.n_fields, strip,
                _ptr(numeric, ctypes.c_double),
                labels.ctypes.data_as(ctypes.c_char_p), stride]
        if nulls:
            bitmap = np.zeros((n, self.n_fields), np.uint8)
            args.append(_ptr(bitmap, _u8))
        rc = getattr(self._lib, entry)(*args)
        if rc != n:
            raise ValueError(f"malformed Avro message at row {-rc - 1}")
        tally("decode", n, t0)
        out = (numeric, labels[:, : self.n_strings])
        return out + ((bitmap,) if nulls else ())

    def decode_batch(self, messages: List[bytes], strip: int = 0,
                     stride: int = LABEL_STRIDE, strict: bool = False
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (numeric [n, n_numeric] float64, labels [n, n_strings]).

        Numeric columns are the schema's non-string fields in order — for
        the car schemas that is exactly the 18-sensor matrix.  ``strip``
        bytes are skipped at each message head (5: the Confluent frame).
        Nulls decode as 0.0 and "".  A malformed message raises
        ValueError naming its row.  ``strict=True`` also rejects what the
        pure codec would reject (invalid UTF-8, a union branch outside
        {0, 1}) or would canonicalize on re-encode (trailing bytes,
        non-minimal varints): success guarantees that forwarding the
        original bytes equals decode → re-encode."""
        return self._decode("iotml_decode_batch_strict" if strict
                            else "iotml_decode_batch", messages, strip,
                            stride, nulls=False)

    def decode_batch_nulls(self, messages: List[bytes], strip: int = 0,
                           stride: int = LABEL_STRIDE):
        """``decode_batch`` plus the per-field null bitmap [n, n_fields]
        (uint8): the columns cannot tell a null union from 0.0 or ""."""
        return self._decode("iotml_decode_batch_nulls", messages, strip,
                            stride, nulls=True)

    def json_decode_batch(self, messages: List[bytes],
                          stride: int = LABEL_STRIDE):
        """Parse flat JSON objects into ``decode_batch``'s layout: →
        (numeric [n, n_numeric] float64, labels [n, n_strings], nulls
        [n, n_fields] uint8, fallback [n] uint8).

        Keys match column names case-insensitively (ASCII upper, as the
        Python leg's ``{k.upper(): v}``).  Missing columns and JSON nulls
        on nullable columns set the null bitmap.  Rows the parser cannot
        reproduce exactly (escapes, nested values, NaN/Infinity, hex,
        type mismatches, ints beyond 2^53, invalid UTF-8, control
        characters, null on a non-nullable column) are flagged in
        ``fallback`` with undefined contents: the caller re-decodes those
        with ``json.loads``."""
        n = len(messages)
        if n == 0:
            return (np.zeros((0, self.n_numeric)),
                    np.zeros((0, self.n_strings), f"S{stride}"),
                    np.zeros((0, self.n_fields), np.uint8),
                    np.zeros((0,), np.uint8))
        t0 = time.perf_counter()
        blob = b"".join(messages)
        offsets = _offsets(messages)
        numeric = np.empty((n, self.n_numeric), np.float64)
        labels = np.zeros((n, max(self.n_strings, 1)), f"S{stride}")
        nulls = np.zeros((n, self.n_fields), np.uint8)
        fallback = np.zeros((n,), np.uint8)
        rc = self._lib.iotml_json_decode_batch(
            blob, _ptr(offsets, _i64), n, self._json_names,
            _ptr(self._json_name_offsets, _i64), _ptr(self.types, _i8),
            _ptr(self.nullable, _u8), self.n_fields,
            _ptr(numeric, ctypes.c_double), self.n_numeric,
            labels.ctypes.data_as(ctypes.c_char_p), self.n_strings, stride,
            _ptr(nulls, _u8), _ptr(fallback, _u8))
        if rc < 0:
            raise ValueError("json batch decode rejected its arguments")
        tally("json_decode", n, t0)
        count_fallback("json", n - int(rc))
        return numeric, labels[:, : self.n_strings], nulls, fallback

    def encode_batch(self, numeric: np.ndarray, labels: Optional[np.ndarray],
                     schema_id: int = -1, stride: int = LABEL_STRIDE,
                     nulls: Optional[np.ndarray] = None) -> List[bytes]:
        """Columnar rows → list of Avro messages, with the Confluent frame
        of ``schema_id`` when it is >= 0.  ``labels`` is [n, n_strings]
        bytes (None: empty strings).  ``nulls`` ([n, n_fields] uint8)
        writes the null branch of the nullable union where set; a null on
        a non-nullable field raises ValueError."""
        t0 = time.perf_counter()
        numeric = np.ascontiguousarray(numeric, np.float64)
        n = numeric.shape[0]
        if numeric.ndim != 2 or numeric.shape[1] != self.n_numeric:
            raise ValueError(f"numeric must be [n, {self.n_numeric}], got "
                             f"{numeric.shape}")
        if labels is None:
            labels = np.zeros((n, self.n_strings), f"S{stride}")
        labels = np.ascontiguousarray(labels.astype(f"S{stride}"))
        if labels.shape != (n, self.n_strings):
            raise ValueError(f"labels must be [{n}, {self.n_strings}], got "
                             f"{labels.shape}")
        cap = n * (5 + self.n_fields * 20 + self.n_strings * stride) + 64
        out = np.empty((cap,), np.uint8)
        offsets = np.zeros((n + 1,), np.int64)
        args = [_ptr(numeric, ctypes.c_double),
                labels.ctypes.data_as(ctypes.c_char_p), stride, n,
                _ptr(self.types, _i8), _ptr(self.nullable, _u8),
                self.n_fields, schema_id, _ptr(out, _u8), cap,
                _ptr(offsets, _i64)]
        if nulls is not None:
            nulls = np.ascontiguousarray(nulls, np.uint8)
            if nulls.shape != (n, self.n_fields):
                raise ValueError(f"nulls must be [{n}, {self.n_fields}], "
                                 f"got {nulls.shape}")
            args.append(_ptr(nulls, _u8))
            total = self._lib.iotml_encode_batch_nulls(*args)
        else:
            total = self._lib.iotml_encode_batch(*args)
        if total < 0:
            raise ValueError("native encode rejected the rows (buffer "
                             "overflow or a null on a non-nullable field)")
        raw = out[:total].tobytes()
        msgs = [raw[offsets[i]:offsets[i + 1]] for i in range(n)]
        tally("encode", n, t0)
        return msgs

    def encode_frames(self, numeric: np.ndarray,
                      labels: Optional[np.ndarray],
                      timestamps: Optional[np.ndarray] = None,
                      keys=None, schema_id: int = 1,
                      nulls: Optional[np.ndarray] = None,
                      base_offset: int = 0,
                      stride: int = LABEL_STRIDE) -> bytes:
        """Columnar rows → ONE contiguous raw frame batch, in one engine
        call: Confluent-framed Avro values (``encode_batch``'s bytes)
        inside store frames stamped ``base_offset + i``, byte-identical
        to ``encode_batch`` + ``store.segment.encode_record``.  ``keys``:
        None (every key null), a list of key bytes (None entries are null
        keys), or an ``S``-dtype array passed as one fixed-stride block
        (no per-record object)."""
        t0 = time.perf_counter()
        numeric = np.ascontiguousarray(numeric, np.float64)
        n = numeric.shape[0]
        if labels is None:
            labels = np.zeros((n, self.n_strings), f"S{stride}")
        labels = np.ascontiguousarray(labels.astype(f"S{stride}"))
        ts = np.zeros((n,), np.int64) if timestamps is None else \
            np.ascontiguousarray(timestamps, np.int64)
        kargs = (None, None, 0, None)
        key_bytes = 0
        if isinstance(keys, np.ndarray):
            keys = np.ascontiguousarray(keys)
            kargs = (_ptr(keys.view(np.uint8), _u8), None,
                     keys.dtype.itemsize, None)
            key_bytes = keys.nbytes
        elif keys is not None:
            kblob, koff = _column(keys)
            knull = np.fromiter((k is None for k in keys), np.uint8, n)
            kargs = (ctypes.cast(ctypes.c_char_p(kblob), _P(_u8)),
                     _ptr(koff, _i64), 0, _ptr(knull, _u8))
            key_bytes = len(kblob)
        cap = n * (FRAME_OVERHEAD + 5 + self.n_fields * 20
                   + self.n_strings * stride) + key_bytes + 64
        out = np.empty((cap,), np.uint8)
        if nulls is not None:
            nulls = np.ascontiguousarray(nulls, np.uint8)
        rc = self._lib.iotml_frames_encode_columnar(
            _ptr(numeric, ctypes.c_double),
            labels.ctypes.data_as(ctypes.c_char_p), stride, n,
            _ptr(self.types, _i8), _ptr(self.nullable, _u8), self.n_fields,
            schema_id, None if nulls is None else _ptr(nulls, _u8), *kargs,
            _ptr(ts, _i64), int(base_offset), _ptr(out, _u8), cap)
        if rc < 0:
            raise ValueError("frame encode rejected the rows (overflow or "
                             "a null on a non-nullable field)")
        tally("frame_encode", n, t0)
        return out[:rc].tobytes()

    def frame_decoder(self, pinned_id_limit: Optional[int] = None
                      ) -> "FrameDecoder":
        """The columnar decoder of raw frame batches for this schema."""
        return FrameDecoder(self, pinned_id_limit=pinned_id_limit)


def _column(blobs) -> Tuple[bytes, np.ndarray]:
    """(joined bytes, offsets [n + 1]) of a list of bytes (None as b"")."""
    offsets = np.zeros((len(blobs) + 1,), np.int64)
    np.cumsum([len(b) if b else 0 for b in blobs], out=offsets[1:])
    return b"".join(b for b in blobs if b), offsets


def msgset_encode(entries) -> bytes:
    """[(offset, key, value, timestamp_ms)] → MessageSet v1 bytes in one
    engine call.  Null keys and null values (tombstones) are encoded as
    the wire's null BYTES."""
    t0 = time.perf_counter()
    n = len(entries)
    offs = np.fromiter((e[0] for e in entries), np.int64, n)
    ts = np.fromiter((e[3] for e in entries), np.int64, n)
    values, voff = _column([e[2] for e in entries])
    vnull = np.fromiter((e[2] is None for e in entries), np.uint8, n)
    if any(e[1] is not None for e in entries):
        keys, koff = _column([e[1] for e in entries])
        knull = np.fromiter((e[1] is None for e in entries), np.uint8, n)
        kargs = (keys, _ptr(koff, _i64), _ptr(knull, _u8))
    else:  # every key null: the engine takes NULL columns
        keys, kargs = b"", (None, None, None)
    # 34 bytes of framing an entry: offset, size, crc, magic, attributes,
    # timestamp and the two lengths
    cap = 34 * n + len(values) + len(keys)
    lib = load()
    while True:
        out = np.empty((max(cap, 1),), np.uint8)
        rc = lib.iotml_msgset_encode(
            values, _ptr(voff, _i64),
            _ptr(vnull, _u8) if vnull.any() else None, *kargs,
            _ptr(ts, _i64), _ptr(offs, _i64), n, _ptr(out, _u8), cap)
        if rc >= 0:
            break
        cap = -rc  # the ABI's "call again with this many bytes"
    tally("msgset_encode", n, t0)
    return out[:rc].tobytes()


def msgset_decode(buf: bytes) -> List[tuple]:
    """MessageSet v1 bytes → [(offset, key, value, timestamp_ms)] in one
    engine call; a truncated trailing entry is dropped.  A CRC mismatch
    or malformed framing raises ValueError (``kafka_wire`` turns it into
    the pure decoder's own error)."""
    t0 = time.perf_counter()
    size = len(buf)
    max_n = size // 26 + 1  # 26 bytes: no v1 entry is shorter
    offs = np.zeros((max_n,), np.int64)
    ts = np.zeros((max_n,), np.int64)
    koff = np.zeros((max_n + 1,), np.int64)
    knull = np.zeros((max_n,), np.uint8)
    voff = np.zeros((max_n + 1,), np.int64)
    vnull = np.zeros((max_n,), np.uint8)
    keys = np.empty((max(size, 1),), np.uint8)
    values = np.empty((max(size, 1),), np.uint8)
    rc = load().iotml_msgset_decode(
        buf, size, max_n, _ptr(offs, _i64), _ptr(ts, _i64), _ptr(koff, _i64),
        _ptr(knull, _u8), _ptr(keys, _u8), size, _ptr(voff, _i64),
        _ptr(vnull, _u8), _ptr(values, _u8), size)
    if rc < 0:
        raise ValueError(f"the message-set engine refused the buffer "
                         f"(code {rc})")
    kraw = keys[:koff[rc]].tobytes()
    vraw = values[:voff[rc]].tobytes()
    ko, vo = koff.tolist(), voff.tolist()
    kn, vn = knull[:rc].tolist(), vnull[:rc].tolist()
    out = [(o, None if kn[i] else kraw[ko[i]:ko[i + 1]],
            None if vn[i] else vraw[vo[i]:vo[i + 1]], t)
           for i, (o, t) in enumerate(zip(offs[:rc].tolist(),
                                          ts[:rc].tolist()))]
    tally("msgset_decode", rc, t0)
    return out


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing ``crc`` (0 starts a new
    checksum), in one engine call: ``google_crc32c.extend(crc, data)``."""
    if not isinstance(data, bytes):
        data = bytes(data)
    return load().iotml_crc32c(data, len(data), crc)


#: bytes of a store frame besides its key and value: the length prefix,
#: the head (crc, attrs, offset, timestamp, key length), the value length
FRAME_OVERHEAD = 4 + 25 + 4


def frames_encode_values(entries, base_offset: int = 0) -> bytes:
    """[(key, value, timestamp_ms)] → contiguous store frames stamped
    ``base_offset + i``, in one engine call.  A None key frames a null
    key, a None value a tombstone; byte-identical to
    ``store.segment.encode_record`` over the same records."""
    t0 = time.perf_counter()
    n = len(entries)
    values, voff = _column([e[1] for e in entries])
    vnull = np.fromiter((e[1] is None for e in entries), np.uint8, n)
    ts = np.fromiter((e[2] for e in entries), np.int64, n)
    if any(e[0] is not None for e in entries):
        keys, koff = _column([e[0] for e in entries])
        knull = np.fromiter((e[0] is None for e in entries), np.uint8, n)
        kargs = (keys, _ptr(koff, _i64), _ptr(knull, _u8))
    else:  # every key null: the engine takes NULL columns
        keys, kargs = b"", (None, None, None)
    cap = FRAME_OVERHEAD * n + len(values) + len(keys)
    out = np.empty((max(cap, 1),), np.uint8)
    rc = load().iotml_frames_encode_values(
        values, _ptr(voff, _i64), *kargs,
        _ptr(vnull, _u8) if vnull.any() else None, _ptr(ts, _i64), n,
        int(base_offset), _ptr(out, _u8), cap)
    if rc < 0:
        raise ValueError(f"the frame engine overflowed {cap} bytes framing "
                         f"{n} records")
    tally("frame_encode", n, t0)
    return out[:rc].tobytes()


def frames_restamp(buf, base_offset: int) -> Tuple[bytes, int, int]:
    """Validate a pre-framed batch whole and stamp ``base_offset + i``
    into its frame heads (CRCs recomputed), in one engine call.  Returns
    (stamped bytes, frames, newest timestamp), or (b"", -(i + 1), -1)
    when frame i is torn or corrupt (nothing stamped is returned)."""
    t0 = time.perf_counter()
    mutable = ctypes.create_string_buffer(bytes(buf), len(buf))
    max_ts = ctypes.c_int64(-1)
    rc = load().iotml_frames_restamp(mutable, len(buf), int(base_offset),
                                     ctypes.byref(max_ts))
    if rc < 0:
        return b"", int(rc), -1
    tally("frame_restamp", rc, t0)
    return mutable.raw[:len(buf)], int(rc), int(max_ts.value)


def frames_validate(buf: bytes, start_offset: int, strict: bool
                    ) -> Tuple[int, Tuple[int, ...]]:
    """CRC and offset-monotonicity walk of a raw frame batch in one
    engine call: (count or -(i + 1) at a failing frame i, (first, last,
    start_pos, end_pos, max_ts, contiguous))."""
    outs = [ctypes.c_int64(0) for _ in range(6)]
    rc = load().iotml_frames_validate(
        buf, len(buf), int(start_offset), 1 if strict else 0,
        *[ctypes.byref(o) for o in outs])
    return int(rc), tuple(int(o.value) for o in outs)


#: flag bits reported by the frame decoder (frame_engine.cc FrameFlags)
FRAMES_STOP_TORN = 1     # a torn or corrupt frame parked the scan
FRAMES_STOP_SCHEMA = 2   # a writer id outside the pinned band


class FrameDecoder:
    """Columnar decoder of raw store-frame batches (frame_engine.cc).

    The one decode entry of the columnar ring: live consume
    (``StreamConsumer.poll_into``) and timestamp-replay backfill both
    decode here, over the frames a durable segment holds and the wire's
    RAW_FETCH ships, into CALLER-OWNED float32 / label / key buffers
    (``data.pipeline.DecodeRing`` slots): no per-record Python object.

    ``pinned_id_limit`` is the exclusive upper bound of the Confluent
    writer ids that decode positionally (default
    ``core.schema.RESERVED_ID_BASE``, where the evolved writer schemas
    live): an evolved writer's frame, or a value that is not Confluent
    framed, stops the scan with ``FRAMES_STOP_SCHEMA``, and the caller
    resolves that chunk by name instead of mis-reading it.
    ``last_ts_min`` / ``last_ts_max`` are the event-time bounds (ms) of
    the frames the last ``decode_into`` consumed, decoded rows and
    skipped tombstones alike, -1 when it consumed none.
    """

    def __init__(self, codec: NativeCodec,
                 pinned_id_limit: Optional[int] = None):
        from ..core.schema import RESERVED_ID_BASE

        self.codec = codec
        self.pinned_id_limit = RESERVED_ID_BASE \
            if pinned_id_limit is None else int(pinned_id_limit)
        self._lib = codec._lib
        self.last_ts_min = -1
        self.last_ts_max = -1

    @property
    def n_numeric(self) -> int:
        return self.codec.n_numeric

    @property
    def n_strings(self) -> int:
        return self.codec.n_strings

    def decode_into(self, buf, start_offset: int, out_numeric: np.ndarray,
                    out_labels: np.ndarray,
                    out_keys: Optional[np.ndarray] = None,
                    cap_rows: Optional[int] = None
                    ) -> Tuple[int, int, int, int]:
        """Decode raw frame bytes into the caller's column buffers.

        ``buf``: contiguous frames (a segment range, a RAW_FETCH payload,
        the in-memory broker's re-framed slice); it may start below
        ``start_offset`` (skipped) and end mid-frame (the batch ends
        there).  ``out_numeric`` [cap, n_numeric] float32,
        ``out_labels`` [cap, n_strings] S-stride and ``out_keys`` [cap]
        S-stride (keys cut at stride - 1 bytes, as the fused leg cuts
        them), each C-contiguous.  Returns (rows, next_offset, flags,
        skipped_tombstones)."""
        codec = self.codec
        cap = out_numeric.shape[0] if cap_rows is None \
            else min(int(cap_rows), out_numeric.shape[0])
        if out_labels.shape[0] < cap or \
                (out_keys is not None and out_keys.shape[0] < cap):
            raise ValueError("label/key buffers shorter than cap_rows")
        if isinstance(buf, (bytearray, memoryview)):
            buf = bytes(buf)  # the hot paths hand bytes: passed by pointer
        t0 = time.perf_counter()
        next_off = ctypes.c_int64(start_offset)
        flags = ctypes.c_int64(0)
        skipped = ctypes.c_int64(0)
        ts_min = ctypes.c_int64(-1)
        ts_max = ctypes.c_int64(-1)
        rows = self._lib.iotml_frames_decode_columnar_ts(
            buf, len(buf), int(start_offset), _ptr(codec.types, _i8),
            _ptr(codec.nullable, _u8), codec.n_fields,
            self.pinned_id_limit, _ptr(out_numeric, ctypes.c_float),
            out_labels.ctypes.data, out_labels.dtype.itemsize,
            out_keys.ctypes.data if out_keys is not None else None,
            out_keys.dtype.itemsize if out_keys is not None else 0,
            cap, ctypes.byref(next_off), ctypes.byref(flags),
            ctypes.byref(skipped), ctypes.byref(ts_min),
            ctypes.byref(ts_max))
        if rows < 0:
            raise ValueError("frame decoder rejected its arguments")
        tally("frame_decode", rows, t0)
        self.last_ts_min = int(ts_min.value)
        self.last_ts_max = int(ts_max.value)
        return int(rows), int(next_off.value), int(flags.value), \
            int(skipped.value)
