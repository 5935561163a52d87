"""Confluent Schema-Registry wire framing and the store's frame batches
(``iotml.ops.framing``).

Records on the Kafka topic the ML layer consumes are not bare Avro: the
Schema Registry serializer prepends a 5-byte header — magic byte ``0``
plus a big-endian uint32 schema id.  The reference strips it in-graph
with ``tf.strings.substr(e, 5, -1)`` (cardata-v3.py:50).  The format is
kept byte-compatible so the port's stream interoperates with real
Confluent payloads.

A frame batch is contiguous segmented-log frames (``store.segment``'s
layout): what a durable segment holds, what ``Broker.fetch_raw`` and the
wire's RAW_FETCH hand back as a ``RawFrameBatch``, and what RAW_PRODUCE
ships.  The native engine (``cpp/frame_engine.cc``) does the batch work:
``frame_entries`` frames a produce batch in one call (the durable
broker's fused ``produce_many``, the MQTT bridge's raw leg),
``restamp_frame_batch`` validates a pre-framed batch whole and stamps
its log offsets (the RAW_PRODUCE landing), ``validate_frame_batch``
walks one, and ``stream.native.FrameDecoder`` decodes one into columns.
A failed engine build raises, nothing falls back: the ``*_py`` functions
here are the plain versions, run only when called by name, as
``decode_frames_columnar_py`` is the plain version of the decoder.
Entries with headers (traced records) take the per-record codec
(``encode_frame_batch``), their only encoder, as in the JAX package;
``stamp_first_frame`` / ``first_frame_headers`` carry a batch's trace
context on its first frame, and ``truncate_frame_batch`` cuts a batch at
the quorum read barrier of a replicated leader.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional, Tuple

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


class RawFrameBatch(NamedTuple):
    """A batch of records as contiguous store frames: one buffer and the
    cursor it was read at, no per-record Python objects.  ``data`` may
    begin with frames below ``start_offset`` (sparse-index alignment: the
    decoder skips them) and may end mid-frame (a torn tail ends the
    batch, as in crash recovery)."""

    topic: str
    partition: int
    start_offset: int   # the requested cursor; frames below are skipped
    data: bytes         # store frames (store.segment's layout)


#: stop-flag bits shared with the native decoder (frame_engine.cc)
FRAMES_STOP_TORN = 1
FRAMES_STOP_SCHEMA = 2


def stamp_first_frame(buf: bytes, headers) -> bytes:
    """Attach ``headers`` ([(key, value)]) to the FIRST frame of a raw
    batch, re-framing that one record only: a sampled batch's trace
    carrier, which survives RAW_PRODUCE, the segment and RAW_FETCH as it
    is.  Returns ``buf`` unchanged when it holds no complete frame."""
    from ..store import segment as seg

    for pos, end, off, key, value, ts, hdrs in seg.scan_records(buf):
        merged = tuple(hdrs or ()) + tuple(headers)
        return (buf[:pos] + seg.encode_record(off, key, value, ts, merged)
                + buf[end:])
    return buf


def first_frame_headers(buf, at_or_after: Optional[int] = None
                        ) -> Optional[tuple]:
    """Headers of the first complete frame of a raw batch (None when it
    has none): one frame parsed, never the batch.  ``at_or_after``
    answers None when the first frame's offset is below it, since a raw
    read may serve the batch head below the requested cursor again and
    each later slice of one stamped batch would re-extract its trace."""
    from ..store import segment as seg

    for _pos, _end, off, _k, _v, _ts, hdrs in seg.scan_records(buf):
        if at_or_after is not None and off < at_or_after:
            return None
        return hdrs
    return None


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


def restamp_frame_batch(buf: bytes, base_offset: int
                        ) -> Tuple[bytes, int, int]:
    """CRC-validate a pre-framed batch WHOLE and stamp the log offsets
    ``base_offset + i`` into its frame heads, recomputing each CRC, in
    one engine call: the broker's RAW_PRODUCE landing.  Returns
    ``(stamped_bytes, count, max_ts)``; any torn or corrupt frame or
    trailing garbage raises ``CorruptFrameError`` (nothing may land)."""
    from ..stream import native

    stamped, count, max_ts = native.frames_restamp(buf, base_offset)
    if count < 0:
        raise CorruptFrameError(-count - 1, "CRC/length mismatch")
    return stamped, count, max_ts


def restamp_frame_batch_py(buf: bytes, base_offset: int
                           ) -> Tuple[bytes, int, int]:
    """The plain version of ``restamp_frame_batch``: a strict scan
    through the store's one parser, then a per-record re-encode with the
    stamped offsets (byte-identical to the engine's in-place patch)."""
    from ..store import segment as seg

    out = []
    consumed = 0
    max_ts = -1
    for _pos, end, _off, key, value, ts, hdrs in seg.scan_records(buf):
        out.append(seg.encode_record(base_offset + len(out), key, value,
                                     ts, hdrs))
        max_ts = max(max_ts, ts)
        consumed = end
    if consumed != len(buf):
        raise CorruptFrameError(len(out), "torn/corrupt tail")
    return b"".join(out), len(out), max_ts


def validate_frame_batch(buf: bytes, start_offset: int = 0,
                         strict: bool = False) -> dict:
    """CRC and offset-monotonicity walk over a raw frame batch in one
    engine call.  Frames below ``start_offset`` are the sparse-index
    alignment (skipped); a torn TAIL ends the batch (``strict=False``) or
    rejects it (``strict=True``).  Returns ``count / first / last /
    max_ts / start_pos / end_pos / contiguous``, where [start_pos,
    end_pos) holds the in-range frames.  A strict violation or a
    non-monotone offset raises ``CorruptFrameError``."""
    from ..stream import native

    rc, (first, last, start_pos, end_pos, max_ts, contiguous) = \
        native.frames_validate(bytes(buf), start_offset, strict)
    if rc < 0:
        raise CorruptFrameError(-rc - 1, "validation failed")
    return dict(count=rc, first=first, last=last, max_ts=max_ts,
                start_pos=start_pos, end_pos=end_pos,
                contiguous=bool(contiguous))


def validate_frame_batch_py(buf: bytes, start_offset: int = 0,
                            strict: bool = False) -> dict:
    """The plain version of ``validate_frame_batch``, through the store's
    one parser."""
    from ..store import segment as seg

    count = 0
    first = last = -1
    start_pos = end_pos = 0
    max_ts = prev = -1
    consumed = 0
    for pos, end, off, _k, _v, ts, _h in seg.scan_records(buf):
        if off <= prev:
            raise CorruptFrameError(count, "non-monotone offset")
        prev = off
        consumed = end
        if off < start_offset:
            continue
        if first < 0:
            first = off
            start_pos = pos
        last = off
        end_pos = end
        max_ts = max(max_ts, ts)
        count += 1
    if strict and consumed != len(buf):
        raise CorruptFrameError(count, "torn/corrupt tail")
    return dict(count=count, first=first, last=last, max_ts=max_ts,
                start_pos=start_pos, end_pos=end_pos,
                contiguous=count == 0 or last - first + 1 == count)


def truncate_frame_batch(buf: bytes, max_offset_exclusive: int) -> bytes:
    """The prefix of a frame batch whose record offsets all lie below
    ``max_offset_exclusive``: the quorum read barrier's cut (a consumer's
    raw fetch must not ship frames past the quorum high-water mark).  It
    cuts at a frame boundary; a torn or corrupt frame ends the walk, as
    it ends every reader of the format."""
    from ..store import segment

    end_pos = 0
    try:
        for _pos, end, off, _k, _v, _ts, _h in segment.scan_records(buf):
            if off >= max_offset_exclusive:
                break
            end_pos = end
    except ValueError:
        pass  # a corrupt frame: keep the clean prefix below the ceiling
    return buf[:end_pos]


def decode_frames_columnar_py(
        buf: bytes, start_offset: int, schema,
        pinned_id_limit: Optional[int] = None,
        cap_rows: int = 1 << 62, label_stride: int = 16,
        key_stride: int = 64, with_keys: bool = False,
        want_ts: bool = False):
    """The plain version of the native columnar decoder
    (``stream.native.FrameDecoder``): walks the frames of ``buf`` through
    ``store.segment.scan_records``, applies the same stop conditions
    (torn or corrupt frame, a writer id outside the pinned band, the
    cap) and fills float32 numeric, fixed-stride label and key columns.
    Returns ``(numeric [n, F] float32, labels [n, S], keys or None,
    next_offset, flags, skipped_tombstones)``, with ``(ts_min, ts_max)``
    appended under ``want_ts``: the event-time bounds (ms) of the frames
    consumed, tombstones included, -1 when none was."""
    import numpy as np

    from ..core.schema import RESERVED_ID_BASE
    from ..ops.avro import AvroCodec
    from ..store import segment as seg

    if pinned_id_limit is None:
        pinned_id_limit = RESERVED_ID_BASE
    codec = AvroCodec(schema)
    strings = [f.name for f in schema.fields if f.avro_type == "string"]
    numerics = [f.name for f in schema.fields if f.avro_type != "string"]
    rows_num: List[list] = []
    rows_lab: List[list] = []
    rows_key: List[bytes] = []
    flags = skipped = 0
    next_offset = start_offset
    consumed = 0
    stopped = False
    ts_min = ts_max = -1

    def fold_ts(ts):
        nonlocal ts_min, ts_max
        if ts_min < 0 or ts < ts_min:
            ts_min = ts
        ts_max = max(ts_max, ts)

    for _pos, end, off, key, value, ts, _hdrs in seg.scan_records(buf):
        if len(rows_num) >= cap_rows:
            stopped = True
            break
        if off < start_offset:
            consumed = end  # sparse-index alignment: skipped, consumed
            continue
        if value is None:
            # a tombstone: consumed and counted, and its time folds in
            skipped += 1
            next_offset = off + 1
            consumed = end
            fold_ts(ts)
            continue
        payload = value
        if pinned_id_limit >= 0:
            if len(value) < 5 or value[0] != MAGIC or \
                    int.from_bytes(value[1:5], "big") >= pinned_id_limit:
                flags |= FRAMES_STOP_SCHEMA
                stopped = True
                break
            payload = value[5:]
        try:
            rec = codec.decode(payload)
        except Exception:  # noqa: BLE001 - any malformed Avro ends the scan
            flags |= FRAMES_STOP_TORN
            stopped = True
            break
        rows_num.append([np.float32(0.0 if rec[n] is None else rec[n])
                         for n in numerics])
        rows_lab.append(["" if rec[n] is None else rec[n] for n in strings])
        if with_keys:
            rows_key.append((key or b"")[:key_stride - 1])
        next_offset = off + 1
        consumed = end
        fold_ts(ts)
    if not stopped and consumed < len(buf):
        flags |= FRAMES_STOP_TORN  # the scan parked on a torn frame
    n = len(rows_num)
    numeric = np.zeros((n, len(numerics)), np.float32)
    labels = np.zeros((n, len(strings)), f"S{label_stride}")
    for i in range(n):
        numeric[i] = rows_num[i]
        labels[i] = [s.encode()[:label_stride - 1] for s in rows_lab[i]]
    keys = None
    if with_keys:
        keys = np.asarray(rows_key, f"S{key_stride}") if rows_key \
            else np.zeros((0,), f"S{key_stride}")
    out = (numeric, labels, keys, next_offset, flags, skipped)
    return out + (ts_min, ts_max) if want_ts else out
