"""Row stream → fixed-shape batches (``iotml.data.dataset``'s batching).

The reference pipeline is consume → decode → normalize →
filter(label == "false") → batch(100) → take(100).  This module keeps
its batching semantics exactly — normalization host-side in float64,
filtering before batching, a zero-padded tail with a validity count,
skip/take counted in post-filter batches, ``first_index`` for ordered
write-back — over either of two sources:

- a ``StreamConsumer`` or a ``GroupConsumer`` on a broker topic of
  Confluent-framed Avro: each poll is stripped of its 5-byte frames and
  decoded in one call of the native engine
  (``stream.native.NativeCodec``), the JAX package's message-list leg; a
  poll that holds any frame of an evolved writer schema is decoded by
  name through ``ops.avro.ResolvingCodec`` instead, since the
  positional decode would misread it.  Over a broker with a fused
  ``fetch_decode`` (the native client, ``stream.native_kafka``) a
  ``StreamConsumer`` polls through ``poll_decoded`` instead: fetch,
  strip and decode in one native call a partition.  At an evolved
  writer's frame it takes exactly one chunk through the message-list
  leg, then resumes;
- an in-memory ``RowSource`` of already-decoded sensor rows.

``keep_keys`` puts each record's message key (the car id) on
``Batch.keys``, cut at ``native.KEY_STRIDE - 1`` bytes on either leg.
``window=T`` emits [B, T, F] sliding windows with next-step targets (the
LSTM path).  The columnar frame-decoder ring and the canary filter are
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..core.normalize import CAR_NORMALIZER, Normalizer
from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA, RecordSchema
from ..ops.avro import ResolvingCodec, needs_resolution
from ..stream.broker import SchemaIdMismatchError
from ..stream.consumer import StreamConsumer
from ..stream.group import GroupConsumer
from ..stream.native import KEY_STRIDE, NativeCodec

#: most messages one consumer poll fetches (the JAX ``poll_chunk`` default)
POLL_CHUNK = 4096


@dataclasses.dataclass
class Batch:
    """One fixed-shape batch. x is [B, F] float32; rows >= n_valid are padding.

    `first_index` is the global record index of row 0 within this stream view
    (after filtering/skip) — the index OutputSequence keys write-back on.
    """

    x: np.ndarray
    n_valid: int
    first_index: int
    labels: Optional[np.ndarray] = None  # object array of strings, if kept
    y: Optional[np.ndarray] = None  # supervised target (windowed path)
    keys: Optional[np.ndarray] = None  # [B] S-bytes message keys, if kept

    @property
    def mask(self) -> np.ndarray:
        m = np.zeros((self.x.shape[0],), np.float32)
        m[: self.n_valid] = 1.0
        return m


class RowSource:
    """Append-only in-memory log of raw sensor rows and their labels.

    Rows are [n, num_sensors] float64 in schema order (what
    ``FleetGenerator.sensor_matrix`` returns); labels are the
    ``failure_occurred`` strings.  Readers keep their own cursor.
    """

    num_sensors = CAR_SCHEMA.num_sensors

    def __init__(self):
        self._chunks: list = []
        self._label_chunks: list = []
        self._rows = np.zeros((0, self.num_sensors), np.float64)
        self._labels = np.zeros((0,), "<U5")

    @classmethod
    def from_fleet(cls, gen, n_ticks: int) -> "RowSource":
        """``n_ticks`` ticks of a ``FleetGenerator``, every car each tick."""
        src = cls()
        for _ in range(n_ticks):
            cols = gen.step_columns()
            src.append(gen.sensor_matrix(cols), cols["failure_occurred"])
        return src

    def append(self, rows: np.ndarray, labels: np.ndarray) -> None:
        rows = np.asarray(rows, np.float64)
        if rows.ndim != 2 or rows.shape[1] != self.num_sensors \
                or len(labels) != len(rows):
            raise ValueError(f"rows must be [n, {self.num_sensors}] with "
                             f"one label each, got {rows.shape} and "
                             f"{len(labels)} labels")
        self._chunks.append(rows)
        self._label_chunks.append(np.asarray(labels))

    def __len__(self) -> int:
        return len(self._rows) + sum(len(c) for c in self._chunks)

    def read(self, start: int, max_rows: int):
        """Rows [start, start + max_rows) and their labels (fewer at the
        end of the log, none past it)."""
        if self._chunks:
            self._rows = np.concatenate([self._rows] + self._chunks)
            self._labels = np.concatenate([self._labels]
                                          + self._label_chunks)
            self._chunks, self._label_chunks = [], []
        end = start + max_rows
        return self._rows[start:end], self._labels[start:end]


class SensorBatches:
    """Iterable of fixed-shape sensor batches off a ``StreamConsumer`` or a
    ``RowSource``.

    Args mirror the reference pipeline:
      batch_size: rows per batch (reference: 100).
      take: max batches per epoch (reference: 100), None = to the end.
      skip: batches to skip first (reference predict path: skip(100)).
      only_normal: keep rows with label "false" only (the training
        filter); False keeps everything (the predict path).
      pad_tail: zero-pad the final ragged batch (True) or drop it.
      keep_labels: carry each row's label on ``Batch.labels``.
      keep_keys: carry each row's message key on ``Batch.keys`` (a
        consumer's stream only).
      window: if set, emit [B, window, F] sliding windows with next-step
        targets y [B, 1, F] (the LSTM path: window(look_back, shift=1)
        zipped with skip(look_back), reference LSTM cardata-v1.py:184-190);
        skip and take then count batches of windows.
      cache: decode once and replay batches from host memory on later
        epochs (identical over an immutable slice).
      schema: the Avro record schema of a consumer's messages.

    The cursor persists across ``iter()`` calls, like a consumer's: a
    scorer re-entering the iterator continues where it stopped, and
    ``reset()`` (called between ``epochs``) rewinds to the start.
    """

    def __init__(self, source,
                 normalizer: Normalizer = CAR_NORMALIZER,
                 batch_size: int = 100,
                 take: Optional[int] = None,
                 skip: int = 0,
                 only_normal: bool = False,
                 window: Optional[int] = None,
                 pad_tail: bool = True,
                 keep_labels: bool = False,
                 keep_keys: bool = False,
                 cache: bool = False,
                 schema: RecordSchema = KSQL_CAR_SCHEMA):
        self.normalizer = normalizer
        self.batch_size = batch_size
        self.take = take
        self.skip = skip
        self.only_normal = only_normal
        self.window = window
        self.pad_tail = pad_tail
        self.keep_labels = keep_labels
        self.keep_keys = keep_keys
        self.cache = cache
        self._cached = None
        self.consumer = None  # a StreamConsumer or a GroupConsumer
        self.source: Optional[RowSource] = None
        if isinstance(source, (StreamConsumer, GroupConsumer)):
            self.consumer = source
            self.schema = schema
            self._native = NativeCodec(schema)
            self._resolving: Optional[ResolvingCodec] = None
            # the label's column among the schema's string fields
            strings = [f.name for f in schema.fields
                       if f.avro_type == "string"]
            self._label_col = strings.index(schema.label_field) \
                if schema.label_field in strings else None
        elif isinstance(source, RowSource):
            if keep_keys:
                raise ValueError("keep_keys needs a consumer: a RowSource's "
                                 "rows have no message keys")
            self.source = source
        else:
            raise TypeError(f"SensorBatches reads a StreamConsumer, a "
                            f"GroupConsumer or a RowSource, not "
                            f"{type(source).__name__}")
        self.position = 0  # the read cursor into a RowSource
        # skip applies once to the stream head, not once per drain
        self._skipped = 0
        # rows still wanted by the current bounded iteration (None =
        # unbounded): reading past what `take` will batch would move the
        # cursor over rows the caller never sees
        self._need_rows: Optional[int] = None

    def _native_labels(self, lab: np.ndarray, n: int) -> np.ndarray:
        """The label column of the native decoder's fixed-stride bytes."""
        return lab[:, self._label_col].astype("U") \
            if self._label_col is not None \
            else np.full((n,), "", object)

    def _decode_msgs(self, msgs):
        """(float64 sensor rows, labels, keys or None) of one poll: frames
        stripped and Avro decoded in one native call, or, where any frame
        names an evolved writer schema, the whole poll decoded by name.
        Keys are cut at ``KEY_STRIDE - 1`` bytes, as the fused leg cuts
        them."""
        values = [m.value for m in msgs]
        keys = np.asarray([m.key or b"" for m in msgs],
                          f"S{KEY_STRIDE - 1}").astype(f"S{KEY_STRIDE}") \
            if self.keep_keys else None
        if any(needs_resolution(v) for v in values):
            if self._resolving is None:
                self._resolving = ResolvingCodec(self.schema)
            cols = self._resolving.decode_batch_framed(values)
            label = self.schema.label_field
            labels = cols[label].astype("U") if label \
                else np.full((len(msgs),), "", object)
            return self._resolving.codec.sensor_matrix(cols), labels, keys
        num, lab = self._native.decode_batch(values, strip=5)
        return num, self._native_labels(lab, len(msgs)), keys

    def _fused(self) -> bool:
        """Whether the consumer polls through the broker's fused
        fetch-and-decode."""
        attr = "fetch_decode_keys" if self.keep_keys else "fetch_decode"
        return isinstance(self.consumer, StreamConsumer) and \
            getattr(self.consumer.broker, attr, None) is not None

    def _decoded_chunks(self):
        """Yield (float64 sensor rows, labels, keys or None) per read: the
        rows a bounded iteration still needs, else the rest of the
        stream."""
        fused = self._fused()
        while True:
            if self.consumer is not None:
                limit = POLL_CHUNK if self._need_rows is None \
                    else max(1, min(POLL_CHUNK, self._need_rows))
                if fused:
                    try:
                        res = self.consumer.poll_decoded(
                            self._native, strip=5, max_messages=limit,
                            with_keys=self.keep_keys)
                    except SchemaIdMismatchError:
                        # an evolved writer's frame at the cursor: one
                        # chunk by the message-list leg, then fused again
                        msgs = self.consumer.poll(limit)
                        if msgs:
                            yield self._decode_msgs(msgs)
                        continue
                    if not len(res[0]):
                        return
                    yield (res[0], self._native_labels(res[1], len(res[0])),
                           res[2] if self.keep_keys else None)
                    continue
                msgs = self.consumer.poll(limit)
                if not msgs:
                    return
                yield self._decode_msgs(msgs)
                continue
            limit = len(self.source) - self.position \
                if self._need_rows is None else self._need_rows
            num, labels = self.source.read(self.position, limit)
            if not len(num):
                return
            self.position += len(num)
            yield num, labels, None

    def _filtered_chunks(self):
        """Yield (xs [n, F] float32 normalized, labels [n], keys [n] or
        None) per read."""
        for num, labels, keys in self._decoded_chunks():
            xs = self.normalizer.np(num)
            if self.only_normal:
                keep = labels == "false"
                xs, labels = xs[keep], labels[keep]
                if keys is not None:
                    keys = keys[keep]
            if len(xs):
                yield xs, labels, keys

    def __iter__(self) -> Iterator[Batch]:
        if self.window:
            yield from self._windowed_iter()
            return
        B = self.batch_size
        parts: list = []  # pending (xs, labels, keys) chunks
        have = 0
        emitted = 0
        # index counts post-skip rows only, like the reference's
        # OutputCallback `index = batch * batch_size`
        index = 0

        def assemble():
            nonlocal parts, have
            if len(parts) > 1:
                xs = np.concatenate([p[0] for p in parts])
                labels = np.concatenate([p[1] for p in parts])
                keys = np.concatenate([p[2] for p in parts]) \
                    if self.keep_keys else None
            else:
                xs, labels, keys = parts[0]
            parts = []
            have = 0
            return xs, labels, keys

        def emit(xs, labels, keys, lo):
            n_valid = min(B, len(xs) - lo)
            x = xs[lo:lo + n_valid].astype(np.float32, copy=True)
            if n_valid < B:
                x = np.concatenate([x, np.zeros((B - n_valid, x.shape[1]),
                                                np.float32)])
            lab = None
            if self.keep_labels:
                lab = np.empty((B,), object)
                lab[:n_valid] = labels[lo:lo + n_valid]
                lab[n_valid:] = ""
            ks = None
            if keys is not None:
                ks = np.zeros((B,), keys.dtype)
                ks[:n_valid] = keys[lo:lo + n_valid]
            # first_index set by the caller
            return Batch(x, n_valid, 0, lab, keys=ks)

        chunks = self._filtered_chunks()
        try:
            while True:
                if self.take:
                    needed = (self.take - emitted
                              + max(self.skip - self._skipped, 0))
                    self._need_rows = needed * B - have
                try:
                    chunk = next(chunks)
                except StopIteration:
                    break
                parts.append(chunk)
                have += len(chunk[0])
                if have < B:
                    continue
                xs, labels, keys = assemble()
                lo = 0
                while len(xs) - lo >= B:
                    if self._skipped < self.skip:
                        self._skipped += 1
                    else:
                        b = emit(xs, labels, keys, lo)
                        b.first_index = index
                        yield b
                        emitted += 1
                        index += B
                        if self.take and emitted >= self.take:
                            return
                    lo += B
                if lo < len(xs):
                    parts = [(xs[lo:], labels[lo:],
                              keys[lo:] if keys is not None else None)]
                    have = len(xs) - lo
            if have and self.pad_tail and self._skipped >= self.skip and \
                    (not self.take or emitted < self.take):
                xs, labels, keys = assemble()
                b = emit(xs, labels, keys, 0)
                b.first_index = index
                yield b
        finally:
            self._need_rows = None

    def _windowed_iter(self) -> Iterator[Batch]:
        """Sliding windows x=[B,T,F] with next-step targets y=[B,1,F]: the
        window starting at row i is paired with row i+T.  Windows come
        from a strided view of each chunk, transposed to [n, T, F] in one
        copy; the last T rows carry across chunk joints."""
        T = self.window
        B = self.batch_size
        carry = None          # last T rows: windows spanning chunk joints
        pend_x: list = []     # [n, T, F] window chunks awaiting batching
        pend_y: list = []     # [n, 1, F]
        have = 0
        emitted = 0
        index = 0

        def emit(wx, wy, lo):
            n_valid = min(B, len(wx) - lo)
            x = np.zeros((B, T, wx.shape[2]), np.float32)
            y = np.zeros((B, 1, wx.shape[2]), np.float32)
            x[:n_valid] = wx[lo:lo + n_valid]
            y[:n_valid] = wy[lo:lo + n_valid]
            return Batch(x, n_valid, 0, y=y)

        chunks = self._filtered_chunks()
        try:
            while True:
                if self.take:
                    needed = (self.take - emitted
                              + max(self.skip - self._skipped, 0))
                    # rows already carried count toward the T rows of
                    # lookahead a window needs
                    covered = 0 if carry is None else len(carry)
                    self._need_rows = needed * B - have + max(T - covered,
                                                              0)
                try:
                    xs, _labels, _keys = next(chunks)
                except StopIteration:
                    break
                buf = xs.astype(np.float32, copy=False)
                if carry is not None and len(carry):
                    buf = np.concatenate([carry, buf])
                n_w = len(buf) - T  # windows with a next-step target
                if n_w <= 0:
                    carry = buf
                    continue
                wins = np.ascontiguousarray(
                    sliding_window_view(buf, T, axis=0)[:n_w]
                    .transpose(0, 2, 1))
                ys = buf[T: T + n_w][:, None, :]
                carry = buf[n_w:]
                pend_x.append(wins)
                pend_y.append(ys)
                have += n_w
                if have < B:
                    continue
                wx = np.concatenate(pend_x) if len(pend_x) > 1 else pend_x[0]
                wy = np.concatenate(pend_y) if len(pend_y) > 1 else pend_y[0]
                pend_x, pend_y = [], []
                have = 0
                lo = 0
                while len(wx) - lo >= B:
                    if self._skipped < self.skip:
                        self._skipped += 1
                    else:
                        b = emit(wx, wy, lo)
                        b.first_index = index
                        yield b
                        emitted += 1
                        index += B
                        if self.take and emitted >= self.take:
                            return
                    lo += B
                if lo < len(wx):
                    pend_x, pend_y = [wx[lo:]], [wy[lo:]]
                    have = len(wx) - lo
            if have and self.pad_tail and self._skipped >= self.skip and \
                    (not self.take or emitted < self.take):
                wx = np.concatenate(pend_x) if len(pend_x) > 1 else pend_x[0]
                wy = np.concatenate(pend_y) if len(pend_y) > 1 else pend_y[0]
                b = emit(wx, wy, 0)
                b.first_index = index
                yield b
        finally:
            self._need_rows = None

    def reset(self):
        """Rewind for the next epoch (the reference re-reads the topic)."""
        if self.consumer is not None:
            self.consumer.seek_to_start()
        self.position = 0
        self._skipped = 0

    def epochs(self, n: int):
        """Yield epoch iterators with automatic rewind between them."""
        for e in range(n):
            if self.cache:
                if self._cached is None:
                    self._cached = list(iter(self))
                yield iter(self._cached)
                continue
            if e:
                self.reset()
            yield iter(self)
