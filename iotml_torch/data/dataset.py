"""Row stream → fixed-shape batches (``iotml.data.dataset``'s batching).

The reference pipeline is consume → decode → normalize →
filter(label == "false") → batch(100) → take(100).  This module keeps
its batching semantics exactly — normalization host-side in float64,
filtering before batching, a zero-padded tail with a validity count,
skip/take counted in post-filter batches, ``first_index`` for ordered
write-back — over either of two sources:

- a ``StreamConsumer`` on a broker topic of Confluent-framed Avro: each
  poll is stripped of its 5-byte frames and decoded in one call of the
  native engine (``stream.native.NativeCodec``), the JAX package's
  message-list leg;
- an in-memory ``RowSource`` of already-decoded sensor rows.

The windowed (LSTM) path, the columnar frame-decoder ring and the
schema-resolving decode are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.normalize import CAR_NORMALIZER, Normalizer
from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA, RecordSchema
from ..stream.consumer import StreamConsumer
from ..stream.native import NativeCodec

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
    y: Optional[np.ndarray] = None  # supervised target

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
                 pad_tail: bool = True,
                 keep_labels: bool = False,
                 cache: bool = False,
                 schema: RecordSchema = KSQL_CAR_SCHEMA):
        self.normalizer = normalizer
        self.batch_size = batch_size
        self.take = take
        self.skip = skip
        self.only_normal = only_normal
        self.pad_tail = pad_tail
        self.keep_labels = keep_labels
        self.cache = cache
        self._cached = None
        self.consumer: Optional[StreamConsumer] = None
        self.source: Optional[RowSource] = None
        if isinstance(source, StreamConsumer):
            self.consumer = source
            self.schema = schema
            self._native = NativeCodec(schema)
            # the label's column among the schema's string fields
            strings = [f.name for f in schema.fields
                       if f.avro_type == "string"]
            self._label_col = strings.index(schema.label_field) \
                if schema.label_field in strings else None
        elif isinstance(source, RowSource):
            self.source = source
        else:
            raise TypeError(f"SensorBatches reads a StreamConsumer or a "
                            f"RowSource, not {type(source).__name__}")
        self.position = 0  # the read cursor into a RowSource
        # skip applies once to the stream head, not once per drain
        self._skipped = 0
        # rows still wanted by the current bounded iteration (None =
        # unbounded): reading past what `take` will batch would move the
        # cursor over rows the caller never sees
        self._need_rows: Optional[int] = None

    def _decode_msgs(self, msgs):
        """(float64 sensor rows, labels) of one poll: frames stripped and
        Avro decoded in one native call."""
        num, lab = self._native.decode_batch([m.value for m in msgs],
                                             strip=5)
        labels = lab[:, self._label_col].astype("U") \
            if self._label_col is not None \
            else np.full((len(msgs),), "", object)
        return num, labels

    def _decoded_chunks(self):
        """Yield (float64 sensor rows, labels) per read: the rows a
        bounded iteration still needs, else the rest of the stream."""
        while True:
            if self.consumer is not None:
                limit = POLL_CHUNK if self._need_rows is None \
                    else max(1, min(POLL_CHUNK, self._need_rows))
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
            yield num, labels

    def _filtered_chunks(self):
        """Yield (xs [n, F] float32 normalized, labels [n]) per read."""
        for num, labels in self._decoded_chunks():
            xs = self.normalizer.np(num)
            if self.only_normal:
                keep = labels == "false"
                xs, labels = xs[keep], labels[keep]
            if len(xs):
                yield xs, labels

    def __iter__(self) -> Iterator[Batch]:
        B = self.batch_size
        parts: list = []  # pending (xs, labels) chunks
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
            else:
                xs, labels = parts[0]
            parts = []
            have = 0
            return xs, labels

        def emit(xs, labels, lo):
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
            return Batch(x, n_valid, 0, lab)  # first_index set by caller

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
                xs, labels = assemble()
                lo = 0
                while len(xs) - lo >= B:
                    if self._skipped < self.skip:
                        self._skipped += 1
                    else:
                        b = emit(xs, labels, lo)
                        b.first_index = index
                        yield b
                        emitted += 1
                        index += B
                        if self.take and emitted >= self.take:
                            return
                    lo += B
                if lo < len(xs):
                    parts = [(xs[lo:], labels[lo:])]
                    have = len(xs) - lo
            if have and self.pad_tail and self._skipped >= self.skip and \
                    (not self.take or emitted < self.take):
                xs, labels = assemble()
                b = emit(xs, labels, 0)
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
