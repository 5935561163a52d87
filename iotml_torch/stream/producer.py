"""Ordered write-back (``iotml.stream.producer.OutputSequence``'s twin).

The reference writes predictions back with ``kafka_io.KafkaOutputSequence``
(cardata-v3.py:238-252): results get an absolute index as batches
complete, and ``flush()`` publishes them in index order, so the output
preserves input order even when batches finish out of order; a missing
index raises instead of shipping misaligned predictions.

``OutputSequence(broker, topic, partition)`` publishes to a broker topic
with one ``produce_many`` per flush: over the wire that is one Produce
request, where a produce per message would be a round trip each.
``OutputSequence()`` publishes into the in-memory ``published`` list.

``RawBatchProducer`` is the write path's raw leg: a chunk framed once
(natively, at conversion) ships over RAW_PRODUCE and is appended as it
is, with the fallback ladder of ``IOTML_RAW_PRODUCE`` (auto | on | off):
a server without the extension pins the producer back to
``produce_many`` for good, as the consumer pins back from RAW_FETCH.
Its four families (``iotml_raw_produce_*``) live in the port's metrics
registry (``obs.metrics.default_registry``), as the JAX module's do in
JAX's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ..obs import tracing
from ..obs.metrics import default_registry as _metrics

#: the write plane's telemetry: the ship-and-append half of the produce
#: leg (the converters observe the convert-and-frame half)
raw_produce_records = _metrics.counter(
    "iotml_raw_produce_records_total",
    "records shipped as pre-framed RAW_PRODUCE batches")
raw_produce_fallbacks = _metrics.counter(
    "iotml_raw_produce_fallbacks_total",
    "producers pinned back to classic PRODUCE (UNSUPPORTED_VERSION)")
raw_produce_append_seconds = _metrics.histogram(
    "iotml_raw_produce_append_seconds",
    "RAW_PRODUCE ship+append latency per batch (the produce leg's "
    "append half)")
raw_produce_convert_seconds = _metrics.histogram(
    "iotml_raw_produce_convert_seconds",
    "convert+frame latency per raw batch (the produce leg's native "
    "JSON→Avro→frame half, observed by the fused converters)")


class OutputSequence:
    """Buffer of (index → message) flushed in index order to a broker
    topic, or to ``published`` when no broker is given."""

    def __init__(self, broker=None, topic: Optional[str] = None,
                 partition: Optional[int] = None):
        if (broker is None) != (topic is None):
            raise ValueError("give both a broker and a topic, or neither")
        self.broker = broker
        self.topic = topic
        self.partition = partition
        self._buf: Dict[int, bytes] = {}
        #: every flushed (index, message), in publish order (no broker)
        self.published: List[Tuple[int, bytes]] = []

    def setitem(self, index: int, message):
        if isinstance(message, str):
            message = message.encode()
        if index in self._buf:
            raise ValueError(f"duplicate output index {index}")
        self._buf[index] = message

    def __setitem__(self, index: int, message):
        self.setitem(index, message)

    def flush(self, allow_gaps: bool = False) -> int:
        """Publish buffered messages in ascending index order; returns the
        number flushed.  Unless ``allow_gaps``, a gap in the indices
        raises: an out-of-order scorer must fail loudly, not ship
        misaligned predictions."""
        if not self._buf:
            return 0
        idxs = sorted(self._buf)
        if not allow_gaps:
            lo, hi = idxs[0], idxs[-1]
            if hi - lo + 1 != len(idxs):
                missing = set(range(lo, hi + 1)) - set(idxs)
                raise ValueError(
                    f"output sequence has gaps at {sorted(missing)[:8]}...")
        if self.broker is None:
            self.published.extend((i, self._buf[i]) for i in idxs)
        else:
            # one batched call, in index order
            self.broker.produce_many(
                self.topic, [(None, self._buf[i], 0) for i in idxs],
                partition=self.partition)
        self._buf.clear()
        return len(idxs)


class RawBatchProducer:
    """Ship pre-framed raw batches to one topic, with the classic
    fallback ladder of ``IOTML_RAW_PRODUCE``:

    - ``auto`` (default): ``produce_raw``; the first NotImplementedError
      (a server or relay without the extension) pins this producer back
      to ``produce_many`` for good;
    - ``on``: raw required; a server without it raises (a silent
      fallback must fail, not degrade);
    - ``off``: ``produce_many`` always.

    Redelivery is the caller's (RAW_PRODUCE is not idempotent); a
    ``CorruptMessageError`` means nothing was appended.  Splitting at
    ``IOTML_PRODUCE_BATCH_BYTES`` is the caller's too (frames split only
    at frame boundaries, which the encoder owns).
    """

    def __init__(self, broker, topic: str, mode: Optional[str] = None):
        from ..data.pipeline import raw_produce_mode

        self.broker = broker
        self.topic = topic
        self.mode = raw_produce_mode() if mode is None else mode
        # None: undecided (auto), True: raw, False: pinned classic
        self._raw: Optional[bool] = {"on": True, "off": False,
                                     "auto": None}[self.mode]
        self.raw_batches = 0
        self.classic_records = 0

    @property
    def engaged(self) -> Optional[bool]:
        """True: the raw plane is in use; False: pinned classic; None:
        not decided yet (auto, before the first batch)."""
        return self._raw

    def produce_frames(self, partition: int, frames: bytes, count: int,
                       entries=None) -> int:
        """Ship one pre-framed batch of ``count`` records to
        ``partition``; returns its base offset.  ``entries`` ([(key,
        value, ts[, headers])], or a callable building them) is the
        classic form of the same records, which a pin-back ships; it may
        be left out only under ``on``, where a fallback is an error."""
        if self._raw is False:
            return self._classic(partition, entries)
        produce_raw = getattr(self.broker, "produce_raw", None)
        if produce_raw is None:
            self._pin_classic()
            return self._classic(partition, entries)
        ctx = None
        if tracing.ENABLED:
            # a sampled batch carries one trace context in its first
            # frame's headers, which survive RAW_PRODUCE, the segment
            # and RAW_FETCH as they are
            ctx = tracing.start("raw_produce")
            if ctx is not None:
                from ..ops.framing import stamp_first_frame

                frames = stamp_first_frame(frames,
                                           ((tracing.HEADER_KEY, ctx),))
        try:
            t0 = time.perf_counter()
            base = produce_raw(self.topic, partition, frames)
            raw_produce_append_seconds.observe(time.perf_counter() - t0)
        except NotImplementedError:
            self._pin_classic()
            return self._classic(partition, entries)
        if ctx is not None:
            tracing.mark_batch(ctx, "raw_produce_append", self.topic,
                               partition, base, base + count - 1, count)
        self._raw = True
        self.raw_batches += 1
        raw_produce_records.inc(count)
        return base

    def _pin_classic(self) -> None:
        if self.mode == "on":
            raise NotImplementedError(
                f"IOTML_RAW_PRODUCE=on but the broker for {self.topic!r} "
                f"lacks the RAW_PRODUCE extension")
        if self._raw is not False:
            self._raw = False
            raw_produce_fallbacks.inc()

    def _classic(self, partition: int, entries) -> int:
        if entries is None:
            raise NotImplementedError(
                f"RAW_PRODUCE unavailable for {self.topic!r} and no "
                f"classic-fallback entries were given")
        if callable(entries):
            entries = entries()  # built only when a pin-back needs it
        last = self.broker.produce_many(self.topic, entries,
                                        partition=partition)
        self.classic_records += len(entries)
        return last - len(entries) + 1
