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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


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
