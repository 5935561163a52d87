"""The native Kafka wire client (``iotml.stream.native_kafka``'s twin).

``NativeKafkaBroker`` is the C++ twin of ``kafka_wire.KafkaWireBroker``:
the same ``Broker`` duck-type (produce / fetch / end_offset / commit /
...), with every wire byte handled in ``cpp/kafka_client.cc``, built into
the port's one native library (``stream.native``).  Its message sets go
through ``cpp/msgset_engine.cc``, the codec the pure-Python client and
the server use too.

Beyond the duck-type it has the fused hot path ``fetch_decode``: fetch,
Confluent framing strip and columnar Avro decode in one native call,
returning ``(numeric [n, F] float64, labels [n, S], next_offset)`` with
no per-message Python object; ``fetch_decode_keys`` adds each message's
key.  ``StreamConsumer.poll_decoded`` and ``SensorBatches`` take it when
the broker has it.  ``last_event_time()`` gives the calling thread the
min and max record timestamp of its last fused decode, which the
consumer folds into its watermark (the JAX package reads them off its
columnar decoder instead).

A guard stands behind the fused decode's blind 5-byte strip: a frame
whose writer id lies in the evolved-schema band (``RESERVED_ID_BASE``
and up) or that is not Confluent-framed stops the decode before it and
raises ``SchemaIdMismatchError``, so the consumer resolves that chunk by
name instead of mis-reading it.

One socket and one staging area a handle: every native call holds the
client's lock.  A server that cannot be reached, or that refuses the
SASL/PLAIN credentials, raises ``ConnectionError``; there is no fallback
to the pure client.  ``produce_raw`` ships a pre-framed batch over
RAW_PRODUCE (``iotml_kafka_produce_raw``: the bytes go onto the socket
as they are), with the pure client's error surface.  Record headers are
dropped, as the wire has no header slot.
"""

from __future__ import annotations

import ctypes
import threading
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.schema import RESERVED_ID_BASE
from ..utils.net import parse_bootstrap
from . import native
from .broker import (CorruptMessageError, Message, OffsetOutOfRangeError,
                     SchemaIdMismatchError, TopicSpec)
from .kafka_wire import NotLeaderForPartitionError, ProducePartitionMixin
from .native import KEY_STRIDE, LABEL_STRIDE, NativeCodec, _column

_ERR_NAMES = {1: "OFFSET_OUT_OF_RANGE", 3: "UNKNOWN_TOPIC_OR_PARTITION",
              6: "NOT_LEADER_FOR_PARTITION", 16: "NOT_COORDINATOR",
              35: "UNSUPPORTED_VERSION", 36: "TOPIC_ALREADY_EXISTS",
              58: "SASL_AUTHENTICATION_FAILED"}
#: the client's return codes below the protocol band
_K_EIO, _K_EMSGSET, _K_ESCHEMA = -2, -3, -1999

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)


class KafkaProtocolError(RuntimeError):
    """A request the server answered with a Kafka error code (``code``),
    or one whose socket or frame failed (``code`` None)."""

    def __init__(self, rc: int, what: str):
        code = -rc - 1000
        name = _ERR_NAMES.get(code, str(code))
        super().__init__(f"{what}: kafka error {name}" if rc <= -1000
                         else f"{what}: transport error")
        self.code = code if rc <= -1000 else None


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise KafkaProtocolError(rc, what)
    return rc


class NativeKafkaBroker(ProducePartitionMixin):
    """Kafka-protocol client over the C++ engine, ``Broker`` duck-typed.

    ``servers`` is a bootstrap list ``host:port[,...]``; the first that
    answers (and accepts the credentials) wins.  Keys in
    ``fetch_decode_keys`` take ``native.KEY_STRIDE`` bytes a row, cut at
    ``KEY_STRIDE - 1``; the fused decode strips writer ids under
    ``RESERVED_ID_BASE`` blindly and stops at any other.
    """

    def __init__(self, servers: str, client_id: str = "iotml-native",
                 sasl_username: Optional[str] = None,
                 sasl_password: Optional[str] = None,
                 timeout_s: float = 30.0):
        #: rows whose key filled the stride (possibly cut by the engine,
        #: which writes at most KEY_STRIDE - 1 bytes)
        self.keys_maybe_truncated = 0
        self._lib = native.load()
        self._h = None
        for host, port in parse_bootstrap(servers):
            self._h = self._lib.iotml_kafka_connect(
                host.encode(), port, client_id.encode(),
                sasl_username.encode() if sasl_username is not None else None,
                sasl_password.encode() if sasl_password is not None else None,
                timeout_s)
            if self._h:
                break
        if not self._h:
            raise ConnectionError(
                f"native kafka connect to {servers} failed"
                + (" (SASL)" if sasl_username else ""))
        self._lib.iotml_kafka_set_pinned_id_limit(self._h, RESERVED_ID_BASE)
        self._meta: Dict[str, int] = {}
        self._rr: Dict[str, int] = {}
        # RLock: create_topic and produce_many re-enter through topic()
        self._lock = threading.RLock()
        # per calling thread: (ts_min, ts_max) of its last fused decode
        self._event_time = threading.local()

    # ------------------------------------------------------------ metadata
    def topic(self, name: str) -> TopicSpec:
        """The topic's partition count (cached after the first lookup);
        KeyError if the server does not know it."""
        with self._lock:
            n = self._meta.get(name)
            if not n:
                n = self.refresh_topic(name)
                if n is None:
                    raise KeyError(name)
            return TopicSpec(name, n)

    def refresh_topic(self, name: str) -> Optional[int]:
        """Drop the cached partition count and ask the server again: the
        fresh count, or None while the topic does not exist."""
        with self._lock:
            self._meta.pop(name, None)
            n = _check(self._lib.iotml_kafka_metadata(self._h, name.encode()),
                       f"metadata({name})")
            if n == 0:
                return None
            self._meta[name] = n
            return n

    def create_topic(self, name: str, partitions: int = 1,
                     cleanup_policy: Optional[str] = None) -> TopicSpec:
        """CreateTopics; an existing topic is returned as the server has
        it."""
        with self._lock:
            existed = _check(self._lib.iotml_kafka_create_topic(
                self._h, name.encode(), partitions,
                cleanup_policy.encode() if cleanup_policy else None),
                f"create_topic({name})")
            if existed:
                # the real partition count may differ from the request
                self._meta.pop(name, None)
                return self.topic(name)
            self._meta[name] = partitions
            return TopicSpec(name, partitions)

    # ------------------------------------------------------------- produce
    def _partition_count_or_default(self, topic: str) -> int:
        try:
            return self.topic(topic).partitions
        except KeyError:
            return 1

    def produce_many(self, topic: str, entries,
                     partition: Optional[int] = None) -> int:
        """entries: [(key, value, timestamp_ms[, headers])] → offset of
        the last one; one Produce request a partition.  A None value is a
        tombstone (a null value on the wire); headers are dropped."""
        with self._lock:
            by_part: Dict[int, list] = {}
            for key, value, ts, *_hdrs in entries:
                p = self._partition_for(topic, key) if partition is None \
                    else partition
                by_part.setdefault(p, []).append((key, value, ts))
            last = -1
            for p, ents in sorted(by_part.items()):
                n = len(ents)
                values, voff = _column([v for _, v, _ in ents])
                vnull = np.fromiter((v is None for _, v, _ in ents),
                                    np.uint8, n)
                ts = np.fromiter((t for _, _, t in ents), np.int64, n)
                if any(k is not None for k, _, _ in ents):
                    keys, koff = _column([k for k, _, _ in ents])
                    knull = np.fromiter((k is None for k, _, _ in ents),
                                        np.uint8, n)
                    kargs = (keys, koff.ctypes.data_as(_i64p),
                             knull.ctypes.data_as(_u8p))
                else:  # every key null: NULL columns
                    kargs = (None, None, None)
                rc = self._lib.iotml_kafka_produce(
                    self._h, topic.encode(), p, values,
                    voff.ctypes.data_as(_i64p),
                    vnull.ctypes.data_as(_u8p) if vnull.any() else None,
                    *kargs, ts.ctypes.data_as(_i64p), n)
                if rc == -1006:
                    raise NotLeaderForPartitionError(topic, p)
                if rc == -1003:
                    raise KeyError(topic)
                base = _check(rc, f"produce({topic}:{p})")
                last = max(last, base + n - 1)
            return last

    def produce_raw(self, topic: str, partition: int, frames: bytes) -> int:
        """RAW_PRODUCE through the C++ client: the pre-framed batch goes
        onto the socket as it is; returns its base offset.  Raises
        NotImplementedError against a server without the extension (pin
        back to ``produce_many``), ``CorruptMessageError`` when the
        server rejected the batch (nothing appended), and
        NotLeaderForPartitionError, as the pure client does."""
        with self._lock:
            rc = self._lib.iotml_kafka_produce_raw(
                self._h, topic.encode(), partition,
                ctypes.cast(ctypes.c_char_p(frames), _u8p), len(frames))
        if rc == -1035:
            raise NotImplementedError(
                "server lacks the RAW_PRODUCE extension")
        if rc == -1002:
            raise CorruptMessageError(topic, partition, -1)
        if rc == -1006:
            raise NotLeaderForPartitionError(topic, partition)
        if rc == -1003:
            raise KeyError(topic)
        return _check(rc, f"produce_raw({topic}:{partition})")

    # --------------------------------------------------------------- fetch
    def _raise_for(self, rc: int, topic: str, partition: int, offset: int,
                   what: str) -> None:
        """Raise the typed error of a negative fetch return code."""
        if rc >= 0:
            return
        where = f"{what}({topic}:{partition}@{offset})"
        if rc == -1003:
            raise KeyError(topic)
        if rc == -1001:
            # the server rides the earliest retained offset in the hwm slot
            earliest = max(int(self._lib.iotml_kafka_high_watermark(
                self._h)), 0)
            raise OffsetOutOfRangeError(topic, partition, offset, earliest)
        if rc == -1006:
            raise NotLeaderForPartitionError(topic, partition)
        if rc == _K_EMSGSET:
            raise ValueError(f"{where}: the message-set decoder refused the "
                             f"response (a CRC mismatch or an entry size "
                             f"under 14 bytes)")
        if rc == _K_ESCHEMA:
            raise SchemaIdMismatchError(topic, partition, offset)
        if rc <= -2000:
            raise ValueError(f"{where}: malformed Avro message at row "
                             f"{-(rc + 2000) - 1}")
        raise KafkaProtocolError(rc, where)

    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        """Up to ``max_messages`` records from ``offset`` (a null value,
        a tombstone, stays None)."""
        with self._lock:
            n = self._lib.iotml_kafka_fetch(self._h, topic.encode(),
                                            partition, offset, max_messages)
            self._raise_for(n, topic, partition, offset, "fetch")
            if n == 0:
                return []
            vb, kb = ctypes.c_int64(), ctypes.c_int64()
            self._lib.iotml_kafka_staged_bytes(self._h, ctypes.byref(vb),
                                               ctypes.byref(kb))
            values = ctypes.create_string_buffer(max(vb.value, 1))
            keys = ctypes.create_string_buffer(max(kb.value, 1))
            voff = np.zeros((n + 1,), np.int64)
            koff = np.zeros((n + 1,), np.int64)
            knull = np.zeros((n,), np.uint8)
            vnull = np.zeros((n,), np.uint8)
            moff = np.zeros((n,), np.int64)
            ts = np.zeros((n,), np.int64)
            # before take, which clears the staging area
            self._lib.iotml_kafka_staged_value_nulls(
                self._h, vnull.ctypes.data_as(_u8p))
            self._lib.iotml_kafka_take(
                self._h, values, voff.ctypes.data_as(_i64p), keys,
                koff.ctypes.data_as(_i64p), knull.ctypes.data_as(_u8p),
                moff.ctypes.data_as(_i64p), ts.ctypes.data_as(_i64p))
            vraw, kraw = values.raw, keys.raw
            vo, ko = voff.tolist(), koff.tolist()
            return [Message(topic, partition, o,
                            None if vn else vraw[vo[i]:vo[i + 1]],
                            None if kn else kraw[ko[i]:ko[i + 1]], t)
                    for i, (o, t, vn, kn) in enumerate(zip(
                        moff.tolist(), ts.tolist(), vnull.tolist(),
                        knull.tolist()))]

    def fetch_decode(self, topic: str, partition: int, offset: int,
                     codec: NativeCodec, strip: int = 5,
                     max_rows: int = 4096
                     ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Fused poll → (numeric [n, F] float64, labels [n, S] bytes,
        next_offset); n == 0 means no data at ``offset``."""
        numeric, labels, _, next_off = self._fetch_decode(
            topic, partition, offset, codec, strip, max_rows, False)
        return numeric, labels, next_off

    def fetch_decode_keys(self, topic: str, partition: int, offset: int,
                          codec: NativeCodec, strip: int = 5,
                          max_rows: int = 4096
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                     int]:
        """``fetch_decode`` + each message's key: (numeric, labels, keys
        [n] S{KEY_STRIDE} bytes, next_offset).  The key is the record's
        routing identity (the car id), what car-health detection joins
        on; a key that fills the stride may have been cut and is counted
        in ``keys_maybe_truncated`` (the first such poll warns)."""
        return self._fetch_decode(topic, partition, offset, codec, strip,
                                  max_rows, True)

    def _fetch_decode(self, topic, partition, offset, codec, strip,
                      max_rows, with_keys):
        t0 = time.perf_counter()
        numeric = np.empty((max_rows, codec.n_numeric), np.float64)
        labels = np.zeros((max_rows, max(codec.n_strings, 1)),
                          f"S{LABEL_STRIDE}")
        keys = np.zeros((max_rows if with_keys else 0,), f"S{KEY_STRIDE}")
        next_off = ctypes.c_int64(offset)
        common = (self._h, topic.encode(), partition, offset,
                  codec.types.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                  codec.nullable.ctypes.data_as(_u8p), codec.n_fields, strip,
                  numeric.ctypes.data_as(_f64p),
                  labels.ctypes.data_as(ctypes.c_char_p), LABEL_STRIDE)
        with self._lock:
            if with_keys:
                rc = self._lib.iotml_kafka_fetch_decode_keys(
                    *common, keys.ctypes.data_as(ctypes.c_char_p),
                    KEY_STRIDE, max_rows, ctypes.byref(next_off))
            else:
                rc = self._lib.iotml_kafka_fetch_decode(
                    *common, max_rows, ctypes.byref(next_off))
            self._raise_for(rc, topic, partition, offset, "fetch_decode")
            bounds = np.empty(2, np.int64)
            self._lib.iotml_kafka_last_event_time(
                self._h, bounds.ctypes.data_as(_i64p))
        self._event_time.bounds = (int(bounds[0]), int(bounds[1]))
        native.tally("fetch_decode", rc, t0)
        out = (numeric[:rc], labels[:rc, : codec.n_strings])
        if not with_keys:
            return out + (None, int(next_off.value))
        keys = keys[:rc]
        cut = int(np.sum(np.char.str_len(keys) >= KEY_STRIDE - 1))
        if cut:
            if not self.keys_maybe_truncated:
                warnings.warn(
                    f"{cut} message key(s) filled KEY_STRIDE - 1 = "
                    f"{KEY_STRIDE - 1} bytes and may be cut: keys sharing "
                    f"that prefix alias one car", RuntimeWarning,
                    stacklevel=3)
            self.keys_maybe_truncated += cut
        return out + (keys, int(next_off.value))

    def last_event_time(self) -> Tuple[int, int]:
        """(ts_min, ts_max) ms of the rows this thread's last
        ``fetch_decode(_keys)`` decoded; (-1, -1) for none."""
        return getattr(self._event_time, "bounds", (-1, -1))

    # ------------------------------------------------------------- offsets
    def _list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        with self._lock:
            rc = self._lib.iotml_kafka_list_offset(
                self._h, topic.encode(), partition, timestamp)
            if rc == -1003:
                raise KeyError(topic)
            return _check(rc, f"list_offset({topic}:{partition})")

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._list_offset(topic, partition, -1)

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._list_offset(topic, partition, -2)

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        self.commit_many(group, topic, [(partition, next_offset)])

    def commit_many(self, group: str, topic: str, entries) -> None:
        """Commit [(partition, next_offset), ...] of one topic in ONE
        OffsetCommit request."""
        entries = list(entries)
        if not entries:
            return
        parts = np.asarray([p for p, _ in entries], np.int32)
        offs = np.asarray([o for _, o in entries], np.int64)
        with self._lock:
            _check(self._lib.iotml_kafka_commit_many(
                self._h, group.encode(), topic.encode(),
                parts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                offs.ctypes.data_as(_i64p), len(entries)),
                f"commit_many({group},{topic})")

    def committed(self, group: str, topic: str,
                  partition: int) -> Optional[int]:
        with self._lock:
            off = self._lib.iotml_kafka_committed(
                self._h, group.encode(), topic.encode(), partition)
        if off < -1:  # -1 itself means "no committed offset"
            raise KafkaProtocolError(off, f"committed({group},{topic})")
        return None if off == -1 else off

    def committed_many(self, group: str, pairs
                       ) -> Dict[Tuple[str, int], int]:
        """Committed offsets of [(topic, partition), ...]; pairs with
        nothing committed are left out.  The native client has no
        batched OffsetFetch, so this is one request a pair."""
        out = {}
        for t, p in pairs:
            off = self.committed(group, t, p)
            if off is not None:
                out[(t, p)] = off
        return out

    def close(self) -> None:
        with self._lock:
            if self._h:
                self._lib.iotml_kafka_close(self._h)
                self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()
