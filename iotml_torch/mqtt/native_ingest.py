"""ctypes front for the native MQTT ingest engine
(``iotml.mqtt.native_ingest``'s copy; the engine is ``cpp/mqtt_ingest.cc``).

The third MQTT transport, for raw fleet throughput: CONNECT/PUBLISH
parsing and acking happen in C++ (epoll loop + frame parser), and Python
sees only bulk drains — one ctypes call returns every (topic, payload)
extracted since the last drain as a flat arena, so the per-message Python
cost of the ingest hot path drops to a couple of list-slice operations.
The arena's pointers are valid only until the next ``clear``: ``poll``
copies the whole arena out with one ``ctypes.string_at`` before it
clears.

`NativeIngestBridge` pairs the engine with the Kafka-extension role:
drained publishes matching the topic mapping are produced onto the stream
topic with the MQTT topic as key — identical record shape to
`mqtt.bridge.KafkaBridge`, same metric family — on a pump thread.  Which
leg a drained batch takes depends on the stream client: a wire client
with ``produce_raw`` (and RAW_PRODUCE engaged) gets ``_produce_raw``,
the batch framed once and shipped a partition at a time over
RAW_PRODUCE; anything else (the in-process ``Broker`` among them) gets
one ``produce_many`` a drained batch.

This front is ingest-ONLY by design (no subscriptions, no retained
messages, no QoS 2): the full broker semantics live on the Python fronts
that share `MqttProtocol`.  SUBSCRIBE is answered with the 0x80 failure
code, and a QoS 2 PUBLISH drops the connection.

The engine builds with the rest of the native stream engine
(``stream.native``: g++ at first use, named by a hash of the sources);
a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import List, Optional, Tuple

from ..obs.metrics import default_registry
from .bridge import TopicMapping
from .topic_tree import topic_matches


class NativeMqttIngest:
    """Own the engine handle; poll + drain batches of (topic, payload)."""

    def __init__(self, port: int = 0):
        from ..stream.native import load

        lib = load()
        self._lib = lib
        self._h = lib.iotml_mqtt_ingest_create(port)
        if not self._h:
            raise OSError(f"cannot bind native MQTT ingest on port {port}")
        self.port = lib.iotml_mqtt_ingest_port(self._h)
        self._lock = threading.Lock()

    @property
    def connection_count(self) -> int:
        with self._lock:
            if self._h is None:
                return 0
            return self._lib.iotml_mqtt_ingest_conns(self._h)

    def poll(self, timeout_ms: int = 50) -> List[Tuple[bytes, bytes]]:
        """One epoll pass + bulk drain → [(topic, payload), ...]."""
        with self._lock:
            if self._h is None:
                return []
            n = self._lib.iotml_mqtt_ingest_poll(self._h, timeout_ms)
            if n <= 0:
                return []
            blob = ctypes.POINTER(ctypes.c_uint8)()
            tl = ctypes.POINTER(ctypes.c_int32)()
            pl = ctypes.POINTER(ctypes.c_int32)()
            n = self._lib.iotml_mqtt_ingest_drain(
                self._h, ctypes.byref(blob), ctypes.byref(tl),
                ctypes.byref(pl))
            total = sum(tl[i] + pl[i] for i in range(n))
            raw = ctypes.string_at(blob, total)
            out = []
            off = 0
            for i in range(n):
                t, p = tl[i], pl[i]
                out.append((raw[off:off + t], raw[off + t:off + t + p]))
                off += t + p
            self._lib.iotml_mqtt_ingest_clear(self._h)
            return out

    def close(self) -> None:
        with self._lock:
            if self._h is not None:
                self._lib.iotml_mqtt_ingest_close(self._h)
                self._h = None

    def __enter__(self) -> "NativeMqttIngest":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NativeIngestBridge:
    """Native listener + Kafka-extension forwarding on a pump thread.

    The drained batch is filtered against the topic mapping (per-distinct-
    topic match result cached — fleets publish on stable per-car topics)
    and produced onto the stream topic keyed by MQTT topic, exactly the
    record shape `KafkaBridge` emits."""

    def __init__(self, stream,
                 mapping: Optional[TopicMapping] = None,
                 partitions: int = 10, port: int = 0):
        from ..stream.broker import Broker

        self.stream = stream
        self.mapping = mapping or TopicMapping.sensor_data()
        spec = stream.create_topic(self.mapping.stream_topic,
                                   partitions=partitions)
        # the topic may exist with another count: partition by the real
        # one, or keyed routing forks across producers
        partitions = getattr(spec, "partitions", partitions) or partitions
        self.ingest = NativeMqttIngest(port)
        self.port = self.ingest.port
        self._match_cache: dict = {}
        # mqtt topic bytes → stream record key bytes (the mapping's
        # stream_key policy, cached like the match result — fleets
        # publish on stable per-car topics)
        self._key_cache: dict = {}
        self._car_key = getattr(self.mapping, "stream_key",
                                "topic") == "car"
        self._n_fwd = 0
        #: cumulative seconds spent in the stream-produce call (the
        #: bridge leg of the e2e produce breakdown)
        self.produce_seconds = 0.0
        #: the raw produce leg into a wire client (None: produce_many)
        self._raw = None
        self._partitions = partitions
        self._part_cache: dict = {}  # record key bytes → partition
        if getattr(stream, "produce_raw", None) is not None and \
                not isinstance(stream, Broker):
            from ..stream.producer import RawBatchProducer

            rp = RawBatchProducer(stream, self.mapping.stream_topic)
            if rp.engaged is not False:
                self._raw = rp
        self._m_fwd = default_registry.counter(
            "kafka_extension_total_forwarded",
            "MQTT publishes bridged into the stream broker (reference "
            "family kafka_extension_*)")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _matches(self, topic: bytes) -> bool:
        hit = self._match_cache.get(topic)
        if hit is None:
            t = topic.decode(errors="replace")
            hit = any(topic_matches(f, t)
                      for f in self.mapping.mqtt_topic_filters)
            if len(self._match_cache) < 1_000_000:
                self._match_cache[topic] = hit
        return hit

    def _key_for(self, topic: bytes) -> bytes:
        if not self._car_key:
            return topic
        key = self._key_cache.get(topic)
        if key is None:
            key = topic.rsplit(b"/", 1)[-1]
            if len(self._key_cache) < 1_000_000:
                self._key_cache[topic] = key
        return key

    def pump_once(self, timeout_ms: int = 50) -> int:
        batch = self.ingest.poll(timeout_ms)
        if not batch:
            return 0
        ts = int(time.time() * 1000)  # wallclock-ok: record timestamp, not a timeout
        matches = self._matches
        key_for = self._key_for
        entries = [(key_for(topic), payload, ts)
                   for topic, payload in batch if matches(topic)]
        n = len(entries)
        if entries:
            t0 = time.perf_counter()
            if self._raw is not None and self._raw.engaged is not False:
                self._produce_raw(entries)
            else:
                # bulk append under one broker lock — the per-message
                # produce loop was this bridge's bottleneck once parsing
                # went native.  produce_many is the Broker duck-type
                # contract (emulator, wire client, native client alike),
                # so a real cluster swap stays a constructor change.
                self.stream.produce_many(self.mapping.stream_topic,
                                         entries)
            self.produce_seconds += time.perf_counter() - t0
            self._n_fwd += n
            self._m_fwd.inc(n)
        return n

    def _produce_raw(self, entries) -> None:
        """Frame a drained batch once and ship it a partition at a time
        over RAW_PRODUCE, partitioned by key hash as ``produce_many``
        partitions (per-key order holds across clients; the partition of
        a key is cached, fleets publish on stable per-car topics).
        Batches past ``IOTML_PRODUCE_BATCH_BYTES`` split at frame
        boundaries."""
        import zlib

        from ..data.pipeline import produce_batch_bytes
        from ..ops.framing import frame_entries

        cache = self._part_cache
        npart = self._partitions
        by_part: dict = {}
        for e in entries:
            key = e[0]
            p = cache.get(key)
            if p is None:
                p = zlib.crc32(key) % npart
                if len(cache) < 1_000_000:
                    cache[key] = p
            by_part.setdefault(p, []).append(e)
        cap = produce_batch_bytes()
        for p, ents in by_part.items():
            start = size = 0
            for i, e in enumerate(ents):
                # a frame's size ≈ key + value + its fixed head (the slack
                # the in-memory read_raw budget uses)
                size += len(e[0]) + len(e[1] or b"") + 64
                if size >= cap and i > start:
                    chunk = ents[start:i]
                    self._raw.produce_frames(p, frame_entries(chunk),
                                             len(chunk), entries=chunk)
                    start, size = i, len(e[0]) + len(e[1] or b"") + 64
            chunk = ents[start:]
            if chunk:
                self._raw.produce_frames(p, frame_entries(chunk),
                                         len(chunk), entries=chunk)

    def forwarded(self) -> int:
        return self._n_fwd

    def start(self) -> "NativeIngestBridge":
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._run, daemon=True,
            name=f"mqtt-native-{self.port}"))
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            self.pump_once(timeout_ms=50)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # final drain so nothing ACCEPTED before stop is lost: one pass
        # moves at most one arena, so loop until two consecutive empty
        # polls (level-triggered epoll guarantees pending kernel data keeps
        # reporting).  Bounded: quiesce publishers before stop, or the
        # deadline cuts the drain off.
        idle = 0
        deadline = time.monotonic() + 30
        while idle < 2 and time.monotonic() < deadline:
            idle = idle + 1 if self.pump_once(timeout_ms=0) == 0 else 0
        self.ingest.close()

    def __enter__(self) -> "NativeIngestBridge":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
