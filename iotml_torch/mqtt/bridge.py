"""MQTT→stream bridge — the HiveMQ Kafka-extension equivalent
(``iotml.mqtt.bridge``'s copy).

The reference bridges MQTT into Kafka with a broker extension configured by
topic-mappings: every publish matching `vehicles/sensor/data/#` is produced
to Kafka topic `sensor-data` (reference
`infrastructure/hivemq/kafka-config.yaml:20-29`).  The record key is the
MQTT topic, which is what lets the downstream KSQL re-key and the MongoDB
sink HoistField the car id (reference
`infrastructure/kafka-connect/mongodb/mongodb-connector-configmap.yaml:14-16`).

`KafkaBridge` subscribes to the MQTT broker core with each mapping's filter
and produces the payload bytes unchanged into the framework's stream
broker, counting forwards under the reference's metric family name
(`kafka_extension_total_*`, charted by `hivemq.json`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional

from ..obs import tracing
from ..obs.metrics import default_registry
from ..stream.broker import Broker
from .broker import MqttBroker


@dataclasses.dataclass(frozen=True)
class TopicMapping:
    """One <topic-mapping>: MQTT filter(s) → stream topic.

    ``stream_key`` picks the produced record's key: ``"topic"`` is the
    reference extension's shape (full MQTT topic — downstream KSQL
    re-keys); ``"car"`` keys by the topic's LAST segment (the car id on
    ``vehicles/sensor/data/{car}``), which is what lets a federated
    MQTT front produce straight into the keyed sensor stream the twin
    shards consume — same car, same partition, no re-key hop."""

    mqtt_topic_filters: tuple
    stream_topic: str
    id: str = ""
    stream_key: str = "topic"

    def __post_init__(self):
        if self.stream_key not in ("topic", "car"):
            raise ValueError(f"stream_key must be 'topic' or 'car', "
                             f"got {self.stream_key!r}")

    @classmethod
    def sensor_data(cls) -> "TopicMapping":
        """The reference's single production mapping."""
        return cls(("vehicles/sensor/data/#",), "sensor-data",
                   id="sensor-data")

    @classmethod
    def sensor_data_keyed(cls, stream_topic: str = "SENSOR_DATA_S_AVRO"
                          ) -> "TopicMapping":
        """The federated-front mapping: framed-Avro payloads land on the
        twin shards' source topic keyed by car id."""
        return cls(("vehicles/sensor/data/#",), stream_topic,
                   id="sensor-data-keyed", stream_key="car")


class KafkaBridge:
    """Forward matching MQTT publishes into stream-broker topics."""

    def __init__(self, mqtt: MqttBroker, stream: Broker,
                 mappings: Optional[List[TopicMapping]] = None,
                 partitions: int = 10):
        self.mqtt = mqtt
        self.stream = stream
        self.mappings = mappings or [TopicMapping.sensor_data()]
        self._m_fwd = default_registry.counter(
            "kafka_extension_total_forwarded",
            "MQTT publishes bridged into the stream broker (reference "
            "family kafka_extension_*)")
        # bridge lag: time from MQTT delivery to the stream-broker append.
        # The reference charts its extension's write latency/rate in
        # hivemq.json; here the forward is synchronous, so this histogram
        # IS the end-to-end extension lag an operator watches
        self._m_lag = default_registry.histogram(
            "kafka_extension_forward_seconds",
            "MQTT→stream bridge forward latency per message")
        # the registry counter is process-global (shared across bridges for
        # scrape purposes); per-instance accounting needs its own counter
        self._n_fwd = 0
        self._n_lock = threading.Lock()
        for i, m in enumerate(self.mappings):
            # the reference provisions sensor-data with 10 partitions
            stream.create_topic(m.stream_topic, partitions=partitions)
            cid = f"__bridge__{m.id or i}"
            dest = m.stream_topic
            car_key = m.stream_key == "car"

            def deliver(topic, payload, qos, retain, _dest=dest,
                        _car_key=car_key):
                # the publisher-thread trace context (fan-out latency so
                # far = mqtt_deliver) becomes a stream-record header; the
                # MQTT payload and the produced value stay byte-identical.
                # BOTH marks happen BEFORE produce(): the append hands the
                # live context to consumer threads, and a mark after the
                # handoff would race theirs (mark is owner-serial by
                # contract).  The produce latency itself is the
                # kafka_extension_forward_seconds histogram below; on the
                # trace it rides the downstream stage's span as queue time.
                hdrs = None
                ctx = tracing.current() if tracing.ENABLED else None
                if ctx is not None:
                    ctx.mark("mqtt_deliver")
                    ctx.mark("bridge_produce")
                    hdrs = tracing.headers_for(ctx)
                t0 = time.perf_counter()
                key = (topic.rsplit("/", 1)[-1] if _car_key
                       else topic).encode()
                self.stream.produce(_dest, payload, key=key,
                                    timestamp_ms=int(time.time() * 1000),  # wallclock-ok: record timestamp, not a timeout
                                    headers=hdrs)
                self._m_lag.observe(time.perf_counter() - t0)
                self._m_fwd.inc()
                with self._n_lock:
                    self._n_fwd += 1

            sess = mqtt.connect(cid, deliver, clean_start=True)
            mqtt.deliver_pending(sess)  # in-process consumer: ready at once
            for f in m.mqtt_topic_filters:
                mqtt.subscribe(cid, f)

    def forwarded(self) -> int:
        with self._n_lock:
            return self._n_fwd
