"""Federated MQTT ingest: N front processes, one consistent car→front map
(``iotml.gateway.fronts``'s copy).

The reference walls its single MQTT listener at the box's ~18k-fd
ceiling (PARITY "Fleet scale"); its own 100,000-car scenario assumes a
fleet of brokers behind a load balancer.  Here the C++ ingest engine
is single-core-idle at reference rates, so the scale axis is
horizontal — several front PROCESSES, each running its own native MQTT
listener, all producing into the SAME keyed sensor stream over the wire
protocol::

    fleet publisher ──crc32(car) % n_fronts──► front 0 (MQTT :p0) ─┐
                                               front 1 (MQTT :p1) ─┤ RAW_PRODUCE
                                               ...                 ▼
                                   SENSOR_DATA_S_AVRO (keyed by car id)
                                               │
                                   twin shards / gateway (iotml_torch.gateway)

The car→front assignment is the same pure-hash discipline the rest of
the plane uses (``front_for``), so a car's records always enter through
one front — per-car ordering survives federation.  Record keys come
from the topic's car segment (``TopicMapping.sensor_data_keyed``), so
every front's records land on the same partition the direct-produce
path would use: the twin shards cannot tell federated ingest from local.
"""

from __future__ import annotations

import json
import subprocess
import sys
import zlib
from typing import List, Optional

import numpy as np

from ..core.schema import KSQL_CAR_SCHEMA, RecordSchema
from ..gen.simulator import FleetGenerator, FleetScenario
from ..mqtt.bridge import TopicMapping
from ..mqtt.wire import MqttClient


def front_for(car_id: str, n_fronts: int) -> int:
    """The consistent car→front assignment — same hash family as the
    broker's keyed partitioner, so any publisher (or operator reading a
    capture) computes the same front with no coordination."""
    return zlib.crc32(car_id.encode()) % int(n_fronts)


class MqttFront:
    """One MQTT ingest front: a TCP listener bridging publishes into
    the keyed sensor stream.

    Native path (preferred): ``NativeIngestBridge`` — the C++ epoll
    engine drains publish batches and ships them as framed RAW_PRODUCE
    into a wire broker, the remote-front shape.  Fallback (no native
    lib): the Python ``MqttServer`` + ``KafkaBridge`` pair, same
    records, per-message produce.

    ``stream`` is a ``host:port`` bootstrap string (federated: the
    front runs in its own process and produces over the wire) or an
    in-process Broker duck-type (tests)."""

    def __init__(self, stream, partitions: int = 10, mqtt_port: int = 0,
                 mapping: Optional[TopicMapping] = None):
        self.mapping = mapping or TopicMapping.sensor_data_keyed()
        if isinstance(stream, str):
            from ..stream.kafka_wire import KafkaWireBroker

            stream = KafkaWireBroker(stream, client_id="iotml-front")
        self.stream = stream
        self.native = False
        self._bridge = None
        self._mqtt_server = None
        try:
            from ..mqtt.native_ingest import NativeIngestBridge

            self._bridge = NativeIngestBridge(
                stream, mapping=self.mapping, partitions=partitions,
                port=mqtt_port)
            self.port = self._bridge.port
            self.native = True
        except (RuntimeError, OSError):
            from ..mqtt.bridge import KafkaBridge
            from ..mqtt.broker import MqttBroker
            from ..mqtt.wire import MqttServer

            core = MqttBroker(name="iotml-front")
            self._py_bridge = KafkaBridge(core, stream,
                                          mappings=[self.mapping],
                                          partitions=partitions)
            self._mqtt_server = MqttServer(core, port=mqtt_port)
            self.port = self._mqtt_server.port

    def start(self) -> "MqttFront":
        if self.native:
            self._bridge.start()
        else:
            self._mqtt_server.start()
        return self

    def forwarded(self) -> int:
        if self.native:
            return self._bridge.forwarded()
        return self._py_bridge.forwarded()

    def stop(self) -> None:
        if self.native:
            self._bridge.stop()
        elif self._mqtt_server is not None:
            self._mqtt_server.shutdown()
            self._mqtt_server.server_close()


def run_front(stream: str, partitions: int = 10, mqtt_port: int = 0,
              topic: str = "SENSOR_DATA_S_AVRO") -> None:
    """Front-process entry (``python -m iotml_torch.gateway front``): serve
    MQTT, bridge into the wire broker, announce the bound port as one
    JSON line on stdout, and run until stdin closes — the parent owns
    the lifetime (closing the pipe is the shutdown signal, robust even
    when the parent dies uncleanly)."""
    front = MqttFront(stream, partitions=partitions, mqtt_port=mqtt_port,
                      mapping=TopicMapping.sensor_data_keyed(topic))
    front.start()
    print(json.dumps({"mqtt_port": front.port, "native": front.native}),
          flush=True)
    try:
        sys.stdin.buffer.read()  # blocks until the parent closes the pipe
    except KeyboardInterrupt:
        pass
    front.stop()
    print(json.dumps({"forwarded": front.forwarded()}), flush=True)


class FrontProcess:
    """Parent-side handle on one spawned front process.

    The child runs ``python -m iotml_torch.gateway front`` and finds the
    package as the parent does, from the working directory it inherits
    or ``PYTHONPATH``.  It is host code: it never touches the card."""

    def __init__(self, stream_addr: str, partitions: int = 10,
                 topic: str = "SENSOR_DATA_S_AVRO"):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "iotml_torch.gateway", "front",
             "--stream", stream_addr, "--partitions", str(partitions),
             "--topic", topic],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError("front process died before announcing "
                               "its MQTT port")
        doc = json.loads(line)
        self.mqtt_port = int(doc["mqtt_port"])
        self.native = bool(doc.get("native"))

    def stop(self, timeout_s: float = 10.0) -> Optional[int]:
        """Close the lifetime pipe, collect the front's forwarded count
        from its exit line (None if it died without one)."""
        forwarded = None
        try:
            self.proc.stdin.close()
            for line in self.proc.stdout:
                try:
                    forwarded = json.loads(line).get("forwarded")
                except ValueError:
                    continue
            self.proc.wait(timeout=timeout_s)
        except Exception:
            self.proc.kill()
        return forwarded

    def kill(self) -> None:
        self.proc.kill()


class FederatedFleet:
    """Drive a ``FleetScenario`` through N MQTT fronts.

    The publisher multiplexes each front's cars over ONE pipelined MQTT
    connection (``publish_many``): fleet scale here means 100k DISTINCT
    cars/topics/twins, not 100k sockets — the per-connection ceiling is
    PARITY's separately-measured axis.  Payloads are the same framed
    Avro the direct-produce path emits (vectorized native encode), on
    the reference's ``vehicles/sensor/data/{car}`` topics."""

    def __init__(self, scenario: FleetScenario, front_ports: List[int],
                 host: str = "127.0.0.1",
                 schema: RecordSchema = KSQL_CAR_SCHEMA):
        if not front_ports:
            raise ValueError("federation needs at least one front")
        self.gen = FleetGenerator(scenario)
        self.schema = schema
        self.n_fronts = len(front_ports)
        ids = [scenario.car_id(i) for i in range(scenario.num_cars)]
        self.topics = [f"vehicles/sensor/data/{cid}" for cid in ids]
        self.assign = [front_for(cid, self.n_fronts) for cid in ids]
        self.clients = [MqttClient(host, p, f"iotml-fleet-front{j}",
                                   keepalive=0)
                        for j, p in enumerate(front_ports)]
        self._codec = None
        try:
            from ..stream.native import NativeCodec

            self._codec = NativeCodec(schema)
        except Exception:
            self._codec = None
        self.published = 0

    @property
    def codec(self) -> str:
        """Which encoder the payloads take: ``native`` (the engine's
        batch encode) or ``avro`` (the pure per-record fallback)."""
        return "native" if self._codec is not None and \
            self.schema.label_field else "avro"

    def _payloads(self, cols: dict) -> List[bytes]:
        if self._codec is not None and self.schema.label_field:
            num = self.gen.sensor_matrix(cols)
            labels = cols["failure_occurred"].astype("S16")[:, None]
            return self._codec.encode_batch(num, labels, schema_id=1)
        from ..ops.avro import AvroCodec
        from ..ops.framing import frame

        codec = AvroCodec(self.schema)
        return [frame(codec.encode(self.gen.row_record(cols, i,
                                                       self.schema)))
                for i in range(len(cols["car"]))]

    def publish_tick(self, batch_cars: Optional[np.ndarray] = None,
                     chunk: int = 4096) -> int:
        """One tick for the whole fleet (or a car-index slice), fanned
        to the assigned fronts in pipelined chunks."""
        cols = self.gen.step_columns(batch_cars=batch_cars)
        payloads = self._payloads(cols)
        per_front: List[List] = [[] for _ in range(self.n_fronts)]
        for i, c in enumerate(cols["car"]):
            ci = int(c)
            per_front[self.assign[ci]].append((self.topics[ci],
                                               payloads[i]))
        n = 0
        for j, items in enumerate(per_front):
            for k in range(0, len(items), chunk):
                n += self.clients[j].publish_many(items[k:k + chunk])
        self.published += n
        return n

    def close(self) -> None:
        for c in self.clients:
            try:
                c.disconnect()
            except OSError:
                pass


def run_federated_fleet(cars: int = 100_000, fronts: int = 2,
                        ticks: int = 2, shards: int = 2,
                        partitions: int = 8, seed: int = 20,
                        probe_per_front: int = 3,
                        timeout_s: float = 900.0) -> dict:
    """The reference's full 100,000-car scenario, live and federated:
    a wire-protocol stream broker, ``fronts`` MQTT front PROCESSES
    producing into it, a sharded gateway serving the resulting twins.

    Verifies the federation contract end to end — every record arrives
    (published == folded), and the gateway answers point lookups for
    cars entering through EVERY front.  Returns a report dict whose
    ``ok`` is the verdict."""
    import time

    from ..stream.broker import Broker
    from ..stream.kafka_wire import KafkaWireServer
    from .router import GatewayClient
    from .shards import GatewayCluster

    t_start = time.perf_counter()
    broker = Broker()
    broker.create_topic("SENSOR_DATA_S_AVRO", partitions=partitions)
    wire = KafkaWireServer(broker).start()
    procs: List[FrontProcess] = []
    fleet = None
    cluster = None
    client = None
    try:
        procs = [FrontProcess(f"127.0.0.1:{wire.port}",
                              partitions=partitions)
                 for _ in range(fronts)]
        scenario = FleetScenario(num_cars=cars, seed=seed)
        fleet = FederatedFleet(scenario, [p.mqtt_port for p in procs])
        cluster = GatewayCluster(broker, n_shards=shards).start()
        client = GatewayClient(cluster)

        for _ in range(ticks):
            fleet.publish_tick()
        deadline = time.monotonic() + timeout_s
        while client.aggregate()["records"] < fleet.published:
            if time.monotonic() >= deadline:
                break
            time.sleep(0.25)
        agg = client.aggregate()

        # lookups for cars that entered through each front, by the
        # shared assignment policy — the federation's consistency proof
        per_front_ok = []
        for j in range(fronts):
            got = 0
            want = 0
            for i in range(cars):
                if want >= probe_per_front:
                    break
                cid = scenario.car_id(i)
                if front_for(cid, fronts) != j:
                    continue
                want += 1
                doc = client.get(cid)
                if doc is not None and doc.get("car") == cid:
                    got += 1
            per_front_ok.append(got == want and want > 0)

        report = {
            "cars": cars, "fronts": fronts, "ticks": ticks,
            "shards": shards, "partitions": partitions,
            "native_fronts": sum(1 for p in procs if p.native),
            "codec": fleet.codec,
            "published": fleet.published,
            "folded": agg["records"],
            "fleet_cars_served": agg["cars"],
            "per_front_lookups_ok": per_front_ok,
            "elapsed_s": round(time.perf_counter() - t_start, 2),
            "ok": (agg["records"] == fleet.published
                   and agg["cars"] == cars
                   and all(per_front_ok)),
        }
        return report
    finally:
        if client is not None:
            client.close()
        if cluster is not None:
            cluster.stop()
        if fleet is not None:
            fleet.close()
        for p in procs:
            p.stop()
        wire.shutdown()
        wire.server_close()
        broker.close()
