"""Device-simulator scenario: XML config + commander/agent runner
(``iotml.mqtt.scenario``'s copy).

The reference drives load through the HiveMQ device simulator, configured
by a scenario XML (brokers / clientGroups / topicGroups / subscriptions /
stages — reference `infrastructure/test-generator/scenario.xml`) and run by
a commander that fans agents out over Kubernetes (reference
`infrastructure/test-generator/kube-cli.sh:347-428`).  Here the same
scenario document drives an in-process agent fleet: client-id patterns
expand to car ids, publish lifecycles pull payloads from `FleetGenerator`,
shared-subscription consumer groups attach like the reference's six
`$share/consumers/...` clients, and per-agent publish metrics are exported
under the reference's `agent_publish_*` family names (devsim.json panels).

Agents can speak in-process (fast path for tests/benchmarks) or real MQTT
over TCP via `mqtt.wire.MqttClient` (`transport="tcp"`).
"""

from __future__ import annotations

import dataclasses
import json
import re
import threading
import time
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

from ..core.schema import CAR_SCHEMA
from ..gen.simulator import FleetGenerator, FleetScenario
from ..obs.metrics import default_registry
from .broker import MqttBroker, QueueClient
from .wire import MqttClient

_RATE_RE = re.compile(r"(\d+)\s*/\s*(\d+)?\s*s")
_DUR_RE = re.compile(r"(\d+)\s*(ms|s|m)?")


def parse_rate(rate: str) -> float:
    """'1/10s' → 0.1 msgs/s; '5/s' → 5.0."""
    m = _RATE_RE.fullmatch(rate.strip())
    if not m:
        raise ValueError(f"bad rate: {rate!r}")
    return int(m.group(1)) / int(m.group(2) or 1)


def parse_duration_s(dur: str) -> float:
    m = _DUR_RE.fullmatch(dur.strip())
    if not m:
        raise ValueError(f"bad duration: {dur!r}")
    v = int(m.group(1))
    return {"ms": v / 1000.0, "s": float(v), "m": v * 60.0}[m.group(2) or "s"]


def expand_pattern(pattern: str, i: int) -> str:
    """'electric-vehicle-[0-9]{5}' + 7 → 'electric-vehicle-00007'."""
    def sub(m):
        return f"{i:0{int(m.group(1))}d}"
    return re.sub(r"\[0-9\]\{(\d+)\}", sub, pattern)


@dataclasses.dataclass
class ClientGroup:
    id: str
    pattern: str
    count: int
    mqtt_version: int = 5


@dataclasses.dataclass
class TopicGroup:
    id: str
    pattern: str
    count: int


@dataclasses.dataclass
class Subscription:
    id: str
    topic_filter: Optional[str] = None   # explicit (may be $share/...)
    topic_group: Optional[str] = None    # or: wildcard over a topic group
    wildcard: bool = False


@dataclasses.dataclass
class PublishSpec:
    topic_group: str
    qos: int = 0
    count: int = 1
    rate_per_s: float = 1.0


@dataclasses.dataclass
class LifeCycle:
    id: str
    client_group: str
    ramp_up_s: float = 0.0
    connect: bool = False
    publish: Optional[PublishSpec] = None
    disconnect: bool = False


@dataclasses.dataclass
class Stage:
    id: str
    lifecycles: List[LifeCycle]


@dataclasses.dataclass
class Scenario:
    client_groups: Dict[str, ClientGroup]
    topic_groups: Dict[str, TopicGroup]
    subscriptions: List[Subscription]
    stages: List[Stage]
    broker_address: str = "127.0.0.1"
    broker_port: int = 1883


def parse_scenario(xml_text: str) -> Scenario:
    """Parse a reference-shaped scenario XML document."""
    root = ET.fromstring(xml_text)
    addr, port = "127.0.0.1", 1883
    b = root.find("brokers/broker")
    if b is not None:
        addr = b.findtext("address", addr)
        port = int(b.findtext("port", str(port)))
    cgs = {}
    for cg in root.findall("clientGroups/clientGroup"):
        g = ClientGroup(cg.get("id"),
                        cg.findtext("clientIdPattern"),
                        int(cg.findtext("count", "1")),
                        int(cg.findtext("mqttVersion", "5")))
        cgs[g.id] = g
    tgs = {}
    for tg in root.findall("topicGroups/topicGroup"):
        g = TopicGroup(tg.get("id"), tg.findtext("topicNamePattern"),
                       int(tg.findtext("count", "1")))
        tgs[g.id] = g
    subs = []
    for s in root.findall("subscriptions/subscription"):
        subs.append(Subscription(
            s.get("id"),
            topic_filter=s.findtext("topicFilter"),
            topic_group=s.findtext("topicGroup"),
            wildcard=s.findtext("wildCard", "false").lower() == "true"))
    stages = []
    for st in root.findall("stages/stage"):
        lcs = []
        for lc in st.findall("lifeCycle"):
            ramp = lc.find("rampUp")
            pub = lc.find("publish")
            spec = None
            if pub is not None:
                spec = PublishSpec(
                    topic_group=pub.get("topicGroup"),
                    qos=int(pub.get("qos", "0")),
                    count=int(pub.get("count", "1")),
                    rate_per_s=parse_rate(pub.get("rate", "1/1s")))
            lcs.append(LifeCycle(
                lc.get("id"), lc.get("clientGroup"),
                ramp_up_s=parse_duration_s(ramp.get("duration"))
                if ramp is not None else 0.0,
                connect=lc.find("connect") is not None,
                publish=spec,
                disconnect=lc.find("disconnect") is not None))
        stages.append(Stage(st.get("id"), lcs))
    return Scenario(cgs, tgs, subs, stages, addr, port)


EVALUATION_SCENARIO = Scenario(
    client_groups={"cg1": ClientGroup("cg1", "electric-vehicle-[0-9]{5}", 25)},
    topic_groups={"tg1": TopicGroup(
        "tg1", "vehicles/sensor/data/electric-vehicle-[0-9]{5}", 25)},
    subscriptions=[Subscription(
        "sub-1-shared", topic_filter="$share/consumers/vehicles/sensor/data/#")],
    stages=[Stage("publish", [LifeCycle(
        "publ", "cg1", ramp_up_s=5.0, connect=True,
        publish=PublishSpec("tg1", qos=1, count=40, rate_per_s=0.2),
        disconnect=True)])],
)


class ScenarioRunner:
    """Commander: expands client groups into agents and runs the stages.

    `time_scale=0` (default) runs as fast as possible — rates and ramp-ups
    become ordering only, which is the deterministic test/benchmark mode.
    A positive value sleeps `interval * time_scale` between ticks.
    """

    def __init__(self, scenario: Scenario, broker: MqttBroker,
                 transport: str = "inproc", port: Optional[int] = None,
                 time_scale: float = 0.0, seed: int = 7):
        self.scenario = scenario
        self.broker = broker
        self.transport = transport
        self.port = port
        self.time_scale = time_scale
        self.seed = seed
        reg = default_registry
        self._m_pub_ok = reg.counter(
            "agent_publish_success_total",
            "simulator agent publishes delivered (reference devsim family)")
        self._m_conn = reg.counter(
            "agent_connect_success_total", "simulator agent connects")
        self.consumer_counts: Dict[str, int] = {}
        # deliveries arrive on broker fan-out threads under tcp transport
        self._count_lock = threading.Lock()

    def _make_client(self, client_id: str, version: int):
        if self.transport == "tcp":
            # explicit port= means "the local test server" and overrides the
            # scenario's (typically cluster-internal) broker address too
            if self.port is not None:
                host, port = "127.0.0.1", self.port
            else:
                host = self.scenario.broker_address or "127.0.0.1"
                port = self.scenario.broker_port
            if port is None:
                raise ValueError(
                    "tcp transport needs a port: pass port= or set "
                    "<broker><port> in the scenario")
            return MqttClient(host, port, client_id,
                              protocol_level=4 if version < 5 else 5)
        return QueueClient(self.broker, client_id)

    def _group_filters(self, tg, wildcard: bool):
        """Subscription filters for a topic group.

        wildcard=True collapses the group to one valid filter: every level
        from the first one containing a pattern construct onward becomes a
        single trailing '#' ('vehicles/sensor/data/electric-vehicle-[0-9]{5}'
        → 'vehicles/sensor/data/#', the shape the reference's consumers use,
        scenario.xml sub-1).  wildcard=False subscribes each expanded topic
        of the group individually — the pattern itself is not a topic.
        """
        if wildcard:
            levels = tg.pattern.split("/")
            keep = []
            for lv in levels:
                if re.search(r"[\[\]{}()*+?\\]", lv):
                    break
                keep.append(lv)
            return ["/".join(keep + ["#"]) if len(keep) < len(levels)
                    else tg.pattern]
        return [expand_pattern(tg.pattern, i) for i in range(tg.count)]

    def _attach_consumers(self):
        consumers = []
        for sub in self.scenario.subscriptions:
            filters = [sub.topic_filter] if sub.topic_filter else []
            if not filters and sub.topic_group:
                tg = self.scenario.topic_groups[sub.topic_group]
                filters = self._group_filters(tg, sub.wildcard)
            if not filters:
                continue
            cid = f"consumer-{sub.id}"
            self.consumer_counts[cid] = 0

            def deliver(topic, payload, qos, retain, _cid=cid):
                with self._count_lock:
                    self.consumer_counts[_cid] += 1

            sess = self.broker.connect(cid, deliver)
            self.broker.deliver_pending(sess)  # in-process: ready at once
            for filt in filters:
                self.broker.subscribe(cid, filt)
            consumers.append(cid)
        return consumers

    def run(self, payload_encoding: str = "json") -> Dict[str, int]:
        """Execute all stages; returns summary counters."""
        self._attach_consumers()
        published = 0
        for stage in self.scenario.stages:
            for lc in stage.lifecycles:
                cg = self.scenario.client_groups[lc.client_group]
                if lc.publish is None:
                    if lc.connect:
                        self._m_conn.inc(cg.count)
                    continue
                tg = self.scenario.topic_groups[lc.publish.topic_group]
                gen = FleetGenerator(FleetScenario(
                    num_cars=cg.count,
                    msgs_per_car=lc.publish.count,
                    interval_s=1.0 / max(lc.publish.rate_per_s, 1e-9),
                    ramp_up_s=lc.ramp_up_s, seed=self.seed))
                clients = [self._make_client(expand_pattern(cg.pattern, i),
                                             cg.mqtt_version)
                           for i in range(cg.count)]
                self._m_conn.inc(cg.count)
                # agents wrap around the topic group's declared size — a
                # client group larger than the topic group must not invent
                # topics its subscribers never declared
                topics = [expand_pattern(tg.pattern, i % tg.count)
                          for i in range(cg.count)]
                for tick in range(lc.publish.count):
                    cols = gen.step_columns()
                    for i, client in enumerate(clients):
                        rec = gen.row_record(cols, i, schema=CAR_SCHEMA)
                        rec["failure_occurred"] = \
                            str(cols["failure_occurred"][i])
                        client.publish(topics[i], json.dumps(rec).encode(),
                                       qos=lc.publish.qos)
                        published += 1
                        self._m_pub_ok.inc()
                    if self.time_scale > 0:
                        time.sleep(gen.scenario.interval_s * self.time_scale)
                # quiesce: qos-0 over TCP is fire-and-forget, so drain each
                # connection with a ping round-trip (in-order processing
                # makes PINGRESP a fan-out barrier) before counting/closing
                if self.transport == "tcp":
                    for client in clients:
                        client.ping()
                if lc.disconnect:
                    for client in clients:
                        client.disconnect()
        out = {"published": published}
        out.update(self.consumer_counts)
        return out
