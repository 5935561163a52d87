"""Synthetic e2e canaries: black-box truth beside the white-box gauges
(``iotml.obs.canary``'s copy).

The white-box telemetry measures the pipeline from the inside; it cannot
notice the failure mode where every stage looks healthy but records stop
flowing end to end.  `CanaryProbe` closes that
gap the way a hosted monitoring stack's synthetic checks would — except
through the REAL path, not a parallel one:

    probe ──publish──> MQTT broker ──bridge──> sensor-data
          ──JsonToAvro──> SENSOR_DATA_S_AVRO ──probe's own consumer

Each probe is a schema-valid sensor record for a RESERVED car id
(``canary-<seq>``), published to ``vehicles/sensor/data/canary-<seq>``
so the production topic-mapping forwards it like any fleet record.  The
record key on the ML input topic is the MQTT topic (bridge contract),
so the probe's consumer — its own group, its own cursor — recognises
its records by the ``/canary-`` key marker and closes the loop:

- **e2e latency** comes from the record's trace span when tracing is armed
  (the context is born inside ``MqttBroker.publish``; its ``wall0_ns``
  rides the record headers through bridge and converter), with the
  probe's own send clock as the untraced fallback;
- **delivery success** is the fraction of probes observed before the
  timeout — probes never acked are counted ``lost``.

Both are metric families (`iotml_canary_e2e_seconds` buckets for a
latency SLO; `iotml_canary_probes_total{outcome=}` for the availability
ratio; ``default_slo_rules`` states the pair, which ``obs.slo`` evaluates
over ``obs.tsdb``).  Scoring pipelines exclude the
reserved ids (`SensorBatches(exclude_key_marker=CANARY_KEY_MARKER)`), so
canary records NEVER reach user-facing prediction topics.

``loop(unit)`` needs only ``unit.should_stop()`` and ``unit.heartbeat()``:
it runs as a ``supervise.supervisor`` unit, or under any driver of that
shape.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..core.schema import CAR_SCHEMA
from ..gen.simulator import FleetGenerator, FleetScenario
from ..stream.consumer import StreamConsumer
from . import metrics as _metrics
from . import tracing

#: reserved car-id namespace — generator car ids are
#: ``electric-vehicle-<n>``, so the prefix cannot collide with fleet
#: traffic, and every stage that must skip canaries keys off it
CANARY_CAR_PREFIX = "canary-"
#: the marker as it appears in bridged record KEYS (key = MQTT topic,
#: ``vehicles/sensor/data/<car-id>``)
CANARY_KEY_MARKER = b"/" + CANARY_CAR_PREFIX.encode()

canary_probes = _metrics.default_registry.counter(
    "iotml_canary_probes_total",
    "synthetic canary probes by outcome (sent | ok | lost)")
canary_e2e = _metrics.default_registry.histogram(
    "iotml_canary_e2e_seconds",
    "measured MQTT->bridge->converter end-to-end latency of canary "
    "probes (trace-span wall clock when tracing is armed)",
    buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5, 5.0, 10.0))
canary_inflight = _metrics.default_registry.gauge(
    "iotml_canary_inflight", "canary probes sent and not yet observed")


def is_canary_key(key: Optional[bytes]) -> bool:
    return bool(key) and CANARY_KEY_MARKER in key


class CanaryProbe:
    """Inject tracer records through the real ingest path and measure
    their round trip.  Drive it either as a loop unit (``loop(unit)``)
    or manually (``probe_once()`` + ``observe()``) from a drill."""

    def __init__(self, mqtt, stream, topic: str = "SENSOR_DATA_S_AVRO",
                 interval_s: float = 1.0, timeout_s: float = 5.0,
                 group: str = "canary-probe", qos: int = 1,
                 observe_interval_s: float = 0.02):
        self.mqtt = mqtt
        self.stream = stream
        self.topic = topic
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.observe_interval_s = observe_interval_s
        self.qos = qos
        self._seq = 0
        self._lock = threading.Lock()
        #: seq -> wall-clock ns at publish
        self._inflight: Dict[int, int] = {}
        self._sent = self._ok = self._lost = 0
        self._trace_sourced = 0
        self._last_e2e_s: Optional[float] = None
        # one simulated car supplies schema-valid sensor physics; the
        # probe only swaps the identity for the reserved namespace
        self._gen = FleetGenerator(FleetScenario(num_cars=1, seed=1097))
        self._car0 = np.array([0])
        # the probe tails NEW records only: canaries published before
        # this probe existed belong to a previous incarnation
        n_parts = stream.topic(topic).partitions \
            if topic in stream.topics() else 1
        stream.create_topic(topic, partitions=n_parts)
        self.consumer = StreamConsumer(
            stream,
            [f"{topic}:{p}:{stream.end_offset(topic, p)}"
             for p in range(n_parts)],
            group=group, eof=True)

    # ------------------------------------------------------------ send
    def probe_once(self) -> int:
        """Publish one canary record; returns its sequence number."""
        cols = self._gen.step_columns(self._car0)
        rec = self._gen.row_record(cols, 0, CAR_SCHEMA)
        rec["failure_occurred"] = "false"  # canaries are healthy cars
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._inflight[seq] = time.time_ns()  # wallclock-ok: e2e latency is a wall-clock quantity (trace wall0 domain)
            self._sent += 1
            canary_inflight.set(len(self._inflight))
        car = f"{CANARY_CAR_PREFIX}{seq:08d}"
        canary_probes.inc(outcome="sent")
        self.mqtt.publish(f"vehicles/sensor/data/{car}",
                          json.dumps(rec).encode(), qos=self.qos)
        return seq

    # --------------------------------------------------------- observe
    def observe(self) -> int:
        """Drain the ML input topic for canary arrivals; time out the
        stragglers.  Returns how many probes completed this pass."""
        done = 0
        while True:
            msgs = self.consumer.poll(1024)
            if not msgs:
                break
            now_ns = time.time_ns()  # wallclock-ok: e2e span close
            for m in msgs:
                if not is_canary_key(m.key):
                    continue
                seq = self._seq_of(m.key)
                with self._lock:
                    sent_ns = self._inflight.pop(seq, None) \
                        if seq is not None else None
                if sent_ns is None:
                    continue  # duplicate delivery or foreign probe
                # trace-span truth when the header survived the hops;
                # the probe's own clock otherwise
                ctx = tracing.from_headers(m.headers) if m.headers \
                    else None
                t0_ns = ctx.wall0_ns if ctx is not None else sent_ns
                e2e_s = max(now_ns - t0_ns, 0) / 1e9
                canary_e2e.observe(e2e_s)
                canary_probes.inc(outcome="ok")
                with self._lock:
                    self._ok += 1
                    if ctx is not None:
                        self._trace_sourced += 1
                    self._last_e2e_s = e2e_s
                done += 1
        self.consumer.commit()
        self._expire()
        canary_inflight.set(len(self._inflight))
        return done

    def _seq_of(self, key: bytes) -> Optional[int]:
        i = key.rfind(CANARY_KEY_MARKER)
        try:
            return int(key[i + len(CANARY_KEY_MARKER):])
        except ValueError:
            return None

    def _expire(self) -> None:
        deadline = time.time_ns() - int(self.timeout_s * 1e9)
        # wallclock-ok: probe timeout compares publish wall stamps
        with self._lock:
            dead = [s for s, t in self._inflight.items() if t < deadline]
            for s in dead:
                del self._inflight[s]
                self._lost += 1
        for _ in dead:
            canary_probes.inc(outcome="lost")

    # ------------------------------------------------------------ unit
    def loop(self, unit) -> None:
        """Loop-unit body: probe on ``interval_s``, observe on the
        much tighter ``observe_interval_s`` — the observe pass is what
        closes the e2e clock, so ITS cadence (not the probe interval)
        sets the floor of the measured latency."""
        next_probe = time.monotonic()
        while not unit.should_stop():
            try:
                if time.monotonic() >= next_probe:
                    self.probe_once()
                    next_probe = time.monotonic() + self.interval_s
                self.observe()
            except (ConnectionError, OSError):
                time.sleep(0.05)  # broker failover: next pass retries
                continue
            unit.heartbeat()
            time.sleep(self.observe_interval_s)

    # ---------------------------------------------------------- report
    def report(self) -> dict:
        with self._lock:
            return {"sent": self._sent, "ok": self._ok,
                    "lost": self._lost,
                    "trace_sourced": self._trace_sourced,
                    "inflight": len(self._inflight),
                    "last_e2e_s": self._last_e2e_s}


def default_slo_rules(window_scale: float = 1.0) -> List[dict]:
    """The canary-backed SLO pair every deployment starts from — e2e
    latency from the probe histogram, delivery from the outcome
    counters."""
    return [
        {"name": "canary-e2e-latency", "objective": 0.99,
         "indicator": {"kind": "latency",
                       "metric": "iotml_canary_e2e_seconds",
                       "threshold_s": 0.25},
         "window_scale": window_scale},
        {"name": "canary-delivery", "objective": 0.999,
         "indicator": {"kind": "ratio",
                       "bad": "iotml_canary_probes_total",
                       "total": "iotml_canary_probes_total",
                       "bad_matchers": {"outcome": "lost"},
                       "total_matchers": {"outcome": "sent"}},
         "window_scale": window_scale},
    ]
