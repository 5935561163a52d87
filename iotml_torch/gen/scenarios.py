"""Adversarial fleet conditions (``iotml.gen.scenarios``'s twin).

``simulator.FleetGenerator`` reproduces the reference's benign scenario:
a steady fleet, i.i.d. sensor noise, rare labeled failures.  Real fleets
are nastier in ways that stress specific subsystems, and each condition
here targets one:

- **rush-hour**: 10× publish bursts inside a tick window;
- **flapping-links**: per-car cellular links drop and recover; a car
  whose link is down stores its readings and forwards them when it is
  back (the MQTT leg, ``publish_mqtt``);
- **regional-drift**: cars belong to regional cohorts with skewed sensor
  distributions, and selected cohorts SHIFT distribution at a seeded
  tick (step or ramp) — the benign drift that poisons a frozen anomaly
  detector with false positives until ``iotml_torch.online`` adapts;
- **schema-mix**: a fraction of the fleet publishes writer-schema v2
  (REGION field, ``core.schema.KSQL_CAR_SCHEMA_V2``) onto the same live
  topic — the rolling-upgrade mix v1 readers must resolve;
- **drift-storm**: regional drift on every cohort at once.

Everything is seeded and wall-clock-free: the same (scenario, condition,
seed) triple publishes the same records (keys, framed values,
timestamps, partitions) as the JAX package's, byte for byte.

Two publish legs: ``publish_stream`` writes framed Avro straight onto a
stream topic, ``publish_mqtt`` writes each car's JSON to an MQTT broker
with link flaps, store-and-forward, and deferral into a bounded buffer
while the broker reports ``saturated()``; the chaos runner's
``drift-storm`` drives the MQTT leg under its flap schedule.  Under
tracing each record of the stream leg is born with its trace context in
its headers (the MQTT leg's are born in ``MqttBroker.publish``).
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from ..core.schema import (CAR_SCHEMA, CAR_SCHEMA_V2_ID, KSQL_CAR_SCHEMA,
                           KSQL_CAR_SCHEMA_V2)
from ..obs import metrics as obs_metrics
from ..obs import tracing
from ..ops.avro import AvroCodec
from ..ops.framing import frame
from .simulator import FleetGenerator, FleetScenario


@dataclasses.dataclass(frozen=True)
class FleetCondition:
    """One adversarial condition over a base fleet scenario."""

    name: str
    description: str = ""
    #: [start, end) tick window publishing at burst_multiplier× rate
    burst_ticks: Optional[tuple] = None
    burst_multiplier: int = 10
    #: per-car per-tick P(link goes down) / P(down link recovers)
    flap_down: float = 0.0
    flap_up: float = 0.5
    #: regional cohorts (car i belongs to cohort i % regions)
    regions: int = 1
    #: static cohort skew: cohorts sit at slightly different operating
    #: points (scale of the per-region offset vector)
    region_skew: float = 0.0
    #: seeded distribution shift: at drift_tick the cohorts in
    #: drift_regions (None = all) move their operating point by
    #: drift_scale, as a step (ramp_ticks=0) or linear ramp
    drift_tick: Optional[int] = None
    drift_regions: Optional[tuple] = None
    drift_scale: float = 1.0
    drift_ramp_ticks: int = 0
    #: fraction of records encoded under writer schema v2
    schema_v2_fraction: float = 0.0


#: the scenario suite by name
FLEET_CONDITIONS: Dict[str, FleetCondition] = {
    "baseline": FleetCondition(
        "baseline", "the reference's benign fleet, unmodified"),
    "rush-hour": FleetCondition(
        "rush-hour",
        "10x publish burst in a tick window; agents must respect the "
        "MQTT backpressure signal instead of overrunning queues",
        burst_ticks=(4, 8), burst_multiplier=10),
    "flapping-links": FleetCondition(
        "flapping-links",
        "per-car cellular links flap (seeded Markov chain); down cars "
        "store-and-forward on recovery",
        flap_down=0.08, flap_up=0.35),
    "regional-drift": FleetCondition(
        "regional-drift",
        "4 regional cohorts at skewed operating points; three cohorts "
        "step-shift their distribution mid-stream (benign drift: "
        "labels stay normal, reconstruction error does not)",
        regions=4, region_skew=0.3, drift_regions=(1, 2, 3),
        drift_scale=1.0),
    "schema-mix": FleetCondition(
        "schema-mix",
        "40% of the fleet publishes writer-schema v2 (REGION field) "
        "onto the live topic; v1 readers resolve instead of DLQ",
        regions=2, schema_v2_fraction=0.4),
    "drift-storm": FleetCondition(
        "drift-storm",
        "every cohort shifts at once — run under the chaos mqtt-flap "
        "schedule for drift + infrastructure failure concurrently",
        regions=4, region_skew=0.2, drift_scale=1.5),
}


def condition(name: str, **overrides) -> FleetCondition:
    """Look up a suite condition, optionally overriding knobs (e.g.
    ``condition("regional-drift", drift_tick=40)``)."""
    if name not in FLEET_CONDITIONS:
        raise KeyError(f"unknown fleet condition {name!r} "
                       f"(have: {sorted(FLEET_CONDITIONS)})")
    base = FLEET_CONDITIONS[name]
    return dataclasses.replace(base, **overrides) if overrides else base


#: (column, per-unit offset) the cohort skew/drift vector moves — the
#: "harsh-terrain cohort" shape.  Asymmetric tire-pressure shifts break
#: the learned structure (a dense autoencoder reconstructs a pure
#: translation of its training distribution almost as well as the
#: original), and the vector stays orthogonal to the injected failure
#: signatures: vibration (failure mode 0) and tire_pressure_1_1 (mode 1)
#: are untouched, so drifted-normal rows never overlap failure rows.
#: Labels stay "false": this is drift, not failure.
_DRIFT_COLUMNS = (
    ("speed", 8.0),
    ("coolant_temp", 10.0),
    ("intake_air_temp", 6.0),
    ("battery_voltage", -14.0),
    ("throttle_pos", 0.12),
    ("tire_pressure_1_2", -8.0),
    ("tire_pressure_2_1", -10.0),
    ("tire_pressure_2_2", 8.0),
)
_CLIPS = {"speed": (0.0, 50.0), "throttle_pos": (0.0, 1.0)}


class AdversarialFleet:
    """A FleetGenerator driven through a FleetCondition.

    The base generator's RNG stream is untouched (the same seed produces
    the same underlying fleet with or without a condition); condition
    draws — flaps, schema choice — come from a separate seeded RNG, so
    conditions compose deterministically.
    """

    def __init__(self, scenario: Optional[FleetScenario] = None,
                 cond: Optional[FleetCondition] = None,
                 defer_limit: int = 10_000):
        self.scenario = scenario or FleetScenario()
        self.cond = cond or FLEET_CONDITIONS["baseline"]
        self.gen = FleetGenerator(self.scenario)
        self.rng = np.random.default_rng(self.scenario.seed + 0x5EED)
        n = self.scenario.num_cars
        self.region = np.arange(n) % max(1, self.cond.regions)
        self.link_up = np.ones(n, bool)
        #: per-car store-and-forward buffers for down links (bounded)
        self._car_buffers: Dict[int, collections.deque] = {}
        #: fleet-side deferral buffer under MQTT backpressure (bounded:
        #: a fleet cannot hold infinite history either — past the limit
        #: the OLDEST deferred reading drops, counted)
        self.deferred: collections.deque = collections.deque(
            maxlen=max(1, defer_limit))
        self.deferred_total = 0
        self.defer_dropped = 0
        self.flap_buffered_total = 0
        self.published = 0

    # -------------------------------------------------------- generation
    def _tick_reps(self) -> int:
        c = self.cond
        if c.burst_ticks is None:
            return 1
        lo, hi = c.burst_ticks
        return c.burst_multiplier if lo <= self.gen.tick < hi else 1

    def _drift_amount(self) -> float:
        c = self.cond
        if c.drift_tick is None or self.gen.tick < c.drift_tick:
            return 0.0
        if c.drift_ramp_ticks <= 0:
            return c.drift_scale
        frac = (self.gen.tick - c.drift_tick) / c.drift_ramp_ticks
        return c.drift_scale * min(1.0, frac)

    def step_columns(self) -> dict:
        """One fleet tick with cohort skew + active drift applied."""
        # _drift_amount reads gen.tick BEFORE step_columns advances it,
        # so "drift at tick K" means the K-th emitted tick is shifted
        amount = self._drift_amount()
        cols = self.gen.step_columns()
        c = self.cond
        if c.regions <= 1 or (c.region_skew == 0.0 and amount == 0.0):
            return cols
        reg = self.region[cols["car"]]
        # static skew: cohorts spread symmetrically around the fleet
        # mean; drift: the selected cohorts move by `amount` more
        spread = (reg - (c.regions - 1) / 2.0) / max(c.regions - 1, 1)
        shift = spread * c.region_skew
        if amount:
            in_drift = np.ones(len(reg), bool) if c.drift_regions is None \
                else np.isin(reg, c.drift_regions)
            shift = shift + in_drift * amount
        for col, per_unit in _DRIFT_COLUMNS:
            vals = cols[col].astype(np.float64) + shift * per_unit
            if col in _CLIPS:
                vals = np.clip(vals, *_CLIPS[col])
            cols[col] = vals.astype(cols[col].dtype)
        return cols

    def region_name(self, car: int) -> str:
        return f"region-{self.region[car]}"

    # ------------------------------------------------------ stream (avro)
    def publish_stream(self, broker, topic: str, n_ticks: int = 1,
                       partitions: int = 1) -> int:
        """Framed-Avro publish straight onto a stream topic (the
        broker-direct ingest leg), with burst multiplication and the
        schema-version mix.  v2 records carry the car's REGION."""
        broker.create_topic(topic, partitions=partitions)
        codec_v1 = AvroCodec(KSQL_CAR_SCHEMA)
        codec_v2 = AvroCodec(KSQL_CAR_SCHEMA_V2)
        count = 0
        for _ in range(n_ticks):
            for _ in range(self._tick_reps()):
                cols = self.step_columns()
                n = len(cols["car"])
                ts = int(self.gen.t * 1000)
                v2 = self.rng.random(n) < self.cond.schema_v2_fraction
                for i in range(n):
                    car = int(cols["car"][i])
                    rec = self.gen.row_record(cols, i, KSQL_CAR_SCHEMA)
                    if v2[i]:
                        rec["REGION"] = self.region_name(car)
                        payload = frame(codec_v2.encode(rec),
                                        CAR_SCHEMA_V2_ID)
                    else:
                        payload = frame(codec_v1.encode(rec), 1)
                    hdrs = tracing.birth_headers("devsim_publish") \
                        if tracing.ENABLED else None
                    broker.produce(
                        topic, payload,
                        key=self.scenario.car_id(car).encode(),
                        partition=None if partitions > 1 else 0,
                        timestamp_ms=ts, headers=hdrs)
                    count += 1
        self.published += count
        return count

    # -------------------------------------------------------- mqtt (json)
    def _flap_step(self) -> None:
        c = self.cond
        if c.flap_down <= 0:
            return
        n = len(self.link_up)
        go_down = self.rng.random(n) < c.flap_down
        come_up = self.rng.random(n) < c.flap_up
        self.link_up = np.where(self.link_up, ~go_down, come_up)

    def _publish_one(self, mqtt, topic: str, payload: bytes,
                     qos: int) -> bool:
        """One cooperative publish: defer under backpressure instead of
        letting the broker's bounded queues drop-oldest."""
        if mqtt.saturated():
            if len(self.deferred) == self.deferred.maxlen:
                self.defer_dropped += 1
            self.deferred.append((topic, payload, qos))
            self.deferred_total += 1
            obs_metrics.fleet_deferred.inc()
            return False
        mqtt.publish(topic, payload, qos=qos)
        self.published += 1
        return True

    def _drain_deferred(self, mqtt) -> int:
        n = 0
        while self.deferred and not mqtt.saturated():
            topic, payload, qos = self.deferred.popleft()
            mqtt.publish(topic, payload, qos=qos)
            self.published += 1
            n += 1
        return n

    def publish_mqtt(self, mqtt, n_ticks: int = 1, qos: int = 1,
                     topic_prefix: str = "vehicles/sensor/data") -> int:
        """Per-car JSON publishes over MQTT (the device fleet leg) with
        link flapping (store-and-forward) and backpressure deferral.
        Returns publishes DELIVERED to the broker this call; deferred
        and link-buffered readings drain on later ticks."""
        delivered = 0
        for _ in range(n_ticks):
            for _ in range(self._tick_reps()):
                delivered += self._drain_deferred(mqtt)
                self._flap_step()
                cols = self.step_columns()
                n = len(cols["car"])
                for i in range(n):
                    car = int(cols["car"][i])
                    rec = self.gen.row_record(cols, i, CAR_SCHEMA)
                    rec["failure_occurred"] = \
                        str(cols["failure_occurred"][i])
                    if self.cond.regions > 1:
                        rec["region"] = self.region_name(car)
                    topic = f"{topic_prefix}/{self.scenario.car_id(car)}"
                    payload = json.dumps(rec).encode()
                    if not self.link_up[car]:
                        # cellular dead spot: the device stores and
                        # forwards — bounded, oldest dropped (a real
                        # device's ring buffer)
                        buf = self._car_buffers.setdefault(
                            car, collections.deque(maxlen=64))
                        buf.append((topic, payload))
                        self.flap_buffered_total += 1
                        continue
                    buf = self._car_buffers.get(car)
                    while buf:
                        t2, p2 = buf.popleft()
                        if self._publish_one(mqtt, t2, p2, qos):
                            delivered += 1
                    if self._publish_one(mqtt, topic, payload, qos):
                        delivered += 1
        return delivered

    def describe(self) -> dict:
        return {"condition": self.cond.name, "tick": self.gen.tick,
                "published": self.published,
                "deferred_total": self.deferred_total,
                "deferred_pending": len(self.deferred),
                "defer_dropped": self.defer_dropped,
                "flap_buffered": self.flap_buffered_total,
                "links_down": int((~self.link_up).sum())}
