"""Car-fleet generator (the columnar core of ``iotml.gen.simulator``).

A vectorized numpy fleet with per-car latent state and three failure
modes that perturb the relevant sensors and set the label.  It makes the
same numpy draws in the same order as the JAX package's generator, so
the same scenario yields the same columns bit for bit, and ``publish``
appends the same records (key, value, timestamp, partition) to a broker
topic: Confluent-framed Avro encoded by the native engine (the ML input
stage), or the raw JSON with producer field names and the label that
lands on ``sensor-data`` before the KSQL stage.  ``write_csv_fixture``
writes the reference's offline CSV file from the same draws.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA, RecordSchema
from ..obs import tracing
from ..stream.native import NativeCodec


@dataclasses.dataclass
class FleetScenario:
    """Scenario knobs, mirroring the reference's scenario XML."""

    num_cars: int = 25
    msgs_per_car: int = 40
    interval_s: float = 5.0
    ramp_up_s: float = 5.0
    failure_rate: float = 0.01  # fraction of cars that develop a failure
    #: (min_tick, max_tick): failing cars develop their failure at a
    #: uniform-random tick in this range; None = from birth
    failure_onset_ticks: Optional[tuple] = None
    seed: int = 7

    def car_id(self, i: int) -> str:
        """Car ``i``'s id, the message key its records carry."""
        return f"electric-vehicle-{i:05d}"


class FleetGenerator:
    """Stateful vectorized simulator over a fleet scenario."""

    def __init__(self, scenario: Optional[FleetScenario] = None):
        scenario = scenario if scenario is not None else FleetScenario()
        self.scenario = scenario
        n = scenario.num_cars
        rng = np.random.default_rng(scenario.seed)
        self.rng = rng
        # per-car latent state
        self.speed = rng.uniform(0.0, 30.0, n)
        self.battery = rng.uniform(40.0, 100.0, n)
        self.firmware = rng.choice([1000, 2000], n).astype(np.int32)
        self.tire_base = rng.uniform(28.0, 33.0, (n, 4))
        # failure state: -1 = healthy, else index of the failing mode
        self.failing = np.full(n, -1, np.int32)
        fail_cars = rng.random(n) < scenario.failure_rate
        self.failing[fail_cars] = rng.integers(0, 3, fail_cars.sum())
        self.onset = np.zeros(n, np.int64)  # onset tick (0 = from birth)
        if scenario.failure_onset_ticks is not None:
            lo, hi = scenario.failure_onset_ticks
            self.onset[fail_cars] = rng.integers(lo, hi + 1,
                                                 fail_cars.sum())
        self.tick = 0
        self.t = 0.0

    def step_columns(self, batch_cars: Optional[np.ndarray] = None) -> dict:
        """Advance one tick for the selected cars; return raw sensor
        columns (producer-schema units), 'car' ids and
        'failure_occurred' labels."""
        s = self.scenario
        idx = np.arange(s.num_cars) if batch_cars is None else batch_cars
        n = len(idx)
        rng = self.rng

        # speed: mean-reverting random walk in [0, 50] m/s
        self.speed[idx] = np.clip(
            self.speed[idx] + rng.normal(0, 2.0, n) - 0.02 * (self.speed[idx] - 20.0),
            0.0, 50.0)
        speed = self.speed[idx]
        throttle = np.clip(speed / 50.0 + rng.normal(0, 0.05, n), 0.0, 1.0)
        vibration = speed * rng.uniform(100.0, 150.0, n)
        self.battery[idx] = np.clip(self.battery[idx] - rng.uniform(0, 0.05, n), 0.0, 100.0)
        current = 5.0 + speed * 0.5 + rng.normal(0, 1.0, n)
        coolant = 20.0 + speed * 0.6 + rng.normal(0, 2.0, n)
        airflow = speed * 3.0 + rng.normal(0, 5.0, n)
        voltage = 200.0 + self.battery[idx] * 0.5 + rng.normal(0, 2.0, n)
        tires = self.tire_base[idx] + rng.normal(0, 0.5, (n, 4))
        accel = np.abs(rng.normal(0.5, 0.8, (n, 4)))

        # failure modes perturb the physics and set the label, once a
        # car's onset tick has passed
        failing = np.where(self.onset[idx] <= self.tick,
                           self.failing[idx], -1)
        lab = failing >= 0
        m0 = failing == 0  # engine failure: vibration spike
        vibration[m0] *= rng.uniform(2.0, 4.0, m0.sum())
        m1 = failing == 1  # tire blowout: one tire loses pressure
        tires[m1, 0] = rng.uniform(10.0, 18.0, m1.sum())
        m2 = failing == 2  # battery fault: voltage sag + current spike
        voltage[m2] -= rng.uniform(30.0, 60.0, m2.sum())
        current[m2] *= rng.uniform(1.5, 3.0, m2.sum())

        cols = {
            "coolant_temp": coolant.astype(np.float32),
            "intake_air_temp": rng.uniform(15.0, 40.0, n).astype(np.float32),
            "intake_air_flow_speed": np.clip(airflow, 0, None).astype(np.float32),
            "battery_percentage": self.battery[idx].astype(np.float32),
            "battery_voltage": voltage.astype(np.float32),
            "current_draw": np.clip(current, 0, None).astype(np.float32),
            "speed": speed.astype(np.float32),
            "engine_vibration_amplitude": vibration.astype(np.float32),
            "throttle_pos": throttle.astype(np.float32),
            "tire_pressure_1_1": tires[:, 0].astype(np.int32),
            "tire_pressure_1_2": tires[:, 1].astype(np.int32),
            "tire_pressure_2_1": tires[:, 2].astype(np.int32),
            "tire_pressure_2_2": tires[:, 3].astype(np.int32),
            "accelerometer_1_1_value": accel[:, 0].astype(np.float32),
            "accelerometer_1_2_value": accel[:, 1].astype(np.float32),
            "accelerometer_2_1_value": accel[:, 2].astype(np.float32),
            "accelerometer_2_2_value": accel[:, 3].astype(np.float32),
            "control_unit_firmware": self.firmware[idx],
            "car": idx,
            "failure_occurred": np.where(lab, "true", "false"),
        }
        self.t += s.interval_s
        self.tick += 1
        return cols

    def sensor_matrix(self, cols: dict) -> np.ndarray:
        """[n, 18] float64 matrix in schema order (pre-normalization)."""
        return np.stack([cols[f.name].astype(np.float64)
                         for f in CAR_SCHEMA.fields], axis=1)

    def row_record(self, cols: dict, i: int, schema: RecordSchema) -> dict:
        """Row i of a step's columns as a dict record in ``schema``'s
        naming (the per-record leg ``gen.scenarios`` encodes)."""
        rec = {}
        for f_ref, f_out in zip(CAR_SCHEMA.fields, schema.sensor_fields):
            v = cols[f_ref.name][i]
            rec[f_out.name] = int(v) if f_out.avro_type in ("int", "long") \
                else float(v)
        if schema.label_field:
            rec[schema.label_field] = str(cols["failure_occurred"][i])
        return rec

    def publish(self, broker, topic: str, n_ticks: int = 1,
                schema: RecordSchema = KSQL_CAR_SCHEMA,
                encoding: str = "avro", partitions: int = 1) -> int:
        """Append ``n_ticks`` ticks of every car to a broker topic; returns
        the record count.  ``encoding="avro"``: Confluent-framed Avro in
        ``schema``; ``"json"``: JSON with the producer's field names and
        the label (``schema`` does not apply).  Each record is keyed by
        its car id and stamped with the tick's time in ms; with several
        partitions the key picks the partition.  Under tracing each record
        is born with its trace context in its headers
        (``obs.tracing.birth_headers``)."""
        if encoding not in ("avro", "json"):
            raise ValueError(f"encoding must be 'avro' or 'json', got "
                             f"{encoding!r}")
        broker.create_topic(topic, partitions=partitions)
        codec = NativeCodec(schema) if encoding == "avro" else None
        count = 0
        for _ in range(n_ticks):
            cols = self.step_columns()
            ts = int(self.t * 1000)
            if codec is not None:
                labels = cols["failure_occurred"].astype("S16")[:, None] \
                    if schema.label_field else None
                msgs = codec.encode_batch(self.sensor_matrix(cols), labels,
                                          schema_id=1)
            else:
                msgs = [json.dumps({
                    **self.row_record(cols, i, CAR_SCHEMA),
                    "failure_occurred": str(cols["failure_occurred"][i])
                }).encode() for i in range(len(cols["car"]))]
            for car, payload in zip(cols["car"], msgs):
                # trace birth; the disabled path makes no tracing call
                hdrs = tracing.birth_headers("devsim_publish") \
                    if tracing.ENABLED else None
                broker.produce(topic, payload,
                               key=self.scenario.car_id(int(car)).encode(),
                               partition=None if partitions > 1 else 0,
                               timestamp_ms=ts, headers=hdrs)
            count += len(msgs)
        return count



def write_csv_fixture(path: str, n_rows: int = 10_000,
                      scenario: Optional[FleetScenario] = None,
                      start_time: int = 1_567_606_196) -> int:
    """Write a `car-sensor-data.csv`-shaped offline fixture.

    Header and column order match the reference's 10k-row test file
    (`testdata/car-sensor-data.csv:1`): `time,car,<18 sensor columns>`, car
    ids like `car1`, epoch-seconds timestamps.  Returns the row count.
    """
    from ..core.schema import CSV_COLUMNS

    scenario = scenario or FleetScenario(num_cars=100)
    gen = FleetGenerator(scenario)
    n = 0
    with open(path, "w") as fh:
        fh.write(",".join(CSV_COLUMNS) + "\n")
        t = start_time
        while n < n_rows:
            cols = gen.step_columns()
            for i in range(len(cols["car"])):
                if n >= n_rows:
                    break
                rec = gen.row_record(cols, i, CAR_SCHEMA)
                row = [str(t), f"car{int(cols['car'][i]) + 1}"] + [
                    str(rec[f.name]) for f in CAR_SCHEMA.fields]
                fh.write(",".join(row) + "\n")
                n += 1
            t += max(int(scenario.interval_s), 1)
    return n
