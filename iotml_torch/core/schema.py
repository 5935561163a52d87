"""The car-sensor field table (a copy of ``iotml.core.schema``'s).

One table of 18 sensor fields, with each field's producer-schema type
and the reference's normalization range, and the two record schemas
derived from it: the producer schema (lower_snake_case) and the
KSQL-derived schema the ML layer consumes (UPPER_CASE, nullable, plus
the ``FAILURE_OCCURRED`` label).  The Avro JSON, the evolved writer
schemas and the CSV layout are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: numpy dtype of each Avro primitive's decoded column
_AVRO_NP = {
    "float": np.float32,
    "double": np.float64,
    "int": np.int32,
    "long": np.int64,
    "boolean": np.bool_,
    "string": object,
    "bytes": object,
}


@dataclasses.dataclass(frozen=True)
class Field:
    """One field of a record schema.

    ``norm`` is the affine normalization range (lo, hi) mapped to
    (-1, 1); ``None`` means the reference zeroes the field out.
    """

    name: str
    avro_type: str  # primitive name: float/double/int/string/...
    nullable: bool = False
    doc: str = ""
    norm: Optional[tuple] = None

    @property
    def np_dtype(self):
        return _AVRO_NP[self.avro_type]


@dataclasses.dataclass(frozen=True)
class RecordSchema:
    """A record schema: fields, the label field and non-sensor fields."""

    name: str
    namespace: str
    fields: tuple  # tuple[Field, ...]
    label_field: Optional[str] = None
    meta_fields: tuple = ()

    @property
    def sensor_fields(self):
        """Fields that feed the model (all but the label and meta)."""
        return tuple(f for f in self.fields
                     if f.name != self.label_field
                     and f.name not in self.meta_fields)

    @property
    def num_sensors(self) -> int:
        return len(self.sensor_fields)


def _ksql_name(name: str) -> str:
    """KSQL column naming: upper-case, single-digit parts collapsed
    (``tire_pressure_1_1`` → ``TIRE_PRESSURE11``)."""
    parts = name.split("_")
    out, digits = [], []
    for p in parts:
        if len(p) == 1 and p.isdigit():
            digits.append(p)
        else:
            if digits:
                out[-1] = out[-1] + "".join(digits)
                digits = []
            out.append(p)
    if digits:
        out[-1] = out[-1] + "".join(digits)
    return "_".join(out).upper()


# 18 sensor fields in producer order; norm=None ⇒ zeroed (reference TODO).
SENSOR_FIELDS = (
    Field("coolant_temp", "float", doc="battery/engine coolant temperature in degC", norm=None),
    Field("intake_air_temp", "float", doc="air intake temperature in degC", norm=(15.0, 40.0)),
    Field("intake_air_flow_speed", "float", doc="air intake mass g/s", norm=None),
    Field("battery_percentage", "float", doc="battery cell total percentage left", norm=(0.0, 100.0)),
    Field("battery_voltage", "float", doc="battery pack voltage in mV", norm=None),
    Field("current_draw", "float", doc="current in A drawn from the battery", norm=None),
    Field("speed", "float", doc="vehicle speed in m/s", norm=(0.0, 50.0)),
    Field("engine_vibration_amplitude", "float", doc="engine vibration in mV", norm=(0.0, 7500.0)),
    Field("throttle_pos", "float", doc="throttle position [0..1]", norm=(0.0, 1.0)),
    Field("tire_pressure_1_1", "int", doc="tire pressure psi front left", norm=(20.0, 35.0)),
    Field("tire_pressure_1_2", "int", doc="tire pressure psi front right", norm=(20.0, 35.0)),
    Field("tire_pressure_2_1", "int", doc="tire pressure psi back left", norm=(20.0, 35.0)),
    Field("tire_pressure_2_2", "int", doc="tire pressure psi back right", norm=(20.0, 35.0)),
    Field("accelerometer_1_1_value", "float", doc="accel m/s^2 front left", norm=(0.0, 7.0)),
    Field("accelerometer_1_2_value", "float", doc="accel m/s^2 front right", norm=(0.0, 7.0)),
    Field("accelerometer_2_1_value", "float", doc="accel m/s^2 back left", norm=(0.0, 7.0)),
    Field("accelerometer_2_2_value", "float", doc="accel m/s^2 back right", norm=(0.0, 7.0)),
    Field("control_unit_firmware", "int", doc="firmware version [1000|2000]", norm=(1000.0, 2000.0)),
)

# Producer-side schema: what devices publish (18 required fields).
CAR_SCHEMA = RecordSchema(
    name="CarData",
    namespace="com.hivemq.avro",
    fields=SENSOR_FIELDS,
)

# KSQL-derived schema: what the ML layer consumes (nullable upper-case
# fields, floats widened to double, label appended).
KSQL_CAR_SCHEMA = RecordSchema(
    name="KsqlDataSourceSchema",
    namespace="io.confluent.ksql.avro_schemas",
    fields=tuple(
        [
            Field(
                _ksql_name(f.name),
                "double" if f.avro_type == "float" else f.avro_type,
                nullable=True,
                norm=f.norm,
            )
            for f in SENSOR_FIELDS
        ]
        + [Field("FAILURE_OCCURRED", "string", nullable=True)]
    ),
    label_field="FAILURE_OCCURRED",
)
