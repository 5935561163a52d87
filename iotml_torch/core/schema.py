"""The car-sensor field table (a copy of ``iotml.core.schema``'s).

One table of 18 sensor fields, with each field's producer-schema type
and the reference's normalization range, and the two record schemas
derived from it: the producer schema (lower_snake_case) and the
KSQL-derived schema the ML layer consumes (UPPER_CASE, nullable, plus
the ``FAILURE_OCCURRED`` label), and the evolved writer schema v2 with
its frame id; and each schema's Avro JSON (what a schema registry
holds).  The CSV layout is not ported.
"""

from __future__ import annotations

import dataclasses
import json
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

    def avro_json(self) -> dict:
        """The field's entry in an Avro record schema."""
        t = [self.avro_type] if not self.nullable else ["null", self.avro_type]
        out = {"name": self.name, "type": t[0] if len(t) == 1 else t}
        if self.nullable:
            out["default"] = None
        if self.doc:
            out["doc"] = self.doc
        return out


@dataclasses.dataclass(frozen=True)
class RecordSchema:
    """A record schema: fields, the label field and non-sensor fields."""

    name: str
    namespace: str
    fields: tuple  # tuple[Field, ...]
    label_field: Optional[str] = None
    meta_fields: tuple = ()

    def avro_json(self) -> str:
        """The record's Avro schema JSON, byte-identical to
        ``iotml.core.schema``'s."""
        return json.dumps(
            {
                "type": "record",
                "name": self.name,
                "namespace": self.namespace,
                "fields": [f.avro_json() for f in self.fields],
            },
            indent=2,
        )

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

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

# Writer-schema v2: the evolution a live fleet produces mid-upgrade — a
# new optional field (REGION) with a null default, emitted BEFORE the
# label KSQL appends last.  A v1 reader decoding v2 bytes positionally
# would read REGION's union branch as the label; ``ops.avro
# .ResolvingCodec`` resolves by name instead.  v2 is a WRITER schema:
# the ML layer reads through the v1 projection, so REGION never reaches
# the model input.
KSQL_CAR_SCHEMA_V2 = RecordSchema(
    name="KsqlDataSourceSchema",
    namespace="io.confluent.ksql.avro_schemas",
    fields=tuple(
        list(KSQL_CAR_SCHEMA.fields[:-1])
        + [Field("REGION", "string", nullable=True,
                 doc="fleet cohort region (added in writer schema v2)"),
           Field("FAILURE_OCCURRED", "string", nullable=True)]
    ),
    label_field="FAILURE_OCCURRED",
    meta_fields=("REGION",),
)

#: ids at and above this are the band of framework-pinned evolved writer
#: schemas, which a schema registry never allocates into (its ids start at
#: 1): the native client's fused decode stops at a frame in this band
RESERVED_ID_BASE = 1000
#: the evolved writer's frame id, in that band
CAR_SCHEMA_V2_ID = 1002

#: Confluent-frame schema id → writer schema, for readers resolving a
#: mixed-version topic
WRITER_SCHEMAS = {1: KSQL_CAR_SCHEMA, CAR_SCHEMA_V2_ID: KSQL_CAR_SCHEMA_V2}

#: writer version → (schema, frame id)
WRITER_VERSIONS = {1: (KSQL_CAR_SCHEMA, 1),
                   2: (KSQL_CAR_SCHEMA_V2, CAR_SCHEMA_V2_ID)}
