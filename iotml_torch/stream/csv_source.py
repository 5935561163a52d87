"""CSV replay source, the FileStreamSource connector's equivalent
(``iotml.stream.csv_source``'s copy).

The reference replays ``testdata/car-sensor-data.csv`` into a topic with
a Kafka Connect FileStreamSource and a KSQL DELIMITED→AVRO conversion
(reference ``testdata/Test-Load-csv/``).  Here the fixture is one
function: read the CSV, encode each row in the requested schema (JSON
for the raw ``sensor-data`` stage, Confluent-framed Avro for the KSQL
output stage) and append it to a broker topic keyed by car id.
"""

from __future__ import annotations

import csv
import json
from typing import Optional

from ..core.schema import CAR_SCHEMA, KSQL_CAR_SCHEMA, RecordSchema
from ..ops.avro import AvroCodec
from ..ops.framing import frame


def _row_to_record(row: dict, schema: RecordSchema, label: str):
    """Map a CSV row (producer-schema lower_snake_case names) onto `schema`,
    tolerating the KSQL variant's renamed upper-case fields."""
    by_lower = {}
    for f in CAR_SCHEMA.fields:
        by_lower[f.name] = row[f.name]
    rec = {}
    for f in schema.fields:
        if schema.label_field and f.name == schema.label_field:
            rec[f.name] = label
            continue
        # KSQL upper-case names map back positionally: schemas share order.
        src = CAR_SCHEMA.fields[
            [x.name for x in schema.sensor_fields].index(f.name)
        ].name if f.name not in by_lower else f.name
        v = by_lower[src]
        rec[f.name] = int(float(v)) if f.avro_type in ("int", "long") else float(v)
    return rec


def replay_csv(broker, topic: str, csv_path: str,
               schema: RecordSchema = KSQL_CAR_SCHEMA,
               encoding: str = "avro", label: str = "false",
               limit: Optional[int] = None, partitions: int = 1) -> int:
    """Replay a car-sensor CSV into `topic`. Returns the record count.

    encoding="avro": Confluent-framed Avro (what the ML layer consumes).
    encoding="json": raw JSON (what lands on `sensor-data` pre-KSQL).
    """
    broker.create_topic(topic, partitions=partitions)
    codec = AvroCodec(schema)
    n = 0
    with open(csv_path, newline="") as fh:
        for row in csv.DictReader(fh):
            rec = _row_to_record(row, schema, label=label)
            if encoding == "avro":
                payload = frame(codec.encode(rec))
            else:
                payload = json.dumps(rec).encode()
            key = row.get("car", "").encode() or None
            ts = int(float(row.get("time", 0)) * 1000)
            broker.produce(topic, payload, key=key,
                           partition=None if partitions > 1 else 0,
                           timestamp_ms=ts)
            n += 1
            if limit and n >= limit:
                break
    return n
