"""Schema registry: Confluent Schema Registry semantics, in-process
(``iotml.stream.registry``'s copy).

KSQL's AVRO streams register their value schemas, and the reference's
offline fixture registers ``cardata-v1.avsc`` with a REST POST to
``/subjects/<subject>-value/versions`` (reference
``testdata/Test-Load-csv/register_schema.py:20-31``).  The 5-byte frame
every consumer strips (``ops.framing``) carries an id from this registry.

Subjects hold versioned schemas; registering is idempotent by schema
fingerprint (an identical schema keeps its id); ids are global and
increase, and stop below ``RESERVED_ID_BASE``, the band of the evolved
writer schemas; lookups go by id, by subject version or by latest.
``subject_for_topic`` is Confluent's ``TopicNameStrategy``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Dict, List, Optional, Tuple

from ..core.schema import RESERVED_ID_BASE, Field, RecordSchema


def parse_avsc(avsc: str) -> RecordSchema:
    """Build a RecordSchema from Avro schema JSON (inverse of
    RecordSchema.avro_json). Handles ["null", T] unions as nullable fields
    — the shape of the reference's KSQL-derived schema
    (AUTOENCODER.../cardata-v1.avsc:5-158)."""
    doc = json.loads(avsc)
    if doc.get("type") != "record":
        raise ValueError(f"only record schemas supported, got {doc.get('type')}")
    fields = []
    for f in doc.get("fields", []):
        t = f["type"]
        nullable = False
        if isinstance(t, list):
            non_null = [x for x in t if x != "null"]
            if len(non_null) != 1 or not isinstance(non_null[0], str):
                raise ValueError(f"unsupported union type {t!r} in {f['name']}")
            nullable = "null" in t
            t = non_null[0]
        if not isinstance(t, str):
            raise ValueError(f"unsupported complex type in field {f['name']}")
        fields.append(Field(name=f["name"], avro_type=t, nullable=nullable,
                            doc=f.get("doc", "")))
    # a trailing string field named like a label is the anomaly label in
    # both reference schema variants (failure_occurred / FAILURE_OCCURRED)
    label = next((f.name for f in fields
                  if f.name.lower() == "failure_occurred"), None)
    return RecordSchema(name=doc.get("name", "record"),
                        namespace=doc.get("namespace", ""),
                        fields=tuple(fields), label_field=label)


def fingerprint(avsc: str) -> str:
    """Canonical-ish fingerprint: whitespace-normalized schema JSON SHA256."""
    canon = json.dumps(json.loads(avsc), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def subject_for_topic(topic: str, is_key: bool = False) -> str:
    """Confluent TopicNameStrategy: '<topic>-value' / '<topic>-key'."""
    return f"{topic}-{'key' if is_key else 'value'}"


@dataclasses.dataclass(frozen=True)
class RegisteredSchema:
    schema_id: int
    subject: str
    version: int
    avsc: str

    @property
    def record_schema(self) -> RecordSchema:
        return parse_avsc(self.avsc)


class SchemaRegistry:
    """Subjects → versioned schemas with global ids (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next_id = 1
        self._by_id: Dict[int, RegisteredSchema] = {}
        self._subjects: Dict[str, List[RegisteredSchema]] = {}
        self._fp_to_id: Dict[str, int] = {}

    # -------------------------------------------------------------- write
    def register(self, subject: str, avsc: str) -> int:
        """POST /subjects/<subject>/versions equivalent; returns the id.

        Idempotent: an identical schema (by fingerprint) reuses its global
        id; registering it under a new subject adds a version entry there.
        """
        json.loads(avsc)  # syntax check up front, like the REST API's 422
        fp = fingerprint(avsc)
        with self._lock:
            sid = self._fp_to_id.get(fp)
            versions = self._subjects.setdefault(subject, [])
            if sid is not None:
                for rs in versions:
                    if rs.schema_id == sid:
                        return sid
            else:
                sid = self._next_id
                if sid >= RESERVED_ID_BASE:
                    raise RuntimeError(
                        f"schema id space exhausted at the reserved "
                        f"band ({RESERVED_ID_BASE}): this registry "
                        f"allocated {sid - 1} distinct schemas")
                self._next_id += 1
                self._fp_to_id[fp] = sid
            rs = RegisteredSchema(schema_id=sid, subject=subject,
                                  version=len(versions) + 1, avsc=avsc)
            versions.append(rs)
            self._by_id.setdefault(sid, rs)
            return sid

    def register_record_schema(self, topic: str, schema: RecordSchema) -> int:
        return self.register(subject_for_topic(topic), schema.avro_json())

    # --------------------------------------------------------------- read
    def by_id(self, schema_id: int) -> RegisteredSchema:
        """GET /schemas/ids/<id> equivalent."""
        with self._lock:
            try:
                return self._by_id[schema_id]
            except KeyError:
                raise KeyError(f"schema id {schema_id} not registered") from None

    def latest(self, subject: str) -> RegisteredSchema:
        """GET /subjects/<subject>/versions/latest equivalent."""
        with self._lock:
            versions = self._subjects.get(subject)
            if not versions:
                raise KeyError(f"subject {subject!r} not found")
            return versions[-1]

    def version(self, subject: str, version: int) -> RegisteredSchema:
        with self._lock:
            versions = self._subjects.get(subject, [])
            for rs in versions:
                if rs.version == version:
                    return rs
            raise KeyError(f"{subject!r} has no version {version}")

    def subjects(self) -> List[str]:
        with self._lock:
            return sorted(self._subjects)

    def check(self, subject: str, avsc: str) -> Optional[int]:
        """Is this exact schema already registered under subject? → id/None
        (the REST API's POST /subjects/<subject> lookup)."""
        fp = fingerprint(avsc)
        with self._lock:
            sid = self._fp_to_id.get(fp)
            if sid is None:
                return None
            if any(rs.schema_id == sid for rs in self._subjects.get(subject, [])):
                return sid
            return None
