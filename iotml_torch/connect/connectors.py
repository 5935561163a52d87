"""The reference's three connectors for the in-process runtime
(``iotml.connect.connectors``'s copy).

- `FileStreamSource`: line-by-line file replay into a topic, the offline
  test fixture (reference `file_stream_demo_standalone.properties:2-8`,
  topic `car-data-csv`).  Tails the file across `poll()` calls, so appended
  lines flow like a live stream.
- `DocumentStoreSink`: the MongoDB digital-twin sink (reference
  `mongodb-connector-configmap.yaml:6-23`).  JSON values upserted by `_id`,
  with the reference's HoistField$Key SMT semantics: the record's String
  key becomes the `_id` field.  Persists as a JSON file and answers point
  lookups: one document per car, latest state wins.
- `ObjectStoreSink`: the GCS data-lake sink (reference
  `kafka-connect/gcs/README.md:21-43`).  Confluent-framed Avro messages
  are unframed and rolled into standard `.avro` Object Container Files
  named `<topic>+<partition>+<start_offset>.avro` (the GCS connector's
  object naming) under a local or mounted directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

from ..core.schema import RecordSchema
from ..ops.avro_container import ContainerWriter
from ..ops.framing import strip_frame
from ..stream.broker import Message
from .runtime import SinkConnector, SourceConnector, SourceRecord


class FileStreamSource(SourceConnector):
    """Replay/tail a text file into a topic, one line per record."""

    def __init__(self, path: str, topic: str, skip_header: bool = False,
                 batch_lines: int = 1000):
        self.path = path
        self.topic = topic
        self.skip_header = skip_header
        self.batch_lines = batch_lines
        self._pos = 0
        self._header_skipped = not skip_header

    def poll(self) -> List[SourceRecord]:
        if not os.path.exists(self.path):
            return []
        out: List[SourceRecord] = []
        with open(self.path, "rb") as fh:
            fh.seek(self._pos)
            while len(out) < self.batch_lines:
                line = fh.readline()
                if not line or not line.endswith(b"\n"):
                    break  # EOF or a partial line still being written
                self._pos = fh.tell()
                if not self._header_skipped:
                    self._header_skipped = True
                    continue
                stripped = line.rstrip(b"\r\n")
                if stripped:
                    out.append(SourceRecord(topic=self.topic, value=stripped))
        return out

    def state(self) -> dict:
        return {"pos": self._pos, "header_skipped": self._header_skipped}

    def restore(self, state: dict) -> None:
        self._pos = int(state.get("pos", 0))
        self._header_skipped = bool(state.get("header_skipped",
                                              not self.skip_header))


class HoistFieldKey:
    """SMT: wrap the record's key as a named field of the value document.

    The reference's `HoistField$Key` + `field: _id` transform
    (mongodb-connector-configmap.yaml:15-17): downstream sinks see the key
    inside the document.  A Message → Message transform producing JSON."""

    def __init__(self, field: str = "_id"):
        self.field = field

    def __call__(self, m: Message) -> Message:
        try:
            doc = json.loads(m.value) if m.value else {}
        except (ValueError, UnicodeDecodeError):
            # a poison record passes through untouched: the sink's own
            # malformed-record policy decides, and the worker must not
            # wedge on it
            return m
        if not isinstance(doc, dict):
            doc = {"value": doc}
        doc[self.field] = (m.key or b"").decode()
        return Message(topic=m.topic, partition=m.partition, offset=m.offset,
                       value=json.dumps(doc).encode(), key=m.key,
                       timestamp_ms=m.timestamp_ms)


class DocumentStoreSink(SinkConnector):
    """Upsert JSON documents by `_id`: the MongoDB digital-twin stand-in."""

    def __init__(self, path: Optional[str] = None, id_field: str = "_id"):
        self.path = path
        self.id_field = id_field
        self.docs: Dict[str, dict] = {}
        if path and os.path.exists(path):
            with open(path) as fh:
                self.docs = json.load(fh)

    def put(self, messages: Sequence[Message]) -> None:
        for m in messages:
            try:
                doc = json.loads(m.value)
            except (ValueError, UnicodeDecodeError):
                continue  # a non-JSON record: the reference sink DLQs it
            if not isinstance(doc, dict):
                doc = {"value": doc}
            if self.id_field not in doc:
                doc[self.id_field] = (m.key or str(m.offset).encode()).decode()
            self.docs[str(doc[self.id_field])] = doc

    def flush(self) -> None:
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(self.docs, fh)
            os.replace(tmp, self.path)

    def find_one(self, doc_id: str) -> Optional[dict]:
        return self.docs.get(doc_id)

    def count(self) -> int:
        return len(self.docs)


class ObjectStoreSink(SinkConnector):
    """Roll framed-Avro topic messages into `.avro` container files."""

    def __init__(self, directory: str, schema: RecordSchema,
                 flush_size: int = 1000, framed: bool = True):
        self.directory = directory
        self.schema = schema
        self.flush_size = flush_size
        self.framed = framed
        os.makedirs(directory, exist_ok=True)
        # pending payloads per (topic, partition): [(offset, payload)]
        self._pending: Dict[tuple, List[tuple]] = {}
        self.files_written: List[str] = []

    def put(self, messages: Sequence[Message]) -> None:
        for m in messages:
            payload = strip_frame(m.value) if self.framed else m.value
            self._pending.setdefault((m.topic, m.partition), []) \
                .append((m.offset, payload))
        for key, pending in list(self._pending.items()):
            if len(pending) >= self.flush_size:
                self._roll(key, pending)
                self._pending[key] = []

    def _roll(self, key: tuple, pending: List[tuple]) -> None:
        if not pending:
            return
        topic, partition = key
        start = pending[0][0]
        # GCS connector object naming: <topic>+<partition>+<startoffset>.avro
        name = f"{topic}+{partition}+{start:010d}.avro"
        path = os.path.join(self.directory, name)
        with ContainerWriter(path, self.schema) as w:
            w.write_block([p for _, p in pending])
        self.files_written.append(path)

    def flush(self) -> None:
        for key, pending in list(self._pending.items()):
            self._roll(key, pending)
            self._pending[key] = []
