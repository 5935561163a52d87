"""Dead-letter queue for poisoned stream records
(``iotml.streamproc.dlq``'s copy).

Every drop site of the stream processor's tasks (bad UTF-8, malformed
CSV, broken Avro framing, invalid JSON) routes the poisoned record to
``<source-topic>_DLQ`` (Kafka Connect's
``errors.deadletterqueue.topic.name``) as a JSON envelope that carries
what an operator needs to replay or diagnose it:

    {"source": topic, "partition": p, "offset": o, "error": "...",
     "task": "JsonToAvro", "trace": "0123abcd…" | null,
     "raw_b64": base64(value), "key_b64": base64(key) | null}

counted under ``iotml_dlq_total{source=...}`` and browsable with
``python -m iotml_torch.obs dlq``.  A failure to route degrades to the
plain drop, counted under ``iotml_dlq_route_errors_total``: the DLQ
never halts the pipeline.
"""

from __future__ import annotations

import base64
import json
from typing import Optional

from ..obs import metrics as obs_metrics
from ..obs import tracing

DLQ_SUFFIX = "_DLQ"


def dlq_topic(source_topic: str) -> str:
    return source_topic + DLQ_SUFFIX


def envelope(message, error: str, task: Optional[str] = None) -> bytes:
    """The JSON dead-letter envelope for one poisoned record."""
    ctx = tracing.from_headers(message.headers) if message.headers else None
    doc = {
        "source": message.topic,
        "partition": message.partition,
        "offset": message.offset,
        "error": error,
        "task": task,
        "trace": f"{ctx.trace_id:016x}" if ctx is not None else None,
        "raw_b64": base64.b64encode(message.value or b"").decode(),
        "key_b64": (base64.b64encode(message.key).decode()
                    if message.key is not None else None),
    }
    return json.dumps(doc, sort_keys=True).encode()


def decode_envelope(value: bytes) -> dict:
    """Envelope bytes → dict with `raw` (decoded bytes) added — the
    ``python -m iotml_torch.obs dlq`` peek path.  Raises ValueError for
    anything that isn't an envelope-shaped JSON object (a DLQ topic is
    an open topic; arbitrary bytes may land on it)."""
    doc = json.loads(value)
    if not isinstance(doc, dict):
        raise ValueError(f"DLQ envelope must be a JSON object, got "
                         f"{type(doc).__name__}")
    doc["raw"] = base64.b64decode(doc.get("raw_b64") or "")
    return doc


def route(broker, message, error: str, task: Optional[str] = None) -> bool:
    """Send one poisoned record to its source topic's DLQ.

    Returns True when the dead letter landed; False when routing itself
    failed (counted separately — the caller drops the record exactly as
    it did before DLQs existed, keeping the pipeline alive)."""
    topic = dlq_topic(message.topic)
    try:
        if topic not in broker.topics():
            broker.create_topic(topic)
        broker.produce(topic, envelope(message, error, task=task),
                       key=message.key)
    except Exception:  # noqa: BLE001 - a broken DLQ path must degrade
        # to the pre-DLQ drop, never halt the stream
        obs_metrics.dlq_route_errors.inc()
        return False
    obs_metrics.dlq_total.inc(source=message.topic)
    return True
