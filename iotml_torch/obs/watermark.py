"""Event-time watermarks (``iotml.obs.watermark``'s twin).

Every record carries its event timestamp, so each consuming stage
reports, a batch at a time, how far behind event time its progress
frontier sits:

- ``iotml_watermark_lag_seconds{stage,topic,partition,group}``: a
  histogram of (now - event time), observed for the batch's min AND max
  event time, so it brackets the per-record ingest-to-stage latency at
  no per-record cost;
- ``iotml_watermark_event_time_ms{...}``: the watermark itself, the
  newest event timestamp the stage has fully processed (monotone), read
  by ``/healthz``.

The stage vocabulary is closed: ``consume`` (observed by
``StreamConsumer.poll``), ``score`` / ``train`` / ``twin`` (observed by
the scorer and the trainers when a drain or round completes, from the
ranges ``StreamConsumer.take_event_time`` hands them).  Record
timestamps are wall-clock, so lag compares wall to wall.
``IOTML_WATERMARK=0`` turns the watermarks off (``config.NON_CONFIG``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

from . import metrics as _metrics

#: module flag every publishing site guards on (cheap module read;
#: watermarks are batch-granular so they default ON, unlike tracing)
ENABLED = True

#: closed stage vocabulary — the cardinality test pins label values to
#: this set, and helpers below reject anything outside it loudly
STAGES = frozenset({"consume", "score", "train", "twin"})


def configure(enabled: Optional[bool] = None) -> None:
    global ENABLED
    if enabled is not None:
        ENABLED = bool(enabled)


def configure_from_env(env: Optional[Dict[str, str]] = None) -> None:
    env = os.environ if env is None else env
    raw = env.get("IOTML_WATERMARK")
    if raw is not None:
        configure(enabled=raw.strip().lower() not in
                  ("0", "false", "no", "off"))


def observe(stage: str, topic: str, partition: int,
            ts_min_ms: int, ts_max_ms: int,
            group: str = "",
            now_ms: Optional[float] = None) -> None:
    """Record one consumed batch's event-time bounds for `stage`.

    ``ts_min_ms``/``ts_max_ms`` are the decoder-reported bounds (-1 =
    nothing consumed: a no-op).  ``group`` is the consumer group: two
    consumers of the same partition (a trainer and a scorer in one
    process) are different frontiers, and without the label the gauge
    would flap between them.  Two histogram observations + one gauge
    set per batch — the whole cost, independent of batch size."""
    if not ENABLED or ts_max_ms is None or ts_max_ms < 0:
        return
    if stage not in STAGES:
        raise ValueError(f"watermark stage {stage!r} outside the closed "
                         f"set {sorted(STAGES)}")
    if now_ms is None:
        now_ms = time.time() * 1000.0  # wallclock-ok: event timestamps
        # are wall-domain; this is a latency measurement, not a deadline
    # the watermark gauge is MONOTONE: "newest event time fully
    # processed" must never regress when a later batch happens to end
    # on an older event timestamp (store-and-forward re-deliveries).
    # Benign read-then-set race between drainers: both write forward.
    labels = dict(stage=stage, topic=topic, partition=partition,
                  group=group)
    if ts_max_ms > _metrics.watermark_event_ms.value(**labels):
        _metrics.watermark_event_ms.set(ts_max_ms, **labels)
    h = _metrics.watermark_lag_seconds
    h.observe(max(now_ms - ts_max_ms, 0.0) / 1000.0,
              stage=stage, topic=topic, partition=partition, group=group)
    if ts_min_ms is not None and 0 <= ts_min_ms < ts_max_ms:
        h.observe(max(now_ms - ts_min_ms, 0.0) / 1000.0,
                  stage=stage, topic=topic, partition=partition,
                  group=group)


def observe_taken(stage: str,
                  taken: Dict[Tuple[str, int], Tuple[int, int]],
                  group: str = "") -> None:
    """Publish a processing stage's completion watermark from the
    event-time ranges a ``StreamConsumer.take_event_time()`` call
    returned — the scorer/trainer/twin idiom: take at the drain/commit
    boundary, where "consumed" has become "processed"."""
    if not ENABLED or not taken:
        return
    now_ms = time.time() * 1000.0  # wallclock-ok: see observe()
    for (topic, partition), (ts_min, ts_max) in taken.items():
        observe(stage, topic, partition, ts_min, ts_max, group=group,
                now_ms=now_ms)


configure_from_env()
