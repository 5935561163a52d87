"""Per-car twin state: latest reading + rolling-window aggregates
(``iotml.twin.state``'s copy).

One `CarTwin` is one car's materialised state — the document the
reference's MongoDB sink upserts per car (mongodb-connector-configmap
HoistField$Key: latest state wins), grown into what a feature store
needs: a bounded window of recent readings and the aggregates derived
from it (mean/min/max over the window, an EMA, lifetime counts).

The state is a PURE FOLD over the car's source records, and the fold is
made idempotent by provenance: each twin remembers the (partition,
offset) of the last record it absorbed, and `TwinTable.apply` drops
anything at or behind it.  Per-car records are totally ordered within
one partition (keyed partitioning), so at-least-once redelivery after a
crash folds to exactly the same state.

Serialization is canonical JSON (sorted keys, repr-roundtrip floats):
the changelog record for a car is byte-deterministic given its state,
and equal to the JAX package's byte for byte, since the values are the
same Python floats folded in the same order.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ..core.schema import KSQL_CAR_SCHEMA, RecordSchema

#: rolling-window depth (records per car) and the EMA fold constant
DEFAULT_WINDOW = 8
EMA_ALPHA = 0.125


class CarTwin:
    """One car's materialised state (see the module docstring)."""

    __slots__ = ("car", "partition", "offset", "ts", "count", "failures",
                 "last", "window", "ema")

    def __init__(self, car: str, partition: int = 0):
        self.car = car
        self.partition = int(partition)
        self.offset = -1       # source offset of the last absorbed record
        self.ts = 0            # its timestamp
        self.count = 0         # lifetime records absorbed
        self.failures = 0      # lifetime records labeled as failures
        self.last: List[float] = []    # latest raw sensor row [F]
        self.window: List[List[float]] = []  # last W raw rows, oldest first
        self.ema: List[float] = []     # EMA over the raw rows [F]

    # ------------------------------------------------------------- fold
    def absorb(self, values: List[float], ts: int, offset: int,
               failure: bool, window: int = DEFAULT_WINDOW) -> None:
        """Fold one source record into the state (caller dedups via
        `offset` — see TwinTable.apply)."""
        self.last = list(values)
        self.window.append(self.last)
        if len(self.window) > window:
            del self.window[: len(self.window) - window]
        if not self.ema:
            self.ema = list(values)
        else:
            a = EMA_ALPHA
            self.ema = [e + a * (v - e) for e, v in zip(self.ema, values)]
        self.count += 1
        if failure:
            self.failures += 1
        self.ts = int(ts)
        self.offset = int(offset)

    # ------------------------------------------------------- aggregates
    def aggregates(self) -> dict:
        """Rolling-window aggregates — the queryable feature block."""
        if not self.window:
            return {"count": 0, "failures": 0, "failure_rate": 0.0,
                    "window_len": 0, "mean": [], "min": [], "max": [],
                    "ema": []}
        cols = list(zip(*self.window))
        return {
            "count": self.count,
            "failures": self.failures,
            "failure_rate": self.failures / self.count,
            "window_len": len(self.window),
            "mean": [sum(c) / len(c) for c in cols],
            "min": [min(c) for c in cols],
            "max": [max(c) for c in cols],
            "ema": list(self.ema),
        }

    def to_doc(self, schema: RecordSchema = KSQL_CAR_SCHEMA) -> dict:
        """The REST document: latest state (named fields) + aggregates."""
        names = [f.name for f in schema.sensor_fields]
        return {
            "car": self.car,
            "partition": self.partition,
            "offset": self.offset,
            "timestamp_ms": self.ts,
            "latest": dict(zip(names, self.last)),
            "aggregates": self.aggregates(),
        }

    # ---------------------------------------------------- changelog form
    def encode(self) -> bytes:
        """Canonical byte form for the CAR_TWIN changelog record."""
        return json.dumps(
            {"car": self.car, "partition": self.partition,
             "offset": self.offset, "ts": self.ts, "count": self.count,
             "failures": self.failures, "last": self.last,
             "window": self.window, "ema": self.ema},
            sort_keys=True, separators=(",", ":")).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "CarTwin":
        doc = json.loads(blob)
        t = cls(doc["car"], doc["partition"])
        t.offset = int(doc["offset"])
        t.ts = int(doc["ts"])
        t.count = int(doc["count"])
        t.failures = int(doc["failures"])
        t.last = [float(v) for v in doc["last"]]
        t.window = [[float(v) for v in row] for row in doc["window"]]
        t.ema = [float(v) for v in doc["ema"]]
        return t


class TwinTable:
    """car id → CarTwin, with the idempotent-fold discipline.

    `apply` folds a decoded source record; `apply_changelog` installs a
    rebuilt state (latest changelog record wins; a tombstone deletes the
    car).  Both are what make the table a pure function of the log."""

    def __init__(self, window: int = DEFAULT_WINDOW):
        self.window = int(window)
        self.twins: Dict[str, CarTwin] = {}

    def __len__(self) -> int:
        return len(self.twins)

    def get(self, car: str) -> Optional[CarTwin]:
        return self.twins.get(car)

    def cars(self) -> List[str]:
        return sorted(self.twins)

    def apply(self, car: str, partition: int, offset: int,
              values: List[float], ts: int, failure: bool) -> bool:
        """Fold one source record; returns False when the record is at or
        behind the twin's provenance (an at-least-once redelivery) and
        was dropped — the exactly-once-effect dedup."""
        twin = self.twins.get(car)
        if twin is None:
            twin = self.twins[car] = CarTwin(car, partition)
        elif twin.partition == int(partition) and offset <= twin.offset:
            return False
        twin.absorb(values, ts, offset, failure, window=self.window)
        return True

    def apply_changelog(self, car: str, value: Optional[bytes]) -> None:
        if value is None:
            self.twins.pop(car, None)  # tombstone: the car is retired
        else:
            self.twins[car] = CarTwin.decode(value)

    def resume_offsets(self) -> Dict[int, int]:
        """{partition: next source offset} implied by the rebuilt states'
        provenance — where a restarted service resumes its source
        cursors so no record is re-folded or skipped."""
        out: Dict[int, int] = {}
        for twin in self.twins.values():
            nxt = twin.offset + 1
            if nxt > out.get(twin.partition, 0):
                out[twin.partition] = nxt
        return out

    def snapshot(self) -> Dict[str, bytes]:
        """{car: canonical byte state} — what drills diff before/after a
        kill+rebuild (byte equality is state equality by construction)."""
        return {car: twin.encode() for car, twin in self.twins.items()}
