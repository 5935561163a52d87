"""Invariant verdicts (``iotml.chaos.runner``, cut to what the online and
alert-burn drills use): the topics and group of the drill pipelines, the
``Invariant`` record, the commit-monotonicity check and the commit
recorder it reads.  The scenario runner and its other invariants are
ROADMAP A14.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

#: the drill pipelines' ML input topic, prediction topic and scorer group
IN_TOPIC = "SENSOR_DATA_S_AVRO"
PRED_TOPIC = "model-predictions"
GROUP = "chaos-scorer"


@dataclasses.dataclass(frozen=True)
class Invariant:
    name: str
    ok: bool
    detail: str

    def verdict(self) -> str:
        return f"{'PASS' if self.ok else 'FAIL'}  {self.name}: {self.detail}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _check_commits_monotonic(commit_log: List[tuple]) -> Invariant:
    """Every committed offset stream, per (tag, group, topic,
    partition), is non-decreasing — a rewinding commit would re-deliver
    unbounded history or mask a lost fence."""
    streams: Dict[tuple, int] = {}
    bad = []
    for tag, group, topic, part, off in commit_log:
        key = (tag, group, topic, part)
        if off < streams.get(key, -1):
            bad.append((key, streams[key], off))
        streams[key] = max(streams.get(key, -1), off)
    return Invariant(
        "commits_monotonic", not bad,
        f"{len(commit_log)} commits over {len(streams)} offset streams"
        + (f"; REGRESSIONS {bad[:4]}" if bad else ", all non-decreasing"))


def _record_commits(broker, log: List[tuple], tag: str) -> None:
    """Shadow a broker instance's commit paths with history-recording
    wrappers — the monotonicity invariant needs the sequence, and the
    broker (correctly) stores only the latest value.  Both entry points
    are wrapped: ``StreamConsumer.commit`` prefers the batched
    ``commit_many`` when the broker offers it."""
    orig = broker.commit

    def commit(group, topic, partition, next_offset):
        log.append((tag, group, topic, partition, next_offset))
        return orig(group, topic, partition, next_offset)

    broker.commit = commit
    orig_many = getattr(broker, "commit_many", None)
    if orig_many is not None:
        def commit_many(group, topic, entries):
            for p, off in entries:
                log.append((tag, group, topic, p, off))
            return orig_many(group, topic, entries)

        broker.commit_many = commit_many
