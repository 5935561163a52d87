#!/usr/bin/env python3
"""Run the alert-burn drill while other processes keep the host's cores
busy, to see how the canaries' round trips and the drill's verdict move
with CPU contention.

    python3 scripts/drill_under_load.py [--busy 12] [--rounds 3]
        [--offsets skip append] [--device cuda|cpu]

Run from the repository root; ``--device cuda`` (the default) puts the
drill's scorer on the card, as ``chip_smoke.py`` runs it.  Each round
runs the drill once for each ``--offsets`` mode, in turn, each in a
child process of its own beside ``--busy`` processes that spin on the
CPU (started before the drill, killed after it):

- ``skip``: the durable offsets file as it is (an unchanged commit
  appends nothing);
- ``append``: every commit appends a record, as JAX's file does (the
  port's ``OffsetsFile.commit`` before that change), so that consumers
  committing unchanged cursors on every idle poll compact the file, a
  rewrite and an fsync under the broker's lock, every few polls.

Each child times every canary round trip (``iotml_canary_e2e_seconds``'
observations) and the start of the degraded phase.  Prints one JSON line
per drill: mode, busy processes, the verdict and the failed invariants,
and the healthy phase's round trips (count, over the 0.1 s SLO, p50,
p90, max, seconds), then the card's name and power limit when there is
one.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the child: the drill with its canaries' round trips timed
CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from iotml_torch.chaos import faults
from iotml_torch.obs import canary, drill
from iotml_torch.store import offsets, segment

if sys.argv[2] == "append":
    def commit(self, group, topic, partition, next_offset, sync=True):
        key = f"{group}\x00{topic}\x00{partition}".encode()
        self._writer.append(segment.encode_record(
            0, key, str(int(next_offset)).encode(), 0, None))
        self._unsynced = True
        if self.fsync == "always":
            if sync:
                self._sync()
        elif self.fsync == "interval":
            now = time.monotonic()
            if now - self._last_fsync >= self.fsync_interval_s:
                self._sync()
                self._last_fsync = now
        self._table[(group, topic, int(partition))] = int(next_offset)
        self._records += 1
        if self._records >= self.compact_ratio * max(len(self._table), 1):
            self.compact()
    offsets.OffsetsFile.commit = commit

trips, marks = [], {}
observe = canary.canary_e2e.observe
def timed(value, **labels):
    trips.append((time.monotonic(), value))
    return observe(value, **labels)
canary.canary_e2e.observe = timed
arm = faults.arm
def armed(engine):
    marks["degraded"] = time.monotonic()
    return arm(engine)
faults.arm = armed
rep = drill.drill_alert_burn(device=sys.argv[3])
healthy = sorted(v for t, v in trips if t < marks.get("degraded", 1e18))
print(json.dumps({"ok": rep.ok,
                  "failed": [i.name for i in rep.invariants if not i.ok],
                  "healthy": healthy}))
"""


def _spin() -> None:
    while True:
        pass


def _one(mode: str, busy: int, device: str) -> dict:
    spinners = [mp.Process(target=_spin, daemon=True) for _ in range(busy)]
    for p in spinners:
        p.start()
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, "-c", CHILD, ROOT, mode,
                              device], capture_output=True, text=True,
                             timeout=300)
    finally:
        for p in spinners:
            p.kill()
            p.join()
    seconds = time.perf_counter() - t0
    try:
        got = json.loads(out.stdout[out.stdout.index("{"):])
    except ValueError:
        raise SystemExit(f"drill child exited {out.returncode}:\n"
                         f"{out.stdout[-2000:]}{out.stderr[-4000:]}")
    h = got["healthy"]
    return {"offsets": mode, "busy": busy, "ok": got["ok"],
            "failed": got["failed"], "healthy_trips": len(h),
            "over_0.1s": sum(v > 0.1 for v in h),
            "p50_s": h[len(h) // 2], "p90_s": h[int(len(h) * 0.9)],
            "max_s": h[-1], "seconds": seconds}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--busy", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--offsets", nargs="+", default=["skip", "append"],
                    choices=["skip", "append"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    for _ in range(args.rounds):
        for mode in args.offsets:
            print(json.dumps(_one(mode, args.busy, args.device)),
                  flush=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
