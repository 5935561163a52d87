"""Drill reports and helpers (``iotml.supervise.drill``, cut to what the
online and alert-burn drills use): ``DrillReport``, one drill's counts,
SLOs and invariant verdicts as JSON or text lines; ``CARS_PER_TICK``;
``_wait``.  The live leader-kill, scorer-crash and broker-restart drills
are ROADMAP A14.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ..chaos import scenarios
from ..chaos.runner import Invariant

#: records per simulated fleet tick (shared with the chaos scenarios)
CARS_PER_TICK = scenarios.CARS_PER_TICK


@dataclasses.dataclass
class DrillReport:
    drill: str
    seed: int
    records: int
    published: int
    scored: int
    restarts: Dict[str, int]
    slos: Dict[str, Optional[float]]
    invariants: List[Invariant]
    injected: Dict[str, int]

    @property
    def ok(self) -> bool:
        return all(i.ok for i in self.invariants)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def lines(self) -> List[str]:
        out = [f"drill={self.drill} seed={self.seed} "
               f"records={self.records} published={self.published} "
               f"scored={self.scored}"]
        for k, v in sorted(self.slos.items()):
            # keys ending in _s are wall-clock seconds; others are
            # record counts / quality numbers (the online drill's
            # record-based SLOs) and carry no unit suffix
            unit = "s" if k.endswith("_s") else ""
            out.append(f"  slo {k}: "
                       + ("n/a" if v is None else f"{v:.3f}{unit}"))
        for k, v in sorted(self.restarts.items()):
            out.append(f"  restarts {k}: {v}")
        for k, v in sorted(self.injected.items()):
            out.append(f"  injected {k}: {v}")
        out += ["  " + i.verdict() for i in self.invariants]
        out.append(("DRILL PASS" if self.ok else "DRILL FAIL")
                   + f" ({self.drill})")
        return out


def _wait(cond, timeout_s: float, interval_s: float = 0.02) -> bool:
    """Poll ``cond`` until it holds or ``timeout_s`` passes; its last
    value."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return cond()
