"""Online shard reassignment (``iotml.replication.reassign``'s copy).

The cluster's partition → shard policy is a pure function (``p % N``),
so the unit of reassignment is the SHARD: moving capacity means moving a
shard's leadership and its data onto another node.  ``add-broker`` and
``drain-broker`` do so as a five-state machine an operator can watch:

    BOOTSTRAPPING   a new replica mirrors the shard's log over the
                    RAW_FETCH mirror (batches appended as they are),
                    OUT of the ISR
    CATCHING_UP     the mirror is live and the lag shrinking; the replica
                    earns ISR admission at its first catch-up
    IN_SYNC         the replica is in the ISR: it bounds the quorum HWM,
                    so everything acked from here is on the new node
    MOVED           the target was promoted at epoch+1 and the shard's
                    Topology cell republished: clients re-resolve on
                    their next reconnect or fence, consumers keep their
                    cursors (offsets are identical by the mirror
                    contract), the other followers re-point
    RETIRED         the old leader retired: its server is dead (its
                    stale epoch would answer FENCED anyway) and its
                    broker closed

(``FAILED`` ends a move that raised, with its error.)  No step disrupts
consumers: reads flow from the old leader until MOVED and from the new
one after, and the one client-visible event is a reconnect, which every
consumer already treats as a failover.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

BOOTSTRAPPING = "bootstrapping"
CATCHING_UP = "catching_up"
IN_SYNC = "in_sync"
MOVED = "moved"
RETIRED = "retired"
FAILED = "failed"


@dataclasses.dataclass
class ShardReassignment:
    """One shard's move, with the numbers the drill's SLOs read."""

    shard: int
    target_rid: Optional[int] = None
    state: str = BOOTSTRAPPING
    started_mono: float = dataclasses.field(default_factory=time.monotonic)
    catch_up_s: Optional[float] = None       # bootstrap -> ISR admission
    move_s: Optional[float] = None           # bootstrap -> cell publish
    records_mirrored: int = 0
    raw_mirrored: int = 0                    # over the RAW_FETCH mirror
    old_leader: str = ""
    new_leader: str = ""
    epoch: Optional[int] = None
    error: str = ""

    def advance(self, state: str) -> None:
        self.state = state
        now = time.monotonic()
        if state == IN_SYNC and self.catch_up_s is None:
            self.catch_up_s = now - self.started_mono
        if state == MOVED and self.move_s is None:
            self.move_s = now - self.started_mono

    def fail(self, error: str) -> None:
        self.state = FAILED
        self.error = error

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("started_mono", None)
        return d
