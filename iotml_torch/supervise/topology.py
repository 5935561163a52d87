"""Published stream topology: who leads, at which fencing epoch
(``iotml.supervise.topology``'s copy).

The supervisor *publishes* ``(leader address, epoch)`` on every
promotion, and ``KafkaWireBroker`` clients built with ``topology=...``
*resolve* it on every (re)connect instead of walking a static bootstrap
order.  The epoch is the fencing token: it moves forward at each
promotion, clients stamp it into the wire protocol, and servers check it
on the log-mutating APIs (produce, offset commit), so a resurrected old
leader, or a client that slept through a failover, answers FENCED
instead of splitting the log.  The model registry publishes its serving
flips through the same cell (the version as the leader).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple


class Topology:
    """Thread-safe (leader, epoch) cell with a fallback server list.

    ``resolve()`` returns ``(servers, epoch)``: the active leader first,
    then the other known servers (a client that cannot reach the
    published leader still has somewhere to go while a promotion is in
    flight)."""

    def __init__(self, leader: str, epoch: int = 0,
                 fallback: Optional[List[str]] = None):
        self._lock = threading.Lock()
        self._leader = leader
        self._epoch = int(epoch)
        self._fallback = [s for s in (fallback or []) if s != leader]
        #: bumped on every publish, so pollers detect a change cheaply
        self.generation = 0

    def publish(self, leader: str, epoch: int) -> None:
        """Install a new term.  Epochs only move forward: a belated
        publish from a slow failover path must not roll the fleet back
        onto a fenced leader.  The old leader joins the fallback list."""
        with self._lock:
            if epoch < self._epoch:
                raise ValueError(
                    f"epoch must be monotonic: have {self._epoch}, "
                    f"got {epoch}")
            old = self._leader
            self._leader = leader
            self._epoch = int(epoch)
            if old != leader and old not in self._fallback:
                self._fallback.append(old)
            self._fallback = [s for s in self._fallback if s != leader]
            self.generation += 1

    def replace_fallback(self, old: Optional[str], new: str) -> None:
        """Swap one fallback address for another, leaving the leader and
        the epoch as they are (a sharded cluster's other cells learn a
        failed-over shard's new address this way)."""
        with self._lock:
            self._fallback = [s for s in self._fallback
                              if s != old and s != new]
            if new != self._leader:
                self._fallback.append(new)
            self.generation += 1

    def resolve(self) -> Tuple[List[str], int]:
        with self._lock:
            return [self._leader] + list(self._fallback), self._epoch

    @property
    def leader(self) -> str:
        with self._lock:
            return self._leader

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch
