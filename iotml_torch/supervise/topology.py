"""Published topology: who leads, at which fencing epoch
(``iotml.supervise.topology``'s ``Topology``, cut to what the model
registry uses).

The JAX package's supervisor publishes ``(leader, epoch)`` on every
promotion, and its clients resolve it on every reconnect.  The model
registry publishes every serving flip through the same cell (the version
as the leader, an epoch that only moves forward), so an in-process
watcher detects a new model as a client detects a new leader.  The
fallback server list and ``resolve()`` serve the wire clients' failover,
which the port does not have (ROADMAP A14), and are not copied.
"""

from __future__ import annotations

import threading


class Topology:
    """Thread-safe (leader, epoch) cell."""

    def __init__(self, leader: str, epoch: int = 0):
        self._lock = threading.Lock()
        self._leader = leader
        self._epoch = int(epoch)

    def publish(self, leader: str, epoch: int) -> None:
        """Install a new term.  Epochs only move forward: a belated
        publish must not roll the cell back."""
        with self._lock:
            if epoch < self._epoch:
                raise ValueError(
                    f"epoch must be monotonic: have {self._epoch}, "
                    f"got {epoch}")
            self._leader = leader
            self._epoch = int(epoch)

    @property
    def leader(self) -> str:
        with self._lock:
            return self._leader

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch
