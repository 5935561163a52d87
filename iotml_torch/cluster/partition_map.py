"""``PartitionMap``: who leads each (topic, partition), at which epoch
(``iotml.cluster.partition_map``'s copy).

The reference spreads its 10-partition topics over a 3-broker cluster
(reference ``01_installConfluentPlatform.sh:180-183``, ``gcp.yaml:46-54``).
The map generalises the single-leader ``supervise.Topology`` cell into
one cell **per shard** plus a static partition → shard policy:

- Shard identity is stable and addresses move: a promoted follower
  inherits its shard, the map publishes the shard's new ``(address,
  epoch)``, and every other shard's cell stays as it is.
- The policy is a pure function (``partition % n_shards``), so brokers
  deciding what they own, clients deciding where to route and the
  controller deciding what to boot agree with no coordination; METADATA
  answers carry the materialised map to clients in other processes.
- Cells are ``Topology`` objects, so a wire client built with
  ``topology=map.cell(shard)`` re-resolves the shard's live address on
  every reconnect and stamps its fencing epoch on every request.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from ..supervise.topology import Topology


class PartitionMap:
    """Thread-safe (topic, partition) → (broker address, epoch) map.

    Args:
      leaders: the first leader address of each shard (index = shard id).
      epochs: each shard's first fencing epoch (default all 0).
      coordinator_shard: the shard whose live leader holds every consumer
        group's membership and offsets (FIND_COORDINATOR is pinned there:
        group state lives in exactly one place).
    """

    def __init__(self, leaders: List[str],
                 epochs: Optional[List[int]] = None,
                 coordinator_shard: int = 0):
        if not leaders:
            raise ValueError("a cluster needs at least one shard")
        epochs = epochs or [0] * len(leaders)
        if len(epochs) != len(leaders):
            raise ValueError("one epoch per shard")
        if not 0 <= coordinator_shard < len(leaders):
            raise ValueError(f"coordinator shard {coordinator_shard} "
                             f"outside 0..{len(leaders) - 1}")
        self._lock = threading.Lock()
        # every OTHER shard's address is a cell's fallback list: a client
        # that cannot reach its shard's leader still finds a live broker
        # to refresh its metadata from
        self._cells = [
            Topology(addr, epoch=epochs[i],
                     fallback=[a for j, a in enumerate(leaders) if j != i])
            for i, addr in enumerate(leaders)]
        self._coordinator_shard = coordinator_shard
        self._topics: Dict[str, int] = {}

    # ------------------------------------------------------------ policy
    @property
    def n_shards(self) -> int:
        return len(self._cells)

    def shard_for(self, topic: str, partition: int) -> int:
        """The owning shard: a pure function of the partition index."""
        return int(partition) % len(self._cells)

    # ------------------------------------------------------------ topics
    def register_topic(self, name: str, partitions: int) -> None:
        with self._lock:
            self._topics[name] = int(partitions)

    def topics(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._topics)

    def partitions_of(self, shard: int, topic: str) -> List[int]:
        """The partitions of ``topic`` this shard owns."""
        with self._lock:
            n = self._topics.get(topic, 0)
        return [p for p in range(n) if self.shard_for(topic, p) == shard]

    # ----------------------------------------------------------- resolve
    def cell(self, shard: int) -> Topology:
        """The shard's live (leader, epoch) cell, for
        ``KafkaWireBroker(topology=...)``."""
        return self._cells[shard]

    def resolve(self, topic: str, partition: int) -> Tuple[List[str], int]:
        """(servers, epoch) of the shard owning (topic, partition): the
        live leader first, every other known broker as fallback."""
        return self._cells[self.shard_for(topic, partition)].resolve()

    def leader(self, shard: int) -> str:
        return self._cells[shard].leader

    def epoch(self, shard: int) -> int:
        return self._cells[shard].epoch

    def addresses(self) -> List[str]:
        """The current leader address of each shard (index = shard id)."""
        return [c.leader for c in self._cells]

    @property
    def generation(self) -> int:
        """A cheap change detector: the publishes across all cells."""
        return sum(c.generation for c in self._cells)

    # ------------------------------------------------------- coordinator
    @property
    def coordinator_shard(self) -> int:
        with self._lock:
            return self._coordinator_shard

    def coordinator(self) -> Tuple[int, str]:
        """(shard id, live address) of the pinned group coordinator."""
        with self._lock:
            shard = self._coordinator_shard
        return shard, self._cells[shard].leader

    def set_coordinator(self, shard: int) -> None:
        """Re-pin group coordination onto another shard."""
        if not 0 <= shard < len(self._cells):
            raise ValueError(f"no shard {shard}")
        with self._lock:
            self._coordinator_shard = shard

    # ----------------------------------------------------------- publish
    def publish(self, shard: int, leader: str, epoch: int) -> None:
        """Install a shard's new leadership term (a failover or a move):
        ONE cell moves, and its monotonic-epoch check refuses a belated
        publish.  Every other cell swaps the old address for the new one
        in its fallback list, so metadata refreshes through any shard's
        client keep working."""
        old = self._cells[shard].leader
        self._cells[shard].publish(leader, epoch)
        for i, c in enumerate(self._cells):
            if i != shard:
                c.replace_fallback(old, leader)
