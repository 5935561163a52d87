"""The partitioned multi-broker data plane (``iotml.cluster``'s copy).

The reference runs its topics at 10 partitions on 3 brokers (reference
``01_installConfluentPlatform.sh:180-183``, ``gcp.yaml:46-54``).  This
package shards topic partitions across N live brokers and makes every
client partition-aware:

- ``PartitionMap``: (topic, partition) → (broker, epoch), one
  ``supervise.Topology`` cell a shard, so a failover moves ONE shard.
- ``ShardBroker``: a ``Broker`` materialising only its shard's
  partitions (store directories included); an unowned one answers
  NOT_LEADER_FOR_PARTITION.
- ``ClusterController``: boots the brokers, provisions topics
  cluster-wide, runs followers a shard (asynchronous or quorum), fails
  a shard over, and moves a shard online (``add_broker`` /
  ``drain_broker``, the CLUSTER_ADMIN verbs).
- ``ClusterClient``: the ``Broker`` duck-type, routed: produce and fetch
  to the owning broker, group and offset APIs to the coordinator.
- ``ScorerFleet`` / ``PumpFleet``: partition-parallel scorers and KSQL
  pumps as consumer groups over the wire group protocol.

Outside this package, code reaches brokers through ``ClusterClient`` and
the ``PartitionMap``, never a shard's broker object, so the ownership and
fencing invariants hold.  ``python -m iotml_torch.cluster`` is the
command line (``up``, ``drill``, ``add-broker``, ``drain-broker``,
``status``).
"""

from .client import ClusterClient
from .controller import ClusterController, ShardView
from .fleet import PumpFleet, ScorerFleet
from .partition_map import PartitionMap
from .shard import ShardBroker

__all__ = ["ClusterClient", "ClusterController", "PartitionMap",
           "PumpFleet", "ScorerFleet", "ShardBroker", "ShardView",
           "main"]


def main(argv=None) -> int:
    """The command line (``python -m iotml_torch.cluster``)."""
    from .__main__ import main as _main

    return _main(argv)
