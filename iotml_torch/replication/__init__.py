"""Quorum ISR durability (``iotml.replication``'s copy).

The reference provisions every topic at replication factor 3 on a
3-broker cluster (``01_installConfluentPlatform.sh``'s RF-3 topics).
This package is the Kafka-shaped equivalent over the port's wire broker:

- ``ReplicationState`` (``isr.py``): the leader's in-sync-replica
  tracker.  Followers stamp a replica id on FETCH and RAW_FETCH; the
  leader observes each fetch position, admits a follower when it reaches
  the log end, evicts it after the staleness window, and advances a
  per-partition **quorum high-water mark** at min(ISR positions).
  ``acks=all`` produces commit only below it, consumer fetches are
  bounded by it, and it persists across a remount (``store/hwm.py``).
- ``ReplicaSet`` (``manager.py``): a leader and N followers as one unit
  (ISR formation, ISR-restricted election at epoch+1, live follower add
  and retire).
- The live ``double-fault`` drill (``drill.py``,
  ``python -m iotml_torch.replication drill``).

Not ported (ROADMAP A14, cluster): ``ShardReassignment``
(``reassign.py``) and the ``reassign`` drill, which need the cluster
controller.
"""

from .isr import ReplicationState
from .manager import ReplicaSet

__all__ = ["ReplicationState", "ReplicaSet"]
