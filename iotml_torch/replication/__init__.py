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
- ``ShardReassignment`` (``reassign.py``): the online reassignment
  state machine behind ``python -m iotml_torch.cluster add-broker /
  drain-broker`` (a new replica bootstraps over RAW_FETCH, joins the
  ISR, leadership moves through the shard's Topology cell, the old
  leader retires).
- The live ``double-fault`` and ``reassign`` drills (``drill.py``,
  ``python -m iotml_torch.replication drill``).
"""

from .isr import ReplicationState
from .manager import ReplicaSet
from .reassign import ShardReassignment

__all__ = ["ReplicationState", "ReplicaSet", "ShardReassignment"]
