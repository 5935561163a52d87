"""``ShardBroker``: a ``Broker`` serving only its shard's partitions
(``iotml.cluster.shard``'s copy).

Topics carry their full cluster partition count (so metadata, keyed
partitioning and group assignment all see the real width), but only the
partitions the shard OWNS are materialised: in memory, or as the durable
store's per-partition segment directories under the shard's own store
directory.  Any touch of an unowned partition raises
``NotLeaderForPartitionError``, which the wire server answers as Kafka
error 6 and ``ClusterClient`` turns into a metadata refresh and a
re-route.

Consumer-group offsets are not filtered by ownership: the cluster pins
every group's state to one coordinator broker, which commits and serves
offsets for every partition whichever shard stores the records.
"""

from __future__ import annotations

from typing import Callable, Optional

from ..stream.broker import Broker
from ..stream.kafka_wire import NotLeaderForPartitionError


class _UnownedPartition:
    """The placeholder of a partition this shard does not lead: every
    touch point of the in-memory and the durable partition (the raw
    append and read legs, the offset-explicit appends, the truncation and
    retention steps) raises the routing signal.  It holds no log, so the
    store directory holds only the shard's own partitions, and the
    broker's compaction and tiering passes skip it (``slog`` is None)."""

    __slots__ = ("topic", "partition")

    #: no segmented log behind a placeholder
    slog = None

    def __init__(self, topic: str, partition: int):
        self.topic = topic
        self.partition = partition

    def _refuse(self, *_a, **_kw):
        raise NotLeaderForPartitionError(self.topic, self.partition)

    append = append_at = append_raw = sync_batch = note_replay = _refuse
    end = base = read = read_raw = drop_head = enforce_retention = _refuse
    align_base = reset = offset_for_timestamp = _refuse


class ShardBroker(Broker):
    """A ``Broker`` whose partitions are filtered by an ownership
    predicate.

    Args:
      owns: ``(topic, partition) -> bool``, typically ``lambda t, p:
        pmap.shard_for(t, p) == shard_id``.  Pure and stable for the
        broker's lifetime: ownership moves by promoting another broker of
        the shard, never by changing a live broker's predicate.
      shard_id: this node's shard (metadata, diagnostics).
      store_dir / store_policy: as ``Broker``; only owned partitions
        mount segment logs under the directory.
    """

    def __init__(self, owns: Callable[[str, int], bool],
                 shard_id: Optional[int] = None,
                 store_dir: Optional[str] = None, store_policy=None):
        # set BEFORE Broker.__init__: a durable mount re-creates the
        # manifest's topics there, which makes every partition
        self._owns_fn = owns
        self.shard_id = shard_id
        super().__init__(store_dir=store_dir, store_policy=store_policy)

    def owns(self, topic: str, partition: int) -> bool:
        return bool(self._owns_fn(topic, partition))

    def _make_partition(self, topic: str, partition: int):
        if not self._owns_fn(topic, partition):
            return _UnownedPartition(topic, partition)
        return super()._make_partition(topic, partition)
