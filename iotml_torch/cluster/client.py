"""``ClusterClient``: a partition-aware client over N shard brokers
(``iotml.cluster.client``'s copy).

The ``Broker`` duck-type (produce / fetch / offsets / commit / group
APIs), routed: each produce and fetch goes to the broker that OWNS the
(topic, partition), resolved from cached metadata and refreshed when a
broker answers NOT_LEADER_FOR_PARTITION (Kafka error 6), the contract
real Kafka clients implement.  Group and offset APIs are pinned to the
cluster's coordinator broker, re-discovered through FIND_COORDINATOR
after NOT_COORDINATOR (16) or the coordinator's death.

Two sources of metadata, one routing path:

- ``partition_map=`` (in-process): the controller's live
  ``PartitionMap``.  Each shard's connection is built with
  ``topology=map.cell(shard)``, so it re-resolves the shard's address
  and stamps its fencing epoch on every request.
- ``bootstrap=`` (wire): each partition's leader comes from METADATA
  answers and is cached; a bounce or a dead connection refreshes it from
  any reachable broker.

Retries (``KafkaWireBroker``'s at-least-once stance): NOT_LEADER means
nothing was appended there, so any operation re-routes and retries.  A
plain ConnectionError on a produce or commit is not retried (the dead
broker may have applied it): the client refreshes its view and
re-raises, and the caller owns redelivery.  Reads retry freely.

Keyed records take ``zlib.crc32(key) % partitions``, the partitioner of
every client in the family and of the single ``Broker``: per-key order
is a cross-client invariant.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..stream.broker import Message, TopicSpec
from ..stream.kafka_wire import (CoordinatorMovedError, KafkaWireBroker,
                                 NotLeaderForPartitionError)

#: routing attempts an operation: the first try and one re-route after
#: each of up to two refreshes (a refresh mid-failover may be stale)
_ATTEMPTS = 3


class ClusterClient:
    def __init__(self, bootstrap: Optional[str] = None,
                 partition_map=None, client_id: str = "iotml-cluster",
                 sasl_username: Optional[str] = None,
                 sasl_password: Optional[str] = None,
                 timeout_s: float = 30.0):
        if (bootstrap is None) == (partition_map is None):
            raise ValueError(
                "exactly one of bootstrap= (wire discovery) or "
                "partition_map= (in-process map) is required")
        self.client_id = client_id
        self._pmap = partition_map
        self._sasl = (sasl_username, sasl_password)
        self._timeout_s = timeout_s
        self._lock = threading.Lock()
        self._conns: Dict[int, KafkaWireBroker] = {}
        self._counts: Dict[str, int] = {}
        self._rr: Dict[str, int] = {}
        # the wire mode's cache (the map mode reads the live map)
        self._addr: Dict[int, str] = {}
        self._leaders: Dict[Tuple[str, int], int] = {}
        self._coord: Optional[Tuple[int, str]] = None  # (node, address)
        if self._pmap is None:
            from ..utils.net import parse_bootstrap

            self._seeds = [f"{h}:{p}" for h, p in parse_bootstrap(bootstrap)]
            self._refresh_metadata()

    # -------------------------------------------------------- connections
    def _new_conn(self, addr: str, tag: str,
                  topology=None) -> KafkaWireBroker:
        user, pw = self._sasl
        return KafkaWireBroker(addr, client_id=f"{self.client_id}-{tag}",
                               sasl_username=user, sasl_password=pw,
                               timeout_s=self._timeout_s, topology=topology)

    def _conn(self, shard: int) -> KafkaWireBroker:
        with self._lock:
            c = self._conns.get(shard)
            if c is None:
                if self._pmap is not None:
                    cell = self._pmap.cell(shard)
                    c = self._new_conn(cell.leader, f"s{shard}",
                                       topology=cell)
                else:
                    c = self._new_conn(self._addr[shard], f"s{shard}")
                self._conns[shard] = c
            return c

    def _drop_conn(self, shard: int) -> None:
        with self._lock:
            c = self._conns.pop(shard, None)
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def _shard_ids(self) -> List[int]:
        if self._pmap is not None:
            return list(range(self._pmap.n_shards))
        return sorted(self._addr)

    # ----------------------------------------------------------- metadata
    def _refresh_metadata(self) -> None:
        """Wire mode: learn (brokers, each partition's leader) anew from
        any reachable broker, dropping connections whose address moved.
        The map mode's map is live: nothing to refresh."""
        if self._pmap is not None:
            return
        candidates = list(self._addr.values()) + [
            s for s in self._seeds if s not in self._addr.values()]
        last: Optional[Exception] = None
        for addr in candidates:
            probe = None
            try:
                probe = self._new_conn(addr, "meta")
                meta = probe.cluster_metadata()
            except (OSError, RuntimeError) as e:
                last = e
                continue
            finally:
                if probe is not None:
                    try:
                        probe.close()
                    except OSError:
                        pass
            new_addr = {node: f"{host}:{port}"
                        for node, host, port, _rack in meta["brokers"]}
            with self._lock:
                moved = [n for n, a in new_addr.items()
                         if self._addr.get(n) not in (None, a)]
                self._addr = new_addr
                self._leaders = dict(meta["leaders"])
                self._counts.update(meta["topics"])
            for n in moved:
                self._drop_conn(n)
            obs_metrics.cluster_metadata_refreshes.inc()
            return
        raise last or OSError("no reachable broker for metadata")

    def _shard_of(self, topic: str, partition: int) -> int:
        if self._pmap is not None:
            return self._pmap.shard_for(topic, partition)
        node = self._leaders.get((topic, partition))
        if node is None:
            self._refresh_metadata()
            node = self._leaders.get((topic, partition))
            if node is None:
                raise KeyError((topic, partition))
        return node

    def _handle_move(self, shard: int) -> None:
        """A bounce or a dead connection: learn the new world.  The map
        mode's address and epoch already moved, so the shard's connection
        is dropped and re-resolves through its cell."""
        self._drop_conn(shard)
        if self._pmap is None:
            try:
                self._refresh_metadata()
            except OSError:
                pass  # nothing reachable now; the retry loop decides

    # ------------------------------------------------------------ routing
    def _routed(self, topic: str, partition: int, op, *,
                retry_connection: bool):
        """``op(conn)`` against the owning shard.  NOT_LEADER always
        re-routes (nothing was applied); a ConnectionError re-routes only
        when ``retry_connection`` (reads), and writes re-raise after the
        refresh: the caller owns redelivery."""
        last: Optional[Exception] = None
        for _ in range(_ATTEMPTS):
            shard = self._shard_of(topic, partition)
            try:
                return op(self._conn(shard))
            except NotLeaderForPartitionError as e:
                obs_metrics.cluster_not_leader_bounces.inc()
                self._handle_move(shard)
                last = e
            except ConnectionError as e:
                self._handle_move(shard)
                if not retry_connection:
                    raise
                last = e
        raise last  # type: ignore[misc]

    # ------------------------------------------------------------ produce
    def _count(self, topic: str) -> int:
        if self._pmap is not None:
            n = self._pmap.topics().get(topic)
            if n:
                return n
        n = self._counts.get(topic)
        if n:
            return n
        n = self._any_conn_call(
            lambda c: c.cluster_metadata([topic])["topics"].get(topic))
        if not n:
            raise KeyError(topic)
        self._counts[topic] = n
        return n

    def _partition_for(self, topic: str, key: Optional[bytes]) -> int:
        n = self._count(topic)
        if key is None:
            self._rr[topic] = (self._rr.get(topic, -1) + 1) % n
            return self._rr[topic]
        return zlib.crc32(key) % n

    def produce(self, topic: str, value: bytes,
                key: Optional[bytes] = None,
                partition: Optional[int] = None, timestamp_ms: int = 0,
                headers: Optional[tuple] = None) -> int:
        return self.produce_many(topic, [(key, value, timestamp_ms)],
                                 partition=partition)

    def produce_batch(self, topic: str, values, key=None,
                      partition=None) -> int:
        return self.produce_many(topic, [(key, v, 0) for v in values],
                                 partition=partition)

    def produce_many(self, topic: str, entries, partition=None,
                     acks: Optional[int] = None,
                     timeout_ms: int = 10_000) -> int:
        """Each record to its partition's owning shard, ONE wire request
        a partition (never a multi-partition one, so a NOT_LEADER bounce
        is all-or-nothing for its entries and the re-route cannot append
        the rest twice).  ``acks`` / ``timeout_ms`` go to the wire client
        (the quorum on replicated shards).  The largest offset
        appended."""
        by_part: Dict[int, list] = {}
        for entry in entries:
            p = self._partition_for(topic, entry[0]) if partition is None \
                else partition
            by_part.setdefault(p, []).append(entry)
        last = -1
        for p, ents in sorted(by_part.items()):
            off = self._routed(
                topic, p,
                lambda c, _p=p, _e=ents: c.produce_many(
                    topic, _e, partition=_p, acks=acks,
                    timeout_ms=timeout_ms),
                retry_connection=False)
            last = max(last, off)
        return last

    def produce_raw(self, topic: str, partition: int, frames: bytes,
                    acks: Optional[int] = None,
                    timeout_ms: int = 10_000) -> int:
        """A pre-framed RAW_PRODUCE batch to the partition's owning shard
        (one request, all or nothing).  NotImplementedError from a shard
        without the extension propagates, so producers pin back to
        PRODUCE."""
        def op(c):
            pr = getattr(c, "produce_raw", None)
            if pr is None:
                raise NotImplementedError(
                    "owning broker lacks raw-batch produce")
            return pr(topic, partition, frames, acks=acks,
                      timeout_ms=timeout_ms)

        return self._routed(topic, partition, op, retry_connection=False)

    # -------------------------------------------------------------- fetch
    def fetch(self, topic: str, partition: int, offset: int,
              max_messages: int = 1024) -> List[Message]:
        return self._routed(
            topic, partition,
            lambda c: c.fetch(topic, partition, offset, max_messages),
            retry_connection=True)

    def fetch_raw(self, topic: str, partition: int, offset: int,
                  max_bytes: int = 1 << 20):
        """A RAW_FETCH routed to the owning shard; NotImplementedError
        when the owning connection lacks it, so consumers fall back to
        FETCH."""
        def op(c):
            fr = getattr(c, "fetch_raw", None)
            if fr is None:
                raise NotImplementedError(
                    "owning broker lacks raw-batch fetch")
            return fr(topic, partition, offset, max_bytes=max_bytes)

        return self._routed(topic, partition, op, retry_connection=True)

    def last_hwm(self, topic: str, partition: int) -> Optional[int]:
        """The largest high-water mark any live shard connection cached
        from a fetch (None when none has): lag telemetry never costs a
        routing round trip.  The largest, because after a failover the
        old leader's connection keeps a frozen mark, and marks only
        grow."""
        with self._lock:
            conns = list(self._conns.values())
        best = None
        for c in conns:
            hwm = c.last_hwm(topic, partition)
            if hwm is not None and (best is None or hwm > best):
                best = hwm
        return best

    def end_offset(self, topic: str, partition: int = 0) -> int:
        return self._routed(topic, partition,
                            lambda c: c.end_offset(topic, partition),
                            retry_connection=True)

    def begin_offset(self, topic: str, partition: int = 0) -> int:
        return self._routed(topic, partition,
                            lambda c: c.begin_offset(topic, partition),
                            retry_connection=True)

    def offset_for_timestamp(self, topic: str, partition: int,
                             timestamp_ms: int) -> int:
        return self._routed(
            topic, partition,
            lambda c: c.offset_for_timestamp(topic, partition, timestamp_ms),
            retry_connection=True)

    # ------------------------------------------------------------- topics
    def _any_conn_call(self, op):
        last: Optional[Exception] = None
        for shard in self._shard_ids():
            try:
                return op(self._conn(shard))
            except (OSError, RuntimeError) as e:
                last = e
                self._drop_conn(shard)
        raise last or OSError("no reachable broker")

    def topics(self) -> List[str]:
        return self._any_conn_call(lambda c: c.topics())

    def topic(self, name: str) -> TopicSpec:
        return TopicSpec(name, self._count(name))

    def create_topic(self, name: str, partitions: int = 1,
                     **retention) -> TopicSpec:
        """Provision cluster-wide: every broker learns the whole spec and
        mounts only the partitions it owns."""
        for shard in self._shard_ids():
            self._conn(shard).create_topic(name, partitions=partitions,
                                           **retention)
        if self._pmap is not None:
            self._pmap.register_topic(name, partitions)
        self._counts[name] = partitions
        return TopicSpec(name, partitions)

    # ------------------------------------------------------- coordination
    def _coord_conn(self) -> KafkaWireBroker:
        if self._pmap is not None:
            return self._conn(self._pmap.coordinator()[0])
        with self._lock:
            coord = self._coord
        if coord is None:
            node, host, port = self._any_conn_call(
                lambda c: c.find_coordinator("iotml"))
            coord = (node, f"{host}:{port}")
            with self._lock:
                self._coord = coord
                self._addr.setdefault(node, coord[1])
        return self._conn(coord[0])

    def _coord_moved(self) -> None:
        obs_metrics.cluster_coordinator_moves.inc()
        if self._pmap is not None:
            self._drop_conn(self._pmap.coordinator()[0])
            return
        with self._lock:
            coord, self._coord = self._coord, None
        if coord is not None:
            self._drop_conn(coord[0])
        try:
            self._refresh_metadata()
        except OSError:
            pass

    def _coordinated(self, op, *, retry_connection: bool):
        """``op`` against the coordinator.  NOT_COORDINATOR always
        re-discovers and retries (nothing was applied); a ConnectionError
        retries only reads: a commit or join cut mid-flight reaches the
        caller, whose loop owns redelivery."""
        last: Optional[Exception] = None
        for _ in range(_ATTEMPTS):
            try:
                return op(self._coord_conn())
            except CoordinatorMovedError as e:
                self._coord_moved()
                last = e
            except ConnectionError as e:
                self._coord_moved()
                if not retry_connection:
                    raise
                last = e
        raise last  # type: ignore[misc]

    # ------------------------------------------------- consumer-group API
    def commit(self, group: str, topic: str, partition: int,
               next_offset: int) -> None:
        self._coordinated(
            lambda c: c.commit(group, topic, partition, next_offset),
            retry_connection=False)

    def commit_many(self, group: str, topic: str, entries) -> None:
        self._coordinated(lambda c: c.commit_many(group, topic, entries),
                          retry_connection=False)

    def committed(self, group: str, topic: str,
                  partition: int) -> Optional[int]:
        return self._coordinated(
            lambda c: c.committed(group, topic, partition),
            retry_connection=True)

    def committed_many(self, group: str, pairs
                       ) -> Dict[Tuple[str, int], int]:
        return self._coordinated(lambda c: c.committed_many(group, pairs),
                                 retry_connection=True)

    def commit_fenced(self, group: str, generation: int, member_id: str,
                      positions) -> bool:
        return self._coordinated(
            lambda c: c.commit_fenced(group, generation, member_id,
                                      positions),
            retry_connection=False)

    def find_coordinator(self, group: str) -> Tuple[int, str, int]:
        return self._any_conn_call(lambda c: c.find_coordinator(group))

    # group membership (RemoteGroupCoordinator drives these)
    def join_group(self, group: str, topics, member_id: str = "",
                   session_timeout_ms: int = 10_000):
        # retried across coordinator moves: a lost join leaks at worst a
        # member that expires at its session timeout
        return self._coordinated(
            lambda c: c.join_group(group, topics, member_id,
                                   session_timeout_ms=session_timeout_ms),
            retry_connection=True)

    def sync_group(self, group: str, generation: int, member_id: str,
                   assignments: Optional[dict] = None):
        return self._coordinated(
            lambda c: c.sync_group(group, generation, member_id,
                                   assignments),
            retry_connection=True)

    def heartbeat_group(self, group: str, generation: int,
                        member_id: str) -> bool:
        return self._coordinated(
            lambda c: c.heartbeat_group(group, generation, member_id),
            retry_connection=True)

    def leave_group(self, group: str, member_id: str) -> None:
        self._coordinated(lambda c: c.leave_group(group, member_id),
                          retry_connection=True)

    # ---------------------------------------------------------- lifecycle
    def close(self) -> None:
        with self._lock:
            conns, self._conns = dict(self._conns), {}
        for c in conns.values():
            try:
                c.close()
            except OSError:
                pass
