"""``ReplicaSet``: one leader and N followers as a managed quorum unit
(``iotml.replication.manager``'s copy).

The reference's RF-3 shape: a leader broker behind its wire server,
``n_followers`` pull replicas (each a ``FollowerReplica`` stamping its
replica id on FETCH and RAW_FETCH, so the leader's ``ReplicationState``
tracks it), quorum durability (acks=all at the quorum high-water mark,
consumer reads bounded by it) and **ISR-restricted leader election**: a
failover may only promote a follower in sync on every partition, at
epoch+1, published through a ``Topology`` cell the clients resolve.

``add_follower`` joins a new replica live (it bootstraps from the log
over RAW_FETCH, starts OUT of the ISR and is admitted at catch-up) and
``retire_follower`` removes one (leaving the ISR first, so the quorum
re-forms without it before it stops answering).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..stream.broker import Broker
from ..stream.kafka_wire import KafkaWireServer
from ..stream.replica import FollowerReplica
from .isr import ReplicationState

#: the process-wide replica-id allocator (ids need only be unique a
#: leader; global ones keep drill logs unambiguous)
_NEXT_RID = itertools.count(1)


def next_replica_id() -> int:
    return next(_NEXT_RID)


class ReplicaSet:
    """Build (or adopt) a leader and run N ISR-tracked followers.

    Args:
      leader_broker / leader_server: adopt an existing pair; both None
        builds an in-memory leader and its wire server.
      n_followers: replicas built at construction (RF - 1).
      min_isr: the acks=all refusal threshold (leader included).
      max_lag_s: the ISR staleness window.
      topics / groups / partition_filter: forwarded to each follower.
      topology: a live (leader, epoch) cell the followers' leader
        connections re-resolve through (None: the set owns a private one
        and publishes it at ``promote``).
      follower_local_factory: () -> Broker for each follower's log (a
        durable one on a store directory of its own); None: in memory.
      hwm_file: the leader's HWM checkpoint (``store.hwm``).
      leader_addr / follower_port_fn: the leader's advertised address;
        the j-th follower's listen port (None: ephemeral).
      poll_interval_s: each follower's idle cadence, the floor of the
        acks=all ack latency (a produce is acked at the followers' next
        fetch past it).
    """

    def __init__(self, leader_broker: Optional[Broker] = None,
                 leader_server: Optional[KafkaWireServer] = None,
                 n_followers: int = 2, min_isr: int = 2,
                 max_lag_s: float = 0.5, host: str = "127.0.0.1",
                 topics: Optional[List[str]] = None,
                 groups: Tuple[str, ...] = (),
                 partition_filter=None, topology=None,
                 follower_local_factory=None, hwm_file=None,
                 leader_addr: Optional[str] = None,
                 follower_port_fn=None,
                 poll_interval_s: float = 0.01):
        own_leader = leader_broker is None
        self.leader = Broker() if own_leader else leader_broker
        if leader_server is None:
            self.server = KafkaWireServer(self.leader, host=host)
            if own_leader:
                self.server.start()
        else:
            self.server = leader_server
        self._host = host
        self._topics = topics
        self._groups = tuple(groups)
        self._owns = partition_filter
        self._local_factory = follower_local_factory
        self._poll_interval_s = float(poll_interval_s)
        self._port_fn = follower_port_fn
        self._built = 0
        self._leader_addr = leader_addr or f"{host}:{self.server.port}"
        # followers always follow a cell, so the survivors of a promotion
        # re-resolve the new leader instead of looping on the dead one
        from ..supervise.topology import Topology

        self._own_topology = topology is None
        self._topology = topology if topology is not None \
            else Topology(self._leader_addr)
        self.state = ReplicationState(
            self.leader, follower_ids=(), topics=topics,
            min_isr=min_isr, max_lag_s=max_lag_s, hwm_file=hwm_file)
        self.leader.replication = self.state
        #: replica id -> live follower (insertion order)
        self.followers: Dict[int, FollowerReplica] = {}
        #: promoted ex-followers (serving leaders) owned for shutdown
        self._promoted: List[FollowerReplica] = []
        self._lock = threading.Lock()
        for _ in range(int(n_followers)):
            self._build_follower()

    # ------------------------------------------------ follower construction
    def _build_follower(self, store_dir: Optional[str] = None,
                        local: Optional[Broker] = None
                        ) -> Tuple[int, FollowerReplica]:
        rid = next_replica_id()
        if local is None and store_dir is None and \
                self._local_factory is not None:
            local = self._local_factory()
        port = self._port_fn(self._built) if self._port_fn else 0
        self._built += 1
        rep = FollowerReplica(
            self._leader_addr, topics=self._topics, groups=self._groups,
            host=self._host, port=port, partition_filter=self._owns,
            local=local, store_dir=store_dir, replica_id=rid,
            topology=self._topology,
            poll_interval_s=self._poll_interval_s)
        with self._lock:
            self.followers[rid] = rep
        self.state.register_follower(rid)
        return rid, rep

    # --------------------------------------------------------- lifecycle
    def start(self, sync: str = "thread") -> "ReplicaSet":
        """Start every follower (``"thread"`` runs their background sync
        loops; ``"manual"`` only serves: step with ``sync_once``)."""
        for rep in list(self.followers.values()):
            if sync == "thread":
                rep.start()
            else:
                rep.server.start()
        return self

    def stop(self) -> None:
        for rep in list(self.followers.values()) + self._promoted:
            try:
                rep.stop()
            except (OSError, RuntimeError):
                pass
        self.state.flush()

    def __enter__(self) -> "ReplicaSet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------- driving
    def sync_once(self) -> int:
        """Step every live, unpromoted follower one round."""
        copied = 0
        for rep in list(self.followers.values()):
            if not rep.promoted:
                copied += rep.sync_once()
        return copied

    def await_isr(self, size: Optional[int] = None, topic: str = "",
                  partition: int = 0, timeout_s: float = 10.0) -> bool:
        """Block until the ISR reaches ``size`` (default: full width).
        Manual-mode callers interleave ``sync_once``."""
        want = size if size is not None else 1 + len(self.followers)
        if not topic:
            names = self._topics or self.leader.topics()
            topic = names[0] if names else ""
        return self.state.await_isr(want, topic, partition, timeout_s)

    # ---------------------------------------------------------- election
    def elect(self, exclude: Tuple[int, ...] = ()) -> int:
        """The failover target: an ISR member (in sync on EVERY
        partition), the highest fetch positions first, then the lowest
        id.  RuntimeError when none is available: promoting an
        out-of-sync follower would serve a log missing acked records."""
        isr = self.state.isr_follower_ids() - set(exclude)
        live = [rid for rid in isr if rid in self.followers
                and not self.followers[rid].promoted]
        if not live:
            raise RuntimeError(
                "no in-sync replica available to elect: refusing to "
                "promote an out-of-sync follower (acked records would "
                "be lost)")

        def score(rid: int) -> tuple:
            total = 0
            for t in (self._topics or self.leader.topics()):
                try:
                    parts = self.leader.topic(t).partitions
                except KeyError:
                    continue
                for p in range(parts):
                    total += max(self.state.positions(t, p).get(rid, 0), 0)
            return (total, -rid)

        return max(live, key=score)

    def promote(self, epoch: int,
                rid: Optional[int] = None) -> Tuple[int, str]:
        """ISR-restricted promotion at ``epoch``: elect (or take ``rid``,
        checked against the ISR), make that follower the serving leader,
        move quorum tracking onto it for the REMAINING followers (they
        re-point through the topology cell) and return ``(rid, serving
        address)``."""
        if rid is None:
            rid = self.elect()
        elif rid not in self.state.isr_follower_ids():
            raise RuntimeError(
                f"replica {rid} is not in the ISR: refusing the "
                f"promotion (leader election is ISR-restricted)")
        rep = self.followers[rid]
        addr = rep.promote(epoch)
        with self._lock:
            self.followers.pop(rid, None)
            self._promoted.append(rep)
            remaining = tuple(self.followers)
        # the new state CARRIES the old quorum's marks: the tail this
        # follower mirrored past the committed mark exists on one copy
        # until the new quorum covers it, so it stays unreadable.  A
        # durable promoted log gets its own checkpoint file.
        from ..store.hwm import hwm_file_for

        store = getattr(rep.local, "store", None)
        self.state = ReplicationState(
            rep.local, follower_ids=remaining, topics=self._topics,
            min_isr=self.state.min_isr, max_lag_s=self.state.max_lag_s,
            hwm_file=hwm_file_for(getattr(store, "dir", None)),
            initial_hwms=self.state.hwm_snapshot())
        rep.local.replication = self.state
        self.leader = rep.local
        self.server = rep.server
        self._leader_addr = addr
        if self._own_topology:
            # a standalone set publishes the new term itself, so the
            # remaining followers re-resolve here
            self._topology.publish(addr, epoch)
        return rid, addr

    # --------------------------------------------------------- elasticity
    def add_follower(self, store_dir: Optional[str] = None,
                     local: Optional[Broker] = None,
                     sync: str = "thread") -> int:
        """Join a new replica live: it bootstraps the whole log over the
        RAW_FETCH mirror, OUT of the ISR until its first catch-up.
        Returns its replica id."""
        rid, rep = self._build_follower(store_dir=store_dir, local=local)
        if sync == "thread":
            rep.start()
        else:
            rep.server.start()
        return rid

    def retire_follower(self, rid: int, timeout_s: float = 10.0) -> None:
        """Remove a replica: it leaves the ISR FIRST, then stops."""
        self.state.unregister_follower(rid)
        with self._lock:
            rep = self.followers.pop(rid, None)
        if rep is not None:
            rep.stop()

    def kill_follower(self, rid: int) -> None:
        """Abrupt follower death: its server dies mid-service and the ISR
        learns only through the staleness window."""
        rep = self.followers.get(rid)
        if rep is None:
            return
        rep._stop.set()
        try:
            rep.server.kill()
        except OSError:
            pass

    # ------------------------------------------------------------- state
    def caught_up(self, timeout_s: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(rep.promoted or self._follower_lag(rep) == 0
                   for rep in list(self.followers.values())):
                return True
            time.sleep(0.02)
        return False

    def _follower_lag(self, rep: FollowerReplica) -> int:
        try:
            return sum(rep.lag().values())
        except (OSError, RuntimeError, KeyError):
            return 1  # unknown counts as behind

    def describe(self) -> dict:
        """An operator's snapshot: leader, followers, ISR, widths."""
        topics = self._topics or self.leader.topics()
        isr: Dict[str, int] = {}
        for t in topics:
            try:
                parts = self.leader.topic(t).partitions
            except KeyError:
                continue
            for p in range(parts):
                isr[f"{t}:{p}"] = self.state.isr_size(t, p)
        return {
            "leader": self._leader_addr,
            "followers": sorted(self.followers),
            "isr_follower_ids": sorted(self.state.isr_follower_ids()),
            "isr_size": isr,
            "min_isr": self.state.min_isr,
        }
