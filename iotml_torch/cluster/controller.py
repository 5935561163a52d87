"""``ClusterController``: boot, watch and fail over a partitioned cluster
(``iotml.cluster.controller``'s copy).

One controller owns N shard brokers (a ``ShardBroker`` behind a
``KafkaWireServer`` each), the shared ``PartitionMap``, and followers
per shard: the ZooKeeper controller of the reference's 3-broker
deployment (reference ``01_installConfluentPlatform.sh:180-183``), as
in-process objects speaking the real wire protocol, so the same code
drives the tests, the drills and the command line.

On disk (``store_root=``)::

    <store_root>/broker-<i>/             shard i's store (its partitions)
    <store_root>/broker-<i>-replica/     its follower (``replicated``)
    <store_root>/broker-<i>-replica-<k>/ its k-th quorum follower
    <store_root>/broker-<i>-gen<e>/      a node added at epoch e

Two follower modes: ``replicated`` (one asynchronous ``FollowerReplica``
a shard, mirroring ``mirror_groups``' offsets on the coordinator shard)
and quorum (``replication_factor`` / ``min_isr``: a
``replication.ReplicaSet`` a shard, acks=all at the quorum HWM,
ISR-restricted failover, and the ``add_broker`` / ``drain_broker``
reassignment verbs).  Failover is per shard: a dead leader's follower is
promoted at a bumped epoch and only that shard's map entry moves.  Group
coordination is pinned to one shard's live leader; when that shard fails
over, the promoted follower serves the mirrored committed offsets and
groups re-form against it.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import metrics as obs_metrics
from ..stream.kafka_wire import KafkaWireServer
from ..stream.replica import FollowerReplica
from ..supervise.registry import register_thread
from .partition_map import PartitionMap
from .shard import ShardBroker


def _split(addr: str) -> Tuple[str, int]:
    host, port = addr.rsplit(":", 1)
    return host, int(port)


class ShardView:
    """One node's view of the cluster: what its wire server reads to
    answer METADATA (each partition's leader), FIND_COORDINATOR (the
    pinned node) and to advertise the broker list."""

    def __init__(self, pmap: PartitionMap, node_id: int):
        self.pmap = pmap
        self.node_id = node_id

    def brokers(self) -> List[Tuple[int, str, int]]:
        return [(i, *_split(addr))
                for i, addr in enumerate(self.pmap.addresses())]

    def leader_node(self, topic: str, partition: int) -> int:
        return self.pmap.shard_for(topic, partition)

    def coordinator(self) -> Tuple[int, str, int]:
        shard, addr = self.pmap.coordinator()
        return (shard, *_split(addr))


class ClusterController:
    """N shard brokers behind one ``PartitionMap``.

    Args:
      brokers: the shard count (the reference ran 3).
      store_root: durable mode: shard i mounts ``<store_root>/broker-<i>``
        (a cold restart resumes every shard from its own directory).
      replicated: one asynchronous follower a shard (``fail_shard``,
        supervised failover).
      replica_sync: "thread" runs each follower's sync loop; "manual"
        leaves stepping to ``sync_replicas_once`` (deterministic
        runners).
      mirror_groups: the groups whose committed offsets the coordinator
        shard's followers mirror.
      coordinator_shard: the shard whose live leader holds group state.
      base_port: fixed ports: shard i binds ``base_port + i``, its
        followers ``base_port + n * (1 + j) + i``; default ephemeral.
      advertise_host: the host clients dial when it differs from the bind
        ``host`` (a wildcard bind is advertised as 127.0.0.1).
      replication_factor / min_isr / max_lag_s: quorum mode (RF - 1
        ISR-tracked followers a shard).
    """

    def __init__(self, brokers: int = 3, host: str = "127.0.0.1",
                 store_root: Optional[str] = None, store_policy=None,
                 replicated: bool = False, replica_sync: str = "thread",
                 mirror_groups: Tuple[str, ...] = (),
                 coordinator_shard: int = 0,
                 base_port: Optional[int] = None,
                 advertise_host: Optional[str] = None,
                 replication_factor: Optional[int] = None,
                 min_isr: int = 2, max_lag_s: float = 0.5):
        if brokers < 1:
            raise ValueError("brokers must be >= 1")
        if replica_sync not in ("thread", "manual"):
            raise ValueError("replica_sync is 'thread' or 'manual'")
        if replication_factor is not None:
            if replication_factor < 2:
                raise ValueError("replication_factor must be >= 2 "
                                 "(1 is the unreplicated default)")
            # quorum mode has followers of its own
            replicated = False
        self.n = int(brokers)
        self.host = host
        self._store_root = store_root
        self._store_policy = store_policy
        self._replica_sync = replica_sync
        self._mirror_groups = tuple(mirror_groups)
        # the address brokers reach each other at (follower sync) vs the
        # one clients are told to dial (METADATA, the map)
        connect_host = "127.0.0.1" if host in ("0.0.0.0", "::") else host
        self._adv_host = advertise_host or connect_host
        self.brokers: List[ShardBroker] = []
        self.servers: List[KafkaWireServer] = []
        self._killed = [False] * self.n
        for i in range(self.n):
            b = ShardBroker(self._owns_fn(i), shard_id=i,
                            store_dir=self._dir(f"broker-{i}"),
                            store_policy=store_policy)
            self.brokers.append(b)
            self.servers.append(KafkaWireServer(
                b, host=host, port=(base_port + i) if base_port else 0))
        local_addresses = [f"{connect_host}:{s.port}" for s in self.servers]
        self.pmap = PartitionMap(
            [f"{self._adv_host}:{s.port}" for s in self.servers],
            coordinator_shard=coordinator_shard)
        for i, srv in enumerate(self.servers):
            srv.cluster = ShardView(self.pmap, i)
        # a durable cold restart re-created each shard's topics at mount:
        # the map learns their widths before any client asks
        for b in self.brokers:
            for t in b.topics():
                self.pmap.register_topic(t, b.topic(t).partitions)
        #: per shard: the broker SERVING it (the leader until a failover,
        #: then the promoted follower's log)
        self.serving: List[ShardBroker] = list(self.brokers)
        self.replicas: List[Optional[FollowerReplica]] = [None] * self.n
        #: quorum mode: one ReplicaSet a shard
        self.replica_sets: List = [None] * self.n
        self.replication_factor = replication_factor
        #: every reassignment report, completed or failed
        self.reassignments: List = []
        if replication_factor is not None:
            from ..replication import ReplicaSet
            from ..store.hwm import hwm_file_for

            for i in range(self.n):
                made = iter(range(1 << 30))

                def factory(i=i, made=made):
                    return ShardBroker(
                        self._owns_fn(i), shard_id=i,
                        store_dir=self._dir(f"broker-{i}-replica-"
                                            f"{next(made)}"),
                        store_policy=store_policy)

                def port_for(j, i=i):
                    return (base_port + self.n * (1 + j) + i) \
                        if base_port else 0

                rset = ReplicaSet(
                    leader_broker=self.brokers[i],
                    leader_server=self.servers[i],
                    n_followers=replication_factor - 1, min_isr=min_isr,
                    max_lag_s=max_lag_s, host=host,
                    groups=self._groups_of(i, coordinator_shard),
                    partition_filter=self._owns_fn(i),
                    topology=self.pmap.cell(i),
                    follower_local_factory=factory,
                    follower_port_fn=port_for,
                    hwm_file=hwm_file_for(self._dir(f"broker-{i}")),
                    leader_addr=local_addresses[i])
                for rep in rset.followers.values():
                    # a promoted follower keeps answering cluster-shaped
                    # metadata
                    rep.server.cluster = ShardView(self.pmap, i)
                self.replica_sets[i] = rset
        for srv in self.servers:
            srv.admin = self  # the CLUSTER_ADMIN verbs land here
        if replicated:
            for i in range(self.n):
                local = ShardBroker(self._owns_fn(i), shard_id=i,
                                    store_dir=self._dir(f"broker-{i}-"
                                                        f"replica"),
                                    store_policy=store_policy)
                # only the coordinator shard's follower mirrors group
                # offsets: every other broker answers NOT_COORDINATOR
                rep = FollowerReplica(
                    local_addresses[i],
                    groups=self._groups_of(i, coordinator_shard),
                    host=host,
                    port=(base_port + self.n + i) if base_port else 0,
                    partition_filter=self._owns_fn(i), local=local)
                rep.server.cluster = ShardView(self.pmap, i)
                self.replicas[i] = rep
        self._compactors: list = []
        self.started = False

    def _owns_fn(self, shard: int):
        n = self.n
        return lambda t, p, _i=shard: p % n == _i

    def _dir(self, name: str) -> Optional[str]:
        return os.path.join(self._store_root, name) \
            if self._store_root else None

    def _groups_of(self, shard: int, coordinator_shard: int) -> tuple:
        return self._mirror_groups if shard == coordinator_shard else ()

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ClusterController":
        for srv in self.servers:
            srv.start()
        for rep in self.replicas:
            if rep is None:
                continue
            if self._replica_sync == "thread":
                rep.start()          # the sync loop and the server
            else:
                rep.server.start()   # serve only: the caller steps it
        for rset in self.replica_sets:
            if rset is not None:
                rset.start(sync=self._replica_sync)
        # durable shards compact their compacted topics in the background,
        # each only the partitions it leads
        if self._store_root:
            from ..store import StoreCompactor

            for b in self.brokers:
                if b.store is not None:
                    self._compactors.append(StoreCompactor(
                        b, interval_s=b.store.policy.compact_interval_s,
                    ).start())
        # every shard's epoch is a labelled series from boot, so a scrape
        # tells shards apart before any failover
        for i in range(self.n):
            obs_metrics.cluster_shard_epoch.set(self.pmap.epoch(i),
                                                shard=str(i))
        self.started = True
        return self

    def stop(self) -> None:
        for c in self._compactors:
            c.stop()
        self._compactors = []
        for group in (self.replicas, self.replica_sets):
            for unit in group:
                if unit is not None:
                    try:
                        unit.stop()
                    except (OSError, RuntimeError):
                        pass
        for i, srv in enumerate(self.servers):
            if not self._killed[i]:
                try:
                    srv.kill()
                except (OSError, RuntimeError):
                    pass
                self._killed[i] = True
        for b in self.brokers:
            try:
                b.close()
            except (OSError, RuntimeError):
                pass
        self.started = False

    def __enter__(self) -> "ClusterController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------- topics
    def create_topic(self, name: str, partitions: int = 1,
                     **retention) -> None:
        """Provision a topic cluster-wide: every shard broker and every
        follower learns the whole spec (mounting only its own partitions),
        and the map records the width for clients and assignors."""
        targets = list(self.brokers)
        # after a failover the serving broker is a promoted ex-follower in
        # neither list: a topic it never learns would answer UNKNOWN_TOPIC
        # on its shard forever (cluster servers do not auto-create)
        targets += [b for b in self.serving if b not in targets]
        targets += [rep.local for rep in self.replicas if rep is not None]
        for rset in self.replica_sets:
            if rset is not None:
                targets += [rep.local for rep in rset.followers.values()]
        for b in targets:
            b.create_topic(name, partitions=partitions, **retention)
        self.pmap.register_topic(name, partitions)

    # ------------------------------------------------------------ clients
    def bootstrap(self) -> str:
        return ",".join(self.pmap.addresses())

    def client(self, **kw):
        """A routing client over this controller's live map."""
        from .client import ClusterClient

        return ClusterClient(partition_map=self.pmap, **kw)

    def endpoints(self) -> Dict[str, str]:
        out = {f"broker-{i}": addr
               for i, addr in enumerate(self.pmap.addresses())}
        shard, addr = self.pmap.coordinator()
        out["coordinator"] = f"{addr} (shard {shard})"
        if self._store_root:
            out["store"] = self._store_root
        return out

    # ---------------------------------------------------------- failover
    def sync_replicas_once(self) -> int:
        """Step every live follower one replication round (the manual
        mode's deterministic runners); the records copied."""
        copied = 0
        for rep in self.replicas:
            if rep is not None and not rep.promoted:
                copied += rep.sync_once()
        for rset in self.replica_sets:
            if rset is not None:
                copied += rset.sync_once()
        return copied

    def kill_shard(self, shard: int) -> None:
        """Abruptly kill a shard's LEADER server (drills): its live
        connections are severed as a crashed process's would be."""
        if not self._killed[shard]:
            self.servers[shard].kill()
            self._killed[shard] = True

    def _note_move(self, shard: int, epoch: int, was_coordinator: bool):
        obs_metrics.cluster_shard_failovers.inc(shard=str(shard))
        obs_metrics.cluster_shard_epoch.set(epoch, shard=str(shard))
        if was_coordinator:
            obs_metrics.cluster_coordinator_moves.inc()

    def fail_shard(self, shard: int) -> str:
        """Promote the shard's follower into its serving leader at a
        bumped epoch and publish ONLY this shard's map entry; returns the
        new serving address.  In quorum mode the election is
        ISR-restricted: only a follower in sync on every partition may
        serve, so acked records cannot be lost."""
        rset = self.replica_sets[shard]
        rep = self.replicas[shard]
        if rset is None and rep is None:
            raise RuntimeError(
                f"shard {shard} has no follower (replicated=False): "
                f"nothing to promote")
        was_coordinator = self.pmap.coordinator()[0] == shard
        self.kill_shard(shard)
        epoch = self.pmap.epoch(shard) + 1
        if rset is not None:
            rset.promote(epoch)
            addr = f"{self._adv_host}:{rset.server.port}"
            self.serving[shard] = rset.leader
            self.servers[shard] = rset.server
            # the promoted server keeps the admin verbs
            rset.server.admin = self
        else:
            rep.promote(epoch)
            # the ADVERTISED address (promote reports the bind address)
            addr = f"{self._adv_host}:{rep.port}"
            self.serving[shard] = rep.local
        self.pmap.publish(shard, addr, epoch)
        # a coordinator shard moves WITH its follower: clients re-find it
        # at the promoted address, groups re-form (membership starts
        # empty), committed offsets were mirrored
        self._note_move(shard, epoch, was_coordinator)
        return addr

    # --------------------------------------------------------- elasticity
    def _require_rset(self, shard: int):
        if not 0 <= shard < self.n:
            raise ValueError(f"no shard {shard} (0..{self.n - 1})")
        rset = self.replica_sets[shard]
        if rset is None:
            raise RuntimeError(
                "elastic reassignment needs quorum mode: boot the "
                "cluster with replication_factor >= 2")
        return rset

    def add_broker(self, shard: int, store_dir: Optional[str] = None,
                   catch_up_timeout_s: float = 60.0,
                   retire_old: bool = True) -> dict:
        """Online reassignment: move ``shard``'s leadership onto a NEW
        broker node with no downtime.  The node joins as one more
        follower, bootstraps the whole log over the RAW_FETCH mirror,
        earns ISR admission, and only then is promoted at epoch+1: the
        shard's cell republishes, clients re-resolve on their next
        reconnect or fence, consumers keep their cursors (offsets are
        identical by the mirror contract), the other followers re-point
        through the cell, and the old leader retires (``retire_old``).
        Returns the reassignment report."""
        from ..replication.reassign import (CATCHING_UP, IN_SYNC, MOVED,
                                            RETIRED, ShardReassignment)

        rset = self._require_rset(shard)
        move = ShardReassignment(shard=shard,
                                 old_leader=self.pmap.leader(shard))
        self.reassignments.append(move)
        if store_dir is None:
            store_dir = self._dir(
                f"broker-{shard}-gen{self.pmap.epoch(shard) + 1}")
        # always a ShardBroker: a plain Broker would materialise unowned
        # partitions and serve them EMPTY after the promotion, where a
        # stale client must read the re-route signal
        local = ShardBroker(self._owns_fn(shard), shard_id=shard,
                            store_dir=store_dir,
                            store_policy=self._store_policy)
        try:
            rid = rset.add_follower(local=local, sync=self._replica_sync)
            move.target_rid = rid
            new_rep = rset.followers[rid]
            new_rep.server.cluster = ShardView(self.pmap, shard)
            # the mirror is live: an operator polling `status` watches
            # the lag shrink from here
            move.advance(CATCHING_UP)
            # ISR admission is the bar (lag inside the staleness window
            # on EVERY partition), not a zero lag at one instant
            deadline = time.monotonic() + catch_up_timeout_s
            while rid not in rset.state.isr_follower_ids():
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"new replica {rid} did not reach the ISR within "
                        f"{catch_up_timeout_s}s")
                if self._replica_sync == "manual":
                    rset.sync_once()
                else:
                    time.sleep(0.02)
            owns = self._owns_fn(shard)
            move.records_mirrored = sum(
                new_rep.local.end_offset(t, p)
                for t in new_rep.local.topics()
                for p in range(new_rep.local.topic(t).partitions)
                if owns(t, p))
            move.raw_mirrored = new_rep.raw_mirrored
            move.advance(IN_SYNC)
            self._move_leadership(shard, rid, move, retire_old=retire_old)
            move.advance(RETIRED if retire_old else MOVED)
        except Exception as e:
            move.fail(f"{type(e).__name__}: {e}")
            raise
        return move.to_dict()

    def drain_broker(self, shard: int, retire_old: bool = True) -> dict:
        """Drain ``shard``'s current leader: leadership moves to an
        EXISTING ISR follower (it already holds the log), the cell
        republishes at epoch+1 and the drained leader retires."""
        from ..replication.reassign import (IN_SYNC, MOVED, RETIRED,
                                            ShardReassignment)

        rset = self._require_rset(shard)
        move = ShardReassignment(shard=shard,
                                 old_leader=self.pmap.leader(shard))
        self.reassignments.append(move)
        try:
            rid = rset.elect()  # ISR-restricted
            move.target_rid = rid
            move.advance(IN_SYNC)  # in sync already: nothing to copy
            self._move_leadership(shard, rid, move, retire_old=retire_old)
            move.advance(RETIRED if retire_old else MOVED)
        except Exception as e:
            move.fail(f"{type(e).__name__}: {e}")
            raise
        return move.to_dict()

    def _await_mirrored(self, shard: int, rid: int, old_broker,
                        timeout_s: float = 30.0) -> None:
        """Block until replica ``rid`` holds the stepped-down leader's
        log to its end on every partition the shard owns (a deviation
        from ``iotml.cluster.controller``, which promotes a follower
        that may still lag by up to the ISR's staleness window)."""
        rset = self.replica_sets[shard]
        local = rset.followers[rid].local
        owns = self._owns_fn(shard)
        want = [(t, p, old_broker.end_offset(t, p))
                for t in old_broker.topics()
                for p in range(old_broker.topic(t).partitions)
                if owns(t, p)]

        def behind() -> list:
            out = []
            for t, p, end in want:
                try:
                    have = local.end_offset(t, p)
                except (KeyError, IndexError):  # not mirrored yet
                    have = 0
                if have < end:
                    out.append((t, p, have, end))
            return out

        deadline = time.monotonic() + timeout_s
        while behind():
            if time.monotonic() >= deadline:
                raise RuntimeError(f"replica {rid} did not mirror shard "
                                   f"{shard}'s log to its end within "
                                   f"{timeout_s}s: {behind()[:4]}")
            if self._replica_sync == "manual":
                rset.sync_once()
            else:
                time.sleep(0.002)

    def _move_leadership(self, shard: int, rid: int, move,
                         retire_old: bool = True) -> None:
        """The MOVED step of both verbs: promote ``rid`` at epoch+1,
        publish the cell, swap the serving state, retire the old leader
        (its epoch is stale, so it would answer FENCED anyway)."""
        from ..replication.reassign import MOVED

        rset = self.replica_sets[shard]
        old_server = self.servers[shard]
        old_broker = self.brokers[shard]
        was_coordinator = self.pmap.coordinator()[0] == shard
        epoch = self.pmap.epoch(shard) + 1
        # step down FIRST: from here the old server answers every write
        # with NOT_LEADER, so nothing lands in the retired log, not even
        # from unstamped producers; then the target mirrors the log to
        # the end the last admitted append left, so no record the old
        # leader took (and may yet ack) is missing on the new one
        try:
            if not old_server.step_down():
                raise RuntimeError(f"shard {shard}'s appends in flight did "
                                   f"not land")
            self._await_mirrored(shard, rid, old_broker)
        except Exception:
            old_server.retiring = False  # the old leader serves on
            raise
        rset.promote(epoch, rid=rid)
        addr = f"{self._adv_host}:{rset.server.port}"
        self.pmap.publish(shard, addr, epoch)
        self.serving[shard] = rset.leader
        self.servers[shard] = rset.server
        # the promoted broker replaces the retired one wherever the
        # controller fans out (create_topic, stop): the old one closes
        # below and must not take manifest writes or keep its store lock
        self.brokers[shard] = rset.leader
        # the next add-broker / drain-broker / status reaches it too
        rset.server.admin = self
        move.new_leader = addr
        move.epoch = epoch
        move.advance(MOVED)
        self._note_move(shard, epoch, was_coordinator)
        if not retire_old:
            return
        # the retirement is deferred a beat: the admin verb driving this
        # move may have come in on the very server being retired, and an
        # immediate kill would cut its connection before the response
        # flushes.  The retired broker's compactor stops before its store
        # closes.
        old_compactors = [c for c in self._compactors
                          if c.broker is old_broker]
        self._compactors = [c for c in self._compactors
                            if c.broker is not old_broker]

        def _retire(srv=old_server, b=old_broker,
                    compactors=old_compactors):
            time.sleep(0.25)
            try:
                srv.kill()
            except OSError:
                pass
            for c in compactors:
                try:
                    c.stop()
                except (OSError, RuntimeError):
                    pass
            try:
                # release the store's files and its directory lock
                b.close()
            except (OSError, RuntimeError):
                pass

        register_thread(threading.Thread(
            target=_retire, daemon=True,
            name=f"iotml-torch-retire-shard-{shard}")).start()
        self._killed[shard] = True

    def admin_command(self, command: str, args: dict) -> dict:
        """The CLUSTER_ADMIN dispatch (the wire server's ``admin`` hook):
        what ``python -m iotml_torch.cluster add-broker / drain-broker /
        status`` drive from another process."""
        if command == "status":
            doc = {"brokers": self.n,
                   "addresses": self.pmap.addresses(),
                   "epochs": [self.pmap.epoch(i) for i in range(self.n)],
                   "replication_factor": self.replication_factor,
                   "reassignments": [m.to_dict()
                                     for m in self.reassignments]}
            if self.replication_factor is not None:
                doc["shards"] = {str(i): rset.describe()
                                 for i, rset in enumerate(self.replica_sets)
                                 if rset is not None}
            return doc
        if command == "add-broker":
            return self.add_broker(
                shard=int(args.get("shard", 0)),
                store_dir=args.get("store_dir"),
                catch_up_timeout_s=float(args.get("catch_up_timeout_s",
                                                  60.0)))
        if command == "drain-broker":
            return self.drain_broker(shard=int(args.get("shard", 0)))
        raise ValueError(f"unknown admin command {command!r} "
                         f"(have: status, add-broker, drain-broker)")

    # -------------------------------------------------------- supervision
    def _shard_alive(self, shard: int) -> bool:
        host, port = _split(self.pmap.leader(shard))
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            return False

    def supervised(self, poll_interval_s: Optional[float] = None,
                   probe_failures: int = 3):
        """A ``Supervisor`` probing every shard leader over TCP; a dead
        leader of a shard with followers fires that shard's failover
        (``fail_shard``, ISR-restricted in quorum mode) and the rest of
        the cluster serves on.  The caller starts and stops it."""
        from ..supervise.supervisor import Supervisor

        sup = Supervisor(poll_interval_s=poll_interval_s,
                         name="cluster-supervisor")
        for i in range(self.n):
            kw = {}
            if self.replicas[i] is not None or \
                    self.replica_sets[i] is not None:
                kw["on_death"] = lambda _u, i=i: self.fail_shard(i)
            sup.add_probed(f"shard-{i}", (lambda i=i: self._shard_alive(i)),
                           probe_failures=probe_failures, **kw)
        return sup

    def await_failover(self, shard: int, timeout_s: float = 10.0) -> bool:
        """Block until the shard's map entry moves (a supervised failover
        completed) or the timeout passes."""
        cell = self.pmap.cell(shard)
        start_gen = cell.generation
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cell.generation != start_gen:
                return True
            time.sleep(0.02)
        return False
