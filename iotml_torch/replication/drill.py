"""Live replication drills (``iotml.replication.drill``'s copy): quorum
durability under real threads (``python -m iotml_torch.replication
drill``; the exit status is the verdict).

``double-fault``: a leader and two ISR followers serve sustained acks=all
load from real producer and consumer threads; one follower is killed
abruptly (the ISR must evict it and the quorum re-form), then the LEADER
is killed with no drain while a ``Supervisor`` TCP-probes it.  The
probe's on_death hook performs the ISR-restricted promotion at epoch+1
and publishes the ``Topology`` cell, a new follower heals the set, and
the stream finishes.  Invariants: zero acked-record loss (byte-identical
at identical offsets), the new leader in the ISR at the kill, every log
record consumed (by identity); SLO: time-to-promote.

``reassign``: a 3-broker quorum cluster under sustained acks=all produce
and committed consume runs ``add_broker`` (a new node bootstraps shard
1's log over the RAW_FETCH mirror, joins the ISR, takes leadership, the
old leader retires) and then ``drain_broker`` (shard 2's leadership moves
to an existing ISR follower), with the load never pausing.  Invariants:
zero lost and zero double-consumed records by identity, both moves
retired, the catch-up rode the raw mirror; SLOs: catch-up time, move
time and the consumer's longest stall.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from ..chaos.runner import Invariant, _record_commits
from ..chaos.scenarios import CARS_PER_TICK
from ..supervise.drill import DrillReport
from ..supervise.registry import register_thread
from ..supervise.supervisor import Supervisor
from ..supervise.topology import Topology

IN_TOPIC = "sensor-data"
GROUP = "repl-drill"


class _Load:
    """Sustained acks=all produce + committed consume on own threads,
    with redelivery on every ConnectionError-family signal and the
    consumer's stall clock running — the background traffic both
    drills must never disrupt."""

    def __init__(self, producer, consumer, parts: int,
                 topic: str = IN_TOPIC, tick_sleep_s: float = 0.01):
        self.producer = producer
        self.consumer = consumer
        self.parts = parts
        self.topic = topic
        self.tick_sleep_s = tick_sleep_s
        self.acked: Dict[Tuple[int, int], bytes] = {}
        #: first-seen value per (partition, offset): delivery is
        #: at-least-once across failovers (a commit lost to a dying
        #: leader re-delivers its batch), so EFFECTS are counted by
        #: record identity and raw re-deliveries separately
        self.consumed: Dict[Tuple[int, int], bytes] = {}
        self.redelivered = 0
        self.rewinds = 0
        self.refused = 0          # NotEnoughReplicas windows observed
        self.produce_errors: List[str] = []  # exhausted redeliveries
        self.max_stall_s = 0.0
        self._stop = threading.Event()
        self._stop_produce = threading.Event()
        self._threads: List[threading.Thread] = []
        self._tick = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------ bodies
    def _produce_loop(self) -> None:
        while not self._stop_produce.is_set():
            tick = self._tick
            self._tick += 1
            for p in range(self.parts):
                values = [f"t{tick}r{i}p{p}".encode()
                          for i in range(CARS_PER_TICK // self.parts)]
                last_err: Optional[Exception] = None
                for _attempt in range(40):
                    if self._stop_produce.is_set():
                        return
                    try:
                        last = self.producer.produce_many(
                            self.topic, [(None, v, 0) for v in values],
                            partition=p, timeout_ms=8000)
                    except ConnectionError as e:
                        # failover/reassignment in flight (incl.
                        # NotEnoughReplicas + ProduceTimedOut):
                        # redeliver — acks=all means only the ACK
                        # defines existence
                        self.refused += 1
                        last_err = e
                        time.sleep(0.1)
                        continue
                    with self._lock:
                        for i, v in enumerate(values):
                            self.acked[(p, last - len(values) + 1 + i)] \
                                = v
                    break
                else:
                    # NEVER drop a batch silently: a weakened load
                    # would let the delivery invariants pass vacuously
                    # — surface the failure as its own invariant and
                    # stop producing (the drill fails loudly)
                    self.produce_errors.append(
                        f"partition {p}: undeliverable after 40 "
                        f"redelivery attempts: {last_err}")
                    self._stop_produce.set()
                    return
            time.sleep(self.tick_sleep_s)

    def _consume_loop(self) -> None:
        last_ok = time.monotonic()
        while not self._stop.is_set():
            try:
                batch = self.consumer.poll(4096)
                if batch:
                    with self._lock:
                        for m in batch:
                            key = (m.partition, m.offset)
                            if key in self.consumed:
                                self.redelivered += 1
                            else:
                                self.consumed[key] = m.value
                    # commit INSIDE the failover guard: a leader dying
                    # between poll and commit is the drill's point —
                    # the rewind re-delivers this batch (at-least-once)
                    # and identity dedup above keeps effects exact-once
                    self.consumer.commit()
            except ConnectionError:
                self.consumer.rewind_to_committed()
                self.rewinds += 1
                time.sleep(0.02)
                continue
            now = time.monotonic()
            self.max_stall_s = max(self.max_stall_s, now - last_ok)
            last_ok = now
            if not batch:
                time.sleep(0.002)

    # --------------------------------------------------------- lifecycle
    def start(self) -> "_Load":
        for name, body in (("producer", self._produce_loop),
                           ("consumer", self._consume_loop)):
            t = register_thread(threading.Thread(
                target=body, daemon=True,
                name=f"iotml-repl-drill-{name}"))
            t.start()
            self._threads.append(t)
        return self

    def stop_producer(self) -> None:
        """Quiesce the write side (the consumer keeps draining — final
        drains need a stable log end, not a dead consumer)."""
        self._stop_produce.set()
        self._threads[0].join(timeout=15)

    def stop(self) -> None:
        self._stop_produce.set()
        self._stop.set()
        for t in self._threads:
            t.join(timeout=15)

    def drain_to_end(self, end_offsets: Dict[int, int],
                     timeout_s: float = 30.0) -> None:
        """Keep the consumer thread running until it has covered every
        offset below `end_offsets` (post-load final drain)."""
        want = {(p, o) for p, end in end_offsets.items()
                for o in range(end)}
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                have = set(self.consumed)
            if want <= have:
                return
            time.sleep(0.05)

    # --------------------------------------------------------- verdicts
    def delivery_invariants(self, end_offsets: Dict[int, int]
                            ) -> List[Invariant]:
        with self._lock:
            acked = dict(self.acked)
            seen = set(self.consumed)
        expected = {(p, o) for p, end in end_offsets.items()
                    for o in range(end)}
        missing = expected - seen
        return [
            Invariant(
                "zero_lost",
                not missing,
                f"all {len(expected)} log records consumed exactly "
                f"once by identity ({self.redelivered} at-least-once "
                f"re-deliveries absorbed)" if not missing else
                f"{len(missing)} records NEVER consumed "
                f"(e.g. {sorted(missing)[:3]})"),
            Invariant(
                "acked_all_covered",
                all(k in expected for k in acked),
                f"{len(acked)} acks all inside the final log"),
            Invariant(
                "producer_never_gave_up",
                not self.produce_errors,
                "every scheduled batch was eventually acked "
                f"({self.refused} redelivery windows ridden out)"
                if not self.produce_errors else
                "; ".join(self.produce_errors)),
        ]


def _end_offsets(broker_like, topic: str, parts: int) -> Dict[int, int]:
    return {p: broker_like.end_offset(topic, p) for p in range(parts)}


def drill_double_fault(seed: int = 7, records: int = 1500,
                       slo_promote_s: float = 10.0) -> DrillReport:
    """Leader + one follower killed mid-epoch under live acks=all load;
    supervised ISR-restricted promotion, elastic heal, zero acked loss."""
    from ..stream.broker import Broker
    from ..stream.consumer import StreamConsumer
    from ..stream.kafka_wire import KafkaWireBroker, KafkaWireServer
    from .manager import ReplicaSet

    parts = 2
    leader = Broker()
    leader.create_topic(IN_TOPIC, partitions=parts)
    commit_log: List[tuple] = []
    _record_commits(leader, commit_log, "leader")
    lsrv = KafkaWireServer(leader, epoch=0).start()
    rs = ReplicaSet(leader_broker=leader, leader_server=lsrv,
                    n_followers=2, min_isr=2, max_lag_s=0.4,
                    topics=[IN_TOPIC], groups=(GROUP,))
    topo = Topology(f"127.0.0.1:{lsrv.port}", epoch=0,
                    fallback=[f"127.0.0.1:{rep.port}"
                              for rep in rs.followers.values()])
    rs.start(sync="thread")
    assert rs.await_isr(3, IN_TOPIC, 0, timeout_s=15), \
        "ISR never formed"

    producer = KafkaWireBroker(topo.leader, client_id="drill-producer",
                               topology=topo)
    consumer_client = KafkaWireBroker(topo.leader,
                                      client_id="drill-consumer",
                                      topology=topo)
    consumer = StreamConsumer(
        consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
        group=GROUP)
    load = _Load(producer, consumer, parts).start()

    state: dict = {}
    promoted = threading.Event()

    def failover(_unit):
        state["isr_at_kill"] = sorted(rs.state.isr_follower_ids())
        state["acked_at_kill"] = dict(load.acked)
        rid, addr = rs.promote(topo.epoch + 1)  # ISR-restricted
        state["promoted_rid"] = rid
        topo.publish(addr, topo.epoch + 1)
        state["t_promoted"] = time.monotonic()
        promoted.set()

    def leader_probe():
        import socket

        s = socket.create_connection(("127.0.0.1", lsrv.port),
                                     timeout=0.25)
        s.close()
        return True

    sup = Supervisor(poll_interval_s=0.05, name="repl-drill-supervisor")
    sup.add_probed("leader-broker", leader_probe, on_death=failover,
                   probe_failures=2)
    sup.start()

    killed_follower: Optional[int] = None
    healed_rid: Optional[int] = None
    t_kill = None
    try:
        # phase 1: a third of the stream under the full-width quorum
        target = max(records // 3, CARS_PER_TICK)
        deadline = time.monotonic() + 30
        while len(load.acked) < target and time.monotonic() < deadline:
            time.sleep(0.02)
        # fault 1: one follower dies abruptly; the ISR must evict it
        killed_follower = sorted(rs.followers)[0]
        rs.kill_follower(killed_follower)
        state["t_follower_kill"] = time.monotonic()
        target = max(2 * records // 3, 2 * CARS_PER_TICK)
        deadline = time.monotonic() + 30
        while len(load.acked) < target and time.monotonic() < deadline:
            time.sleep(0.02)
        evicted = killed_follower not in rs.state.isr_follower_ids()
        # fault 2: the leader dies mid-epoch, NO drain
        t_kill = time.monotonic()
        lsrv.kill()
        assert promoted.wait(timeout=30), "supervisor never promoted"
        # elastic heal: re-form the 2-wide quorum so acks=all resumes
        if killed_follower is not None:
            rs.retire_follower(killed_follower)
        healed_rid = rs.add_follower(sync="thread")
        deadline = time.monotonic() + 30
        while healed_rid not in rs.state.isr_follower_ids() and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        # phase 3: finish the stream on the promoted quorum
        target = records
        deadline = time.monotonic() + 30
        while len(load.acked) < target and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        load.stop_producer()
        sup.stop()
        ends = _end_offsets(rs.leader, IN_TOPIC, parts)
        load.drain_to_end(ends)
        load.stop()
        for c in (producer, consumer_client):
            try:
                c.close()
            except OSError:
                pass
        rs.stop()

    # zero acked loss, byte-identical, for everything acked BEFORE the
    # leader death (later acks are trivially on the promoted log)
    lost = []
    for (p, off), value in sorted(state.get("acked_at_kill",
                                            {}).items()):
        got = {m.offset: m.value
               for m in rs.leader.fetch_tail(IN_TOPIC, p, off, 1)}
        if got.get(off) != value:
            lost.append((p, off))
    promote_s = state.get("t_promoted", float("inf")) - \
        (t_kill or float("inf"))
    invariants = load.delivery_invariants(ends) + [
        Invariant(
            "zero_acked_loss",
            not lost and bool(state.get("acked_at_kill")),
            f"all {len(state.get('acked_at_kill', {}))} pre-kill acks "
            f"byte-identical on the promoted log" if not lost else
            f"{len(lost)} ACKED RECORDS LOST (e.g. {lost[:3]})"),
        Invariant(
            "new_leader_in_isr",
            state.get("promoted_rid") in state.get("isr_at_kill", ()),
            f"promoted replica {state.get('promoted_rid')} was in the "
            f"ISR {state.get('isr_at_kill')} at the kill"),
        Invariant(
            "follower_evicted",
            evicted,
            f"dead follower {killed_follower} left the ISR within the "
            f"staleness window" if evicted else
            f"dead follower {killed_follower} still in the ISR"),
        Invariant(
            "quorum_healed",
            healed_rid is not None and
            healed_rid in rs.state.isr_follower_ids(),
            f"replica {healed_rid} bootstrapped and re-joined the ISR "
            f"(raw-mirrored "
            f"{getattr(rs.followers.get(healed_rid), 'raw_mirrored', 0)}"
            f" records)"),
        Invariant(
            "promote_slo",
            promote_s <= slo_promote_s,
            f"time-to-promote {promote_s:.2f}s <= {slo_promote_s}s"),
    ]
    return DrillReport(
        drill="double-fault", seed=seed, records=records,
        published=len(load.acked), scored=len(load.consumed),
        restarts={}, slos={"time_to_promote_s": promote_s,
                           "consumer_max_stall_s": load.max_stall_s},
        invariants=invariants, injected={})


def drill_reassign(seed: int = 7, records: int = 1500,
                   slo_catch_up_s: float = 30.0,
                   slo_stall_s: float = 8.0) -> DrillReport:
    """add-broker, reassign, drain-broker under sustained load with no
    consumer disruption and a RAW_FETCH catch-up."""
    from ..cluster import ClusterController
    from ..stream.consumer import StreamConsumer

    parts = 6
    ctl = ClusterController(brokers=3, replication_factor=3, min_isr=2,
                            replica_sync="thread", max_lag_s=0.4)
    ctl.start()
    load = None
    client = consumer_client = None
    reports: List[dict] = []
    ends: Dict[int, int] = {}

    def await_acked(target: int) -> None:
        deadline = time.monotonic() + 30
        while len(load.acked) < target and time.monotonic() < deadline:
            time.sleep(0.02)

    try:
        ctl.create_topic(IN_TOPIC, partitions=parts)
        for i in range(3):
            assert ctl.replica_sets[i].await_isr(
                3, IN_TOPIC, i, timeout_s=15), f"shard {i} ISR"
        client = ctl.client(client_id="reassign-producer")
        consumer_client = ctl.client(client_id="reassign-consumer")
        consumer = StreamConsumer(
            consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
            group=GROUP)
        load = _Load(client, consumer, parts).start()
        # the load establishes, then shard 1 moves onto a NEW node while
        # producing and consuming go on
        await_acked(max(records // 3, CARS_PER_TICK))
        reports.append(ctl.add_broker(shard=1,
                                      catch_up_timeout_s=slo_catch_up_s))
        await_acked(max(2 * records // 3, 2 * CARS_PER_TICK))
        # then shard 2's leader drains onto an existing ISR follower
        reports.append(ctl.drain_broker(shard=2))
        await_acked(records)
    finally:
        if load is not None:
            load.stop_producer()
            ends = {p: ctl.serving[ctl.pmap.shard_for(IN_TOPIC, p)]
                    .end_offset(IN_TOPIC, p) for p in range(parts)}
            load.drain_to_end(ends)
            load.stop()
        for c in (client, consumer_client):
            if c is not None:
                try:
                    c.close()
                except OSError:
                    pass
        ctl.stop()

    add, drain = reports[0], reports[1]
    catch_up = add.get("catch_up_s") or float("inf")
    invariants = load.delivery_invariants(ends) + [
        Invariant(
            "reassign_completed",
            add.get("state") == "retired" and
            drain.get("state") == "retired",
            f"add-broker -> {add.get('state')} (epoch "
            f"{add.get('epoch')}), drain-broker -> "
            f"{drain.get('state')} (epoch {drain.get('epoch')})"),
        Invariant(
            "catch_up_via_raw_fetch",
            add.get("raw_mirrored", 0) > 0,
            f"new replica raw-mirrored {add.get('raw_mirrored')} of "
            f"{add.get('records_mirrored')} records over RAW_FETCH"),
        Invariant(
            "catch_up_slo",
            catch_up <= slo_catch_up_s,
            f"bootstrap->ISR {catch_up:.2f}s <= {slo_catch_up_s}s"),
        Invariant(
            "consumer_disruption_slo",
            load.max_stall_s <= slo_stall_s,
            f"longest consumer stall {load.max_stall_s:.2f}s <= "
            f"{slo_stall_s}s across both moves (reconnect-sized, not "
            f"outage-sized)"),
    ]
    return DrillReport(
        drill="reassign", seed=seed, records=records,
        published=len(load.acked), scored=len(load.consumed),
        restarts={},
        slos={"catch_up_s": catch_up, "move_s": add.get("move_s"),
              "consumer_max_stall_s": load.max_stall_s},
        invariants=invariants, injected={})


DRILLS = {
    "double-fault": drill_double_fault,
    "reassign": drill_reassign,
}
