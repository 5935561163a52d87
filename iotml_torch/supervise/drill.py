"""Drill reports and the live chaos drills (``iotml.supervise.drill``'s
copy): the supervised runtime under real fire.

Each drill runs real components on real threads (wire servers,
background replication, a supervised scorer and trainer on the card
unless the caller names another device), injects the failure (leader
kill, broker crash, MQTT flap, scorer crash) through the faultpoints and
kill switches the chaos package compiles in, and asserts two things:

- the **delivery invariants** (commits monotonic, at-least-once counts,
  the final commit at the log end, predictions bounded);
- **recovery SLOs**: time-to-promote, time-to-first-post-failover score,
  input loss bounded by the replication lag at the kill, supervised
  units back to running without a hand on them.

``python -m iotml_torch.supervise drill`` runs them (the verdict is the
exit status).  ``DrillReport`` (one drill's counts, SLOs and verdicts as
JSON or text lines), ``CARS_PER_TICK`` and ``_wait`` serve the online
and alert-burn drills too.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import threading
import time
from typing import Dict, List, Optional

from ..chaos import faults, scenarios
from ..chaos.runner import (GROUP, IN_TOPIC, PRED_TOPIC, Invariant,
                            _check_commits_monotonic, _record_commits)
from ..utils.device import DeviceLike
from .supervisor import Supervisor
from .topology import Topology

#: records per simulated fleet tick (shared with the chaos scenarios)
CARS_PER_TICK = scenarios.CARS_PER_TICK


@dataclasses.dataclass
class DrillReport:
    drill: str
    seed: int
    records: int
    published: int
    scored: int
    restarts: Dict[str, int]
    slos: Dict[str, Optional[float]]
    invariants: List[Invariant]
    injected: Dict[str, int]

    @property
    def ok(self) -> bool:
        return all(i.ok for i in self.invariants)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d

    def lines(self) -> List[str]:
        out = [f"drill={self.drill} seed={self.seed} "
               f"records={self.records} published={self.published} "
               f"scored={self.scored}"]
        for k, v in sorted(self.slos.items()):
            # keys ending in _s are wall-clock seconds; others are
            # record counts / quality numbers (the online drill's
            # record-based SLOs) and carry no unit suffix
            unit = "s" if k.endswith("_s") else ""
            out.append(f"  slo {k}: "
                       + ("n/a" if v is None else f"{v:.3f}{unit}"))
        for k, v in sorted(self.restarts.items()):
            out.append(f"  restarts {k}: {v}")
        for k, v in sorted(self.injected.items()):
            out.append(f"  injected {k}: {v}")
        out += ["  " + i.verdict() for i in self.invariants]
        out.append(("DRILL PASS" if self.ok else "DRILL FAIL")
                   + f" ({self.drill})")
        return out


# ------------------------------------------------------------- helpers
def _make_scorer(out_broker, consumer, device: DeviceLike = None):
    """The drills' scorer: fresh weights from seed 0, on ``device``."""
    from ..data.dataset import SensorBatches
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..serve.scorer import StreamScorer
    from ..stream.producer import OutputSequence
    from ..train.loop import Trainer

    trainer = Trainer(CAR_AUTOENCODER, device=device)
    trainer._ensure_state()
    batches = SensorBatches(consumer, batch_size=100)
    out = OutputSequence(out_broker, PRED_TOPIC, partition=0)
    return StreamScorer(CAR_AUTOENCODER, trainer.state.params, batches, out,
                        device=device)


def _scorer_unit_loop(scorer, consumer, state):
    """The supervised scorer body: a (re)started incarnation rewinds to
    the committed offsets, as a restarted process would; a connection
    loss rewinds and retries; a heartbeat a healthy round."""

    def loop(unit):
        # the previous incarnation may have died mid-drain with rows
        # polled but uncommitted: resume from the commit table, and drop
        # the outputs of rows that will be scored again (JAX's loop keeps
        # them, and a flush whose response the dying broker lost then
        # lands twice more: more predictions than scored rows)
        scorer.out.discard()
        consumer.rewind_to_committed()
        while not unit.should_stop():
            try:
                n = scorer.score_available()
            except ConnectionError:
                # a failover in flight: the client has re-resolved;
                # rewind and redeliver
                scorer.out.discard()
                consumer.rewind_to_committed()
                state["rewinds"] += 1
                time.sleep(0.02)
                continue
            unit.heartbeat()
            if n:
                state["last_score_t"] = time.monotonic()
                if state.get("t_kill") is not None and \
                        state.get("t_first_score_after_kill") is None:
                    state["t_first_score_after_kill"] = time.monotonic()
            else:
                time.sleep(0.005)

    return loop


def _wait(cond, timeout_s: float, interval_s: float = 0.02) -> bool:
    """Poll ``cond`` until it holds or ``timeout_s`` passes; its last
    value."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval_s)
    return cond()


# ------------------------------------------------------ leader-kill
def drill_leader_kill(seed: int = 7, records: int = 1500,
                      slo_promote_s: float = 10.0,
                      slo_first_score_s: float = 20.0,
                      device: DeviceLike = None) -> DrillReport:
    """Fenced leader failover, live: a leader+follower wire topology
    with the fleet pumping through it, the leader killed mid-drain, the
    supervisor detecting the death and promoting the follower at a
    bumped epoch, scorer and trainer resuming on their own — and a
    resurrected old leader fenced by its stale epoch."""
    import tempfile

    from ..core.schema import KSQL_CAR_SCHEMA
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..ops.avro import AvroCodec
    from ..ops.framing import frame
    from ..stream.broker import Broker
    from ..stream.consumer import StreamConsumer
    from ..stream.kafka_wire import (FencedEpochError, KafkaWireBroker,
                                     KafkaWireServer)
    from ..stream.replica import FollowerReplica

    if records < 3 * CARS_PER_TICK:
        raise ValueError(f"leader-kill needs >= {3 * CARS_PER_TICK} "
                         f"records (kill lands mid-drain), got {records}")
    eng = faults.arm(faults.ChaosEngine(()))  # counts any stray points
    leader = Broker()
    commit_log: List[tuple] = []
    _record_commits(leader, commit_log, "leader")
    lsrv = KafkaWireServer(leader, epoch=0).start()
    rep = FollowerReplica(f"127.0.0.1:{lsrv.port}",
                          topics=[IN_TOPIC, PRED_TOPIC],
                          groups=(GROUP, "drill-trainer"),
                          poll_interval_s=0.005,
                          commit_interval_s=0.05)
    _record_commits(rep.local, commit_log, "follower")
    topo = Topology(f"127.0.0.1:{lsrv.port}", epoch=0,
                    fallback=[f"127.0.0.1:{rep.port}"])
    state: dict = {"rewinds": 0, "t_kill": None,
                   "t_first_score_after_kill": None,
                   "trainer_rounds": []}
    promoted = threading.Event()

    def failover(_unit):
        # the supervisor's on_death hook: promote at a bumped epoch,
        # publish the new topology — clients re-resolve from here on
        new_epoch = topo.epoch + 1
        addr = rep.promote(new_epoch)
        state["replicated_at_promote"] = sum(
            rep.local.end_offset(IN_TOPIC, p)
            for p in range(rep.local.topic(IN_TOPIC).partitions))
        topo.publish(addr, new_epoch)
        state["t_promoted"] = time.monotonic()
        promoted.set()

    def leader_probe():
        s = socket.create_connection(("127.0.0.1", lsrv.port),
                                     timeout=0.25)
        s.close()
        return True

    producer = KafkaWireBroker(f"127.0.0.1:{lsrv.port}",
                               client_id="drill-devsim", topology=topo)
    consumer_client = KafkaWireBroker(f"127.0.0.1:{lsrv.port}",
                                      client_id="drill-scorer",
                                      topology=topo)
    parts = 2
    producer.create_topic(IN_TOPIC, partitions=parts)
    producer.create_topic(PRED_TOPIC, partitions=1)
    rep.start()
    consumer = StreamConsumer(
        consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
        group=GROUP)
    scorer = _make_scorer(producer, consumer, device)

    sup = Supervisor(poll_interval_s=0.05, name="drill-supervisor")
    sup.add_probed("leader-broker", leader_probe, on_death=failover,
                   probe_failures=2)
    sup.add_loop("scorer", _scorer_unit_loop(scorer, consumer, state),
                 heartbeat_timeout_s=30.0)

    tmp = tempfile.TemporaryDirectory(prefix="iotml_drill_")

    def trainer_loop(unit):
        # a FRESH trainer per incarnation: the supervised-restart story
        # is a crashed trainer coming back `from_committed` against the
        # promoted leader — resumed offsets are the mirrored commits
        from ..train.artifacts import ArtifactStore
        from ..train.live import ContinuousTrainer

        client = KafkaWireBroker(topo.leader, client_id="drill-trainer",
                                 topology=topo)
        ct = ContinuousTrainer(
            client, IN_TOPIC, ArtifactStore(tmp.name),
            group="drill-trainer", batch_size=25, take_batches=2,
            epochs_per_round=1, only_normal=False, device=device)
        unit.trainer = ct  # post-drill introspection

        def on_round(stats):
            unit.heartbeat()
            state["trainer_rounds"].append(
                (time.monotonic(), stats["round"]))

        ct.run(stop=unit.should_stop, poll_interval_s=0.01,
               on_round=on_round)

    sup.add_loop("trainer", trainer_loop, heartbeat_timeout_s=60.0,
                 max_restarts=8)
    sup.start()

    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed))
    codec = AvroCodec(KSQL_CAR_SCHEMA)
    published = 0
    killed = False
    kill_at = max(CARS_PER_TICK, records // 2)
    ticks = max(1, -(-records // CARS_PER_TICK))
    try:
        for _ in range(ticks):
            if not killed and published >= kill_at:
                # producer quiescent while we snapshot the loss window,
                # so `loss <= lag` is measured, not hoped: nothing is
                # produced between the snapshot and the kill
                state["lag_at_kill"] = sum(rep.lag().values())
                state["published_pre_kill"] = published
                state["t_kill"] = time.monotonic()
                lsrv.kill()
                killed = True
            cols = gen.step_columns()
            entries = [
                (gen.scenario.car_id(i).encode(),
                 frame(codec.encode(gen.row_record(cols, i,
                                                   KSQL_CAR_SCHEMA))), 0)
                for i in range(len(cols["car"]))]
            for attempt in range(100):
                try:
                    producer.produce_many(IN_TOPIC, entries)
                    break
                except (FencedEpochError, ConnectionError):
                    # dead or fenced party: topology re-resolves inside
                    # the client; redeliver (kills land between ticks,
                    # so the dead leader never half-applied this batch)
                    if attempt == 99:
                        raise
                    time.sleep(0.05)
            published += len(entries)
        promoted_ok = promoted.wait(timeout=slo_promote_s + 5)
        # drain: everything the promoted log retained must end up scored
        # and committed without anyone touching the scorer
        _wait(lambda: state.get("t_first_score_after_kill") is not None,
              slo_first_score_s + 5)
        _wait(lambda: all(
            rep.local.committed(GROUP, IN_TOPIC, p)
            == rep.local.end_offset(IN_TOPIC, p) for p in range(parts)),
            20.0)
        trainer_resumed = _wait(
            lambda: any(t > state["t_kill"]
                        for t, _ in state["trainer_rounds"]),
            25.0) if killed else False

        # ---------------------------------------- resurrected old leader
        fence_ok = False
        if promoted_ok:
            # the resurrection test: the OLD leader's broker comes back
            # serving at its stale epoch 0; a current-epoch client's
            # produce AND commit against it must both answer FENCED
            zombie = KafkaWireServer(leader, epoch=0).start()
            try:
                probe_client = KafkaWireBroker(
                    f"127.0.0.1:{zombie.port}",
                    client_id="drill-zombie-probe", epoch=topo.epoch)
                try:
                    probe_client.produce(IN_TOPIC, b"split-brain")
                except FencedEpochError:
                    try:
                        probe_client.commit(GROUP, IN_TOPIC, 0, 1)
                    except FencedEpochError:
                        fence_ok = True
                probe_client.close()
            finally:
                zombie.shutdown()
                zombie.server_close()
    finally:
        sup.stop()
        for c in (producer, consumer_client):
            try:
                c.close()
            except OSError:
                pass
        if not rep.promoted:
            rep.stop()
        else:
            rep.server.shutdown()
            rep.server.server_close()
        if not killed:
            lsrv.kill()
        faults.disarm()
        tmp.cleanup()

    # ------------------------------------------------------- verdicts
    t_promote = (state.get("t_promoted", 0) - state["t_kill"]) \
        if promoted_ok and killed else None
    t_score = (state["t_first_score_after_kill"] - state["t_kill"]) \
        if state.get("t_first_score_after_kill") and killed else None
    loss = (state.get("published_pre_kill", 0)
            - state.get("replicated_at_promote", 0)) if promoted_ok else -1
    lag = state.get("lag_at_kill", -1)
    retained = sum(rep.local.end_offset(IN_TOPIC, p) for p in range(parts))
    pred_end = rep.local.end_offset(PRED_TOPIC, 0)
    invariants = [
        Invariant("promoted_within_slo",
                  killed and promoted_ok and t_promote is not None
                  and t_promote <= slo_promote_s,
                  f"leader killed -> follower promoted in "
                  f"{t_promote:.3f}s (slo {slo_promote_s}s)"
                  if t_promote is not None else "promotion never happened"),
        Invariant("first_score_within_slo",
                  t_score is not None and t_score <= slo_first_score_s,
                  f"first post-failover score after {t_score:.3f}s "
                  f"(slo {slo_first_score_s}s)" if t_score is not None
                  else "scorer never scored after the kill"),
        Invariant("promotion_loss_bounded",
                  promoted_ok and 0 <= loss <= max(lag, 0),
                  f"unreplicated input at promotion: {loss} records "
                  f"within measured lag {lag}" if promoted_ok else
                  "no promotion to measure"),
        Invariant("trainer_resumed",
                  trainer_resumed,
                  "trainer completed rounds after the failover without "
                  "manual intervention" if trainer_resumed else
                  "no trainer round completed after the kill"),
        _check_commits_monotonic(commit_log),
        Invariant("final_commit_at_end",
                  all(rep.local.committed(GROUP, IN_TOPIC, p)
                      == rep.local.end_offset(IN_TOPIC, p)
                      for p in range(parts)),
                  "committed == promoted log end on every partition"),
        Invariant("all_retained_scored",
                  scorer.scored >= retained,
                  f"scored {scorer.scored} >= {retained} records the "
                  f"promoted log retained (at-least-once, duplicates "
                  f"allowed)"),
        Invariant("predictions_bounded_gap_free",
                  pred_end <= scorer.scored and not scorer.out._buf,
                  f"predictions end {pred_end} <= scored "
                  f"{scorer.scored}, output buffer drained "
                  f"(OutputSequence's gap check never tripped)"),
        Invariant("old_leader_fenced",
                  fence_ok,
                  "resurrected old leader rejected epoch-stamped "
                  "produce AND commit" if fence_ok else
                  "stale leader accepted writes — SPLIT LOG"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"),
    ]
    return DrillReport(
        drill="leader-kill", seed=seed, records=records,
        published=published, scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={"time_to_promote_s": t_promote,
              "time_to_first_post_failover_score_s": t_score},
        invariants=invariants,
        injected=dict(sorted(eng.injected.items())))


# ----------------------------------------------------- broker-restart
def drill_broker_restart(seed: int = 7, records: int = 1000,
                         slo_restart_s: float = 10.0,
                         slo_first_score_s: float = 20.0,
                         device: DeviceLike = None) -> DrillReport:
    """Durable-broker crash restart, live: a wire-served broker mounted
    on the segmented store (fsync=always) dies mid-write (connections
    severed, torn frame on the active segment), the supervisor's probe
    detects the death and its on_death hook REMOUNTS the store — crash
    recovery truncates the torn tail — and serves it at a bumped epoch;
    the producer and the supervised scorer resume unaided with ZERO
    acked-record loss and cursors at the persisted committed offsets."""
    import tempfile

    from ..core.schema import KSQL_CAR_SCHEMA
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..ops.avro import AvroCodec
    from ..ops.framing import frame
    from ..store import StorePolicy
    from ..stream.broker import Broker
    from ..stream.consumer import StreamConsumer
    from ..stream.kafka_wire import (FencedEpochError, KafkaWireBroker,
                                     KafkaWireServer)

    if records < 3 * CARS_PER_TICK:
        raise ValueError(f"broker-restart needs >= {3 * CARS_PER_TICK} "
                         f"records (kill lands mid-stream), got {records}")
    eng = faults.arm(faults.ChaosEngine(()))
    tmp = tempfile.TemporaryDirectory(prefix="iotml_drill_store_")
    policy_kw = dict(fsync="always", segment_bytes=256 * 1024)
    commit_log: List[tuple] = []
    state: dict = {"rewinds": 0, "t_kill": None, "t_restarted": None,
                   "t_first_score_after_kill": None, "torn": 0,
                   "acked": {}, "truncated": -1, "recovered_end": {}}
    restarted = threading.Event()

    live = {"broker": Broker(store_dir=tmp.name,
                             store_policy=StorePolicy(**policy_kw))}
    _record_commits(live["broker"], commit_log, "store")
    live["srv"] = KafkaWireServer(live["broker"], epoch=0).start()
    topo = Topology(f"127.0.0.1:{live['srv'].port}", epoch=0)

    def broker_probe():
        s = socket.create_connection(
            ("127.0.0.1", live["srv"].port), timeout=0.25)
        s.close()
        return True

    def restart(_unit):
        # the supervisor's on_death hook — what a kubelet restart does,
        # minus the node: remount the store dir (recovery truncates the
        # torn frame the kill left), serve at a bumped epoch, publish
        new_epoch = topo.epoch + 1
        broker = Broker(store_dir=tmp.name,
                        store_policy=StorePolicy(**policy_kw))
        _record_commits(broker, commit_log, "store")
        state["truncated"] = broker.store.recovered_truncated_bytes()
        state["recovered_end"] = {
            (t, p): broker.end_offset(t, p)
            for (t, p) in state["acked"]}
        srv = KafkaWireServer(broker, epoch=new_epoch).start()
        live["broker"], live["srv"] = broker, srv
        topo.publish(f"127.0.0.1:{srv.port}", new_epoch)
        state["t_restarted"] = time.monotonic()
        restarted.set()

    producer = KafkaWireBroker(topo.leader, client_id="drill-devsim",
                               topology=topo)
    consumer_client = KafkaWireBroker(topo.leader, client_id="drill-scorer",
                                      topology=topo)
    parts = 2
    producer.create_topic(IN_TOPIC, partitions=parts)
    producer.create_topic(PRED_TOPIC, partitions=1)
    consumer = StreamConsumer(
        consumer_client, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
        group=GROUP)
    scorer = _make_scorer(producer, consumer, device)

    sup = Supervisor(poll_interval_s=0.05, name="drill-supervisor")
    sup.add_probed("durable-broker", broker_probe, on_death=restart,
                   probe_failures=2)
    sup.add_loop("scorer", _scorer_unit_loop(scorer, consumer, state),
                 heartbeat_timeout_s=30.0)
    sup.start()

    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed))
    codec = AvroCodec(KSQL_CAR_SCHEMA)
    published = 0
    killed = False
    kill_at = max(CARS_PER_TICK, records // 2)
    ticks = max(1, -(-records // CARS_PER_TICK))
    try:
        for _ in range(ticks):
            if not killed and published >= kill_at:
                # mid-write death: snapshot what was ACKED (everything —
                # fsync=always means ack follows the sync), leave a torn
                # frame on the active segment, sever every connection
                broker = live["broker"]
                for t in (IN_TOPIC, PRED_TOPIC):
                    for p in range(broker.topic(t).partitions):
                        state["acked"][(t, p)] = broker.end_offset(t, p)
                state["torn"] = broker.store.log_for(
                    IN_TOPIC, 0).simulate_torn_write()
                state["t_kill"] = time.monotonic()
                live["srv"].kill()
                killed = True
            cols = gen.step_columns()
            entries = [
                (gen.scenario.car_id(i).encode(),
                 frame(codec.encode(gen.row_record(cols, i,
                                                   KSQL_CAR_SCHEMA))), 0)
                for i in range(len(cols["car"]))]
            for attempt in range(100):
                try:
                    producer.produce_many(IN_TOPIC, entries)
                    break
                except (FencedEpochError, ConnectionError):
                    # dead or fenced party: the topology-aware client
                    # re-resolves; redeliver (kills land between ticks,
                    # so the dead server never half-applied this batch)
                    if attempt == 99:
                        raise
                    time.sleep(0.05)
            published += len(entries)
        restarted_ok = restarted.wait(timeout=slo_restart_s + 5)
        _wait(lambda: state.get("t_first_score_after_kill") is not None,
              slo_first_score_s + 5)
        _wait(lambda: all(
            live["broker"].committed(GROUP, IN_TOPIC, p)
            == live["broker"].end_offset(IN_TOPIC, p)
            for p in range(parts)), 20.0)
    finally:
        sup.stop()
        for c in (producer, consumer_client):
            try:
                c.close()
            except OSError:
                pass
        if not killed or restarted.is_set():
            # live["srv"] is a RUNNING server (the original, or the
            # restarted incarnation); a killed-but-never-restarted one
            # must not be killed twice (shutdown() would block)
            live["srv"].kill()
        live["broker"].close()
        faults.disarm()
        tmp.cleanup()

    t_restart = (state["t_restarted"] - state["t_kill"]) \
        if restarted.is_set() and killed else None
    t_score = (state["t_first_score_after_kill"] - state["t_kill"]) \
        if state.get("t_first_score_after_kill") and killed else None
    lost = {k: (acked, state["recovered_end"].get(k))
            for k, acked in state["acked"].items()
            if state["recovered_end"].get(k, -1) < acked}
    retained = sum(live["broker"].end_offset(IN_TOPIC, p)
                   for p in range(parts))
    pred_end = live["broker"].end_offset(PRED_TOPIC, 0)
    invariants = [
        Invariant("restarted_within_slo",
                  killed and restarted_ok and t_restart is not None
                  and t_restart <= slo_restart_s,
                  f"broker killed -> remounted+serving in "
                  f"{t_restart:.3f}s (slo {slo_restart_s}s)"
                  if t_restart is not None else "restart never happened"),
        Invariant("first_score_within_slo",
                  t_score is not None and t_score <= slo_first_score_s,
                  f"first post-restart score after {t_score:.3f}s "
                  f"(slo {slo_first_score_s}s)" if t_score is not None
                  else "scorer never scored after the kill"),
        Invariant("zero_acked_loss",
                  killed and restarted.is_set() and not lost,
                  "every record acked before the mid-write kill was "
                  "re-served from disk after recovery (fsync=always)"
                  if not lost else f"ACKED RECORDS LOST: {lost}"),
        Invariant("torn_tail_truncated",
                  state["truncated"] == state["torn"] > 0,
                  f"recovery truncated {state['truncated']} bytes == "
                  f"the {state['torn']} torn bytes the kill left"),
        _check_commits_monotonic(commit_log),
        Invariant("final_commit_at_end",
                  all(live["broker"].committed(GROUP, IN_TOPIC, p)
                      == live["broker"].end_offset(IN_TOPIC, p)
                      for p in range(parts)),
                  "committed == log end on every partition (cursors "
                  "resumed from the persisted offsets file)"),
        Invariant("all_retained_scored",
                  scorer.scored >= retained,
                  f"scored {scorer.scored} >= {retained} records the "
                  f"durable log retained (at-least-once, duplicates "
                  f"allowed)"),
        Invariant("predictions_bounded_gap_free",
                  pred_end <= scorer.scored and not scorer.out._buf,
                  f"predictions end {pred_end} <= scored "
                  f"{scorer.scored}, output buffer drained"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"),
    ]
    return DrillReport(
        drill="broker-restart", seed=seed, records=records,
        published=published, scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={"time_to_restart_s": t_restart,
              "time_to_first_post_restart_score_s": t_score},
        invariants=invariants,
        injected=dict(sorted(eng.injected.items())))


# ------------------------------------------------------------ inproc
def _drill_inproc(name: str, events, seed: int, records: int,
                  extra_invariants=None,
                  min_scorer_restarts: int = 0,
                  device: DeviceLike = None) -> DrillReport:
    """Shared body for the in-process live drills (mqtt-flap /
    scorer-crash): fleet → MQTT → bridge → JsonToAvro → scorer, every
    stage on its own supervised thread, faultpoints armed."""
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..mqtt.bridge import KafkaBridge
    from ..mqtt.broker import MqttBroker
    from ..stream.broker import Broker
    from ..stream.consumer import StreamConsumer
    from ..streamproc.tasks import JsonToAvro

    eng = faults.arm(faults.ChaosEngine(events))
    mqtt = MqttBroker()
    stream = Broker()
    commit_log: List[tuple] = []
    _record_commits(stream, commit_log, "stream")
    KafkaBridge(mqtt, stream, partitions=2)
    task = JsonToAvro(stream, src="sensor-data", dst=IN_TOPIC,
                      partitions=2)
    parts = stream.topic(IN_TOPIC).partitions
    consumer = StreamConsumer(
        stream, [f"{IN_TOPIC}:{p}:0" for p in range(parts)], group=GROUP)
    scorer = _make_scorer(stream, consumer, device)
    state: dict = {"rewinds": 0}

    def task_loop(unit):
        while not unit.should_stop():
            try:
                n = task.process_available()
            except ConnectionError:
                task.consumer.rewind_to_committed()
                time.sleep(0.02)
                continue
            unit.heartbeat()
            time.sleep(0.002 if n else 0.01)

    sup = Supervisor(poll_interval_s=0.02, name="drill-supervisor")
    sup.add_loop("ksql-task", task_loop, heartbeat_timeout_s=30.0)
    sup.add_loop("scorer", _scorer_unit_loop(scorer, consumer, state),
                 heartbeat_timeout_s=30.0, max_restarts=10)
    sup.start()

    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed))
    published = 0
    ticks = max(1, -(-records // CARS_PER_TICK))
    try:
        from ..core.schema import CAR_SCHEMA

        for _ in range(ticks):
            cols = gen.step_columns()
            for i in range(len(cols["car"])):
                rec = gen.row_record(cols, i, CAR_SCHEMA)
                rec["failure_occurred"] = str(cols["failure_occurred"][i])
                mqtt.publish(
                    f"vehicles/sensor/data/{gen.scenario.car_id(i)}",
                    json.dumps(rec).encode(), qos=1)
                published += 1
            time.sleep(0.002)  # live pacing: stages overlap, not lockstep
        # quiesce: scorer has consumed everything the (possibly lossy)
        # pipeline delivered, and its commits reached the log end
        _wait(lambda: task.consumer.at_end(), 20.0)
        _wait(lambda: consumer.at_end()
              and all(stream.committed(GROUP, IN_TOPIC, p)
                      == stream.end_offset(IN_TOPIC, p)
                      for p in range(parts)), 30.0)
    finally:
        sup.stop()
        faults.disarm()

    delivered = sum(stream.end_offset(IN_TOPIC, p) for p in range(parts))
    invariants = [
        Invariant("at_least_once_counts",
                  scorer.scored >= published - eng.dropped_count,
                  f"published={published} scored={scorer.scored} "
                  f"intentionally_dropped={eng.dropped_count}"),
        _check_commits_monotonic(commit_log),
        Invariant("final_commit_at_end",
                  all(stream.committed(GROUP, IN_TOPIC, p)
                      == stream.end_offset(IN_TOPIC, p)
                      for p in range(parts)),
                  "committed == log end on every partition"),
        Invariant("all_delivered_scored",
                  scorer.scored >= delivered,
                  f"scored {scorer.scored} >= {delivered} delivered to "
                  f"the input topic"),
        Invariant("scorer_restarts",
                  sup.unit("scorer").restarts >= min_scorer_restarts,
                  f"scorer restarted {sup.unit('scorer').restarts} "
                  f"time(s) (needed >= {min_scorer_restarts}) — "
                  f"supervision, not manual intervention"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"),
    ] + list(extra_invariants(scorer, sup) if extra_invariants else [])
    return DrillReport(
        drill=name, seed=seed, records=records, published=published,
        scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={}, invariants=invariants,
        injected=dict(sorted(eng.injected.items())))


def drill_mqtt_flap(seed: int = 7, records: int = 1000,
                    device: DeviceLike = None) -> DrillReport:
    """Flapping device links against the live threaded pipeline: seeded
    MQTT delivery drops (accounted in the intentional-loss ledger) and
    delay bursts; every surviving record must still be scored and
    committed."""
    schedule = scenarios.build("mqtt-flap", seed=seed, records=records)
    return _drill_inproc("mqtt-flap", schedule.events, seed, records,
                         device=device)


def drill_scorer_crash(seed: int = 7, records: int = 750,
                       device: DeviceLike = None) -> DrillReport:
    """The scorer thread DIES twice mid-stream (RuntimeError out of the
    drain loop — not the ConnectionError it knows how to rewind from);
    the supervisor must restart it and the restarted incarnations must
    finish the stream with at-least-once delivery intact."""
    # scorer.poll is hit once per drain-loop round (idle rounds
    # included), so live hit counts accrue at wall-clock speed, not
    # record speed — schedule the two kills on early hits that every
    # run reaches, and let each kill take down one incarnation (the
    # counter is global, so hit 15 lands on the RESTARTED scorer)
    events = [
        scenarios.FaultEvent(5, "scorer.poll", "error",
                             params=(("exc", "RuntimeError"),)),
        scenarios.FaultEvent(15, "scorer.poll", "error",
                             params=(("exc", "RuntimeError"),)),
    ]
    return _drill_inproc("scorer-crash", events, seed, records,
                         min_scorer_restarts=1, device=device)


DRILLS = {
    "leader-kill": drill_leader_kill,
    "broker-restart": drill_broker_restart,
    "mqtt-flap": drill_mqtt_flap,
    "scorer-crash": drill_scorer_crash,
}
