"""The port's fault points (``iotml_torch.chaos.faults``) held against the
JAX package's (``iotml.chaos.faults``) on the CPU: the engine's schedule
validation, its hit counts, windows and ledgers, the disarmed shim, the
environment switch, and every point the port compiles in, driven by the
same schedule through both packages where both traverse it alike.

Tolerances: the fire sequence (the action returned or the exception
raised at every traversal), hit counts and injected counts per site,
the drop ledger, rewinds, scored rows, duplicates and committed offsets
are equal.  Where the packages traverse a point a different number of
times by design, the test says so and holds the port to its own count.
"""

import numpy as np
import pytest

from iotml.chaos import faults as j_faults
from iotml.chaos.scenarios import FaultEvent as JFaultEvent
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.obs import tracing as j_tracing
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml_torch.chaos import faults
from iotml_torch.chaos.faults import ChaosEngine, FaultEvent
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import ModelRegistry
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import params_from_jax
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs import tracing
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.live import ContinuousTrainer

TOPIC = "SENSOR_DATA_S_AVRO"


@pytest.fixture(autouse=True)
def _disarmed():
    faults.disarm()
    j_faults.disarm()
    yield
    faults.disarm()
    j_faults.disarm()
    for tr in (tracing, j_tracing):
        tr.configure(enabled=False, sample=1.0)
        tr.reset()


def _events(cls, spec):
    return [cls(at=a, point=p, action=act, params=tuple(params.items()),
                repeat=r) for a, p, act, params, r in spec]


def _both(spec):
    return (ChaosEngine(_events(FaultEvent, spec)),
            j_faults.ChaosEngine(_events(JFaultEvent, spec)))


# ---------------------------------------------------------------- engine
def test_fault_event_and_point_tables_equal_jax():
    assert faults.KNOWN_POINTS == j_faults.KNOWN_POINTS
    assert faults.POINT_ACTIONS == j_faults.POINT_ACTIONS
    assert faults.RUNNER_POINTS == j_faults.RUNNER_POINTS
    ev = ("broker.fetch", "delay", {"seconds": 0.5}, 3)
    t = FaultEvent(7, ev[0], ev[1], tuple(ev[2].items()), ev[3])
    j = JFaultEvent(7, ev[0], ev[1], tuple(ev[2].items()), ev[3])
    assert t.line() == j.line()


@pytest.mark.parametrize("spec,match", [
    ([(1, "nope.point", "error", {}, 1)], "unknown faultpoint"),
    ([(1, "broker.fetch", "drop", {}, 1)], "does not interpret"),
    ([(1, "scorer.poll", "error", {"exc": "KeyError"}, 1)],
     "unknown exception"),
    ([(1, "scorer.poll", "error", {}, 3), (2, "scorer.poll", "error", {}, 1)],
     "overlapping non-delay"),
])
def test_schedule_validation_equals_jax(spec, match):
    for engine, event in ((ChaosEngine, FaultEvent),
                          (j_faults.ChaosEngine, JFaultEvent)):
        with pytest.raises(ValueError, match=match):
            engine(_events(event, spec))


SCHEDULE = [
    (2, "scorer.poll", "error", {}, 1),
    (4, "scorer.poll", "error", {"exc": "RuntimeError"}, 2),
    (1, "scorer.poll", "delay", {"seconds": 0.0}, 8),
    (3, "kafka_wire.send", "short_write", {}, 2),
    (2, "mqtt.deliver", "drop", {}, 2),
    (4, "mqtt.deliver", "drop", {"account": False}, 1),
    (5, "mqtt.deliver", "dup", {}, 1),
    (1, "replica.sync", "skip", {}, 1),
    (5, "runner.kill_leader", "kill_leader", {}, 1),
]


def _fire_sequence(engine):
    out = []
    for name in ["scorer.poll"] * 9 + ["kafka_wire.send"] * 5 + \
            ["mqtt.deliver"] * 6 + ["replica.sync"] * 2 + ["broker.fetch"]:
        try:
            act = engine.fire(name)
            out.append((name, None if act is None else
                        (act.kind, dict(act.params))))
        except (ConnectionError, RuntimeError, OSError) as e:
            out.append((name, type(e).__name__))
    return out


def test_same_schedule_same_fire_sequence():
    t, j = _both(SCHEDULE)
    assert _fire_sequence(t) == _fire_sequence(j)
    assert (t.hits, t.injected, t.dropped_count) == \
        (j.hits, j.injected, j.dropped_count)
    assert t.dropped_count == 2 and t.injected["scorer.poll:error"] == 3
    assert [e.point for e in t.runner_events] == ["runner.kill_leader"]
    assert t.due_runner_events(4) == [] and len(t.due_runner_events(5)) == 1
    t.note_runner_fired(FaultEvent(5, "runner.kill_leader", "kill_leader"))
    assert t.injected["runner.kill_leader:kill_leader"] == 1


def test_drop_ledger_books_the_current_trace():
    tracing.configure(enabled=True)
    ctx = tracing.start("devsim_publish")
    prev = tracing.set_current(ctx)
    try:
        eng = ChaosEngine(_events(FaultEvent,
                                  [(1, "mqtt.deliver", "drop", {}, 1)]))
        assert eng.fire("mqtt.deliver").kind == "drop"
    finally:
        tracing.set_current(prev)
    assert eng.dropped_traces == {ctx.trace_id}


def test_disarmed_point_returns_none_and_counts_nothing():
    assert faults.engine() is None and faults.point("broker.fetch") is None
    before = t_metrics.default_registry.collect()
    Broker().produce("t", b"v")
    after = t_metrics.default_registry.collect()
    assert {k: v for k, v in after.items()
            if k.startswith("iotml_chaos")} == \
        {k: v for k, v in before.items() if k.startswith("iotml_chaos")}


def test_arm_disarm_and_the_injected_counter():
    eng = faults.arm(ChaosEngine(_events(
        FaultEvent, [(1, "broker.fetch", "error", {}, 1)])))
    assert faults.engine() is eng
    key = 'iotml_chaos_injected_total{fault="broker.fetch:error"}'
    before = t_metrics.default_registry.collect().get(key, 0.0)
    b = Broker()
    b.produce("t", b"v")
    with pytest.raises(ConnectionError, match=r"chaos\[broker.fetch\]"):
        b.fetch("t", 0, 0)
    assert b.fetch("t", 0, 0)[0].value == b"v"
    assert t_metrics.default_registry.collect()[key] - before == 1
    faults.disarm()
    assert faults.engine() is None


def test_arm_from_env_names_a14_for_a_scenario():
    """``IOTML_CHAOS`` arms the named scenario's schedule (the scenarios
    are ported; only their runner is ROADMAP A14), and an unknown name
    raises KeyError as JAX's does, arming nothing."""
    assert faults.arm_from_env({}) is None
    assert faults.arm_from_env({"IOTML_CHAOS": "off"}) is None
    with pytest.raises(KeyError, match="broker-blackout"):
        faults.arm_from_env({"IOTML_CHAOS": "1",
                             "IOTML_CHAOS_SCENARIO": "broker-blackout"})
    assert faults.engine() is None
    try:
        eng = faults.arm_from_env({"IOTML_CHAOS": "1",
                                   "IOTML_CHAOS_SCENARIO": "dup-storm"})
        assert faults.engine() is eng and "mqtt.deliver" in eng._windows
    finally:
        faults.disarm()


# ---------------------------------------------------- points in the path
def _seed(n_records, partitions=2):
    t, j = Broker(), JBroker()
    FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.02)).publish(
        t, TOPIC, n_ticks=n_records // 100, partitions=partitions)
    j.create_topic(TOPIC, partitions=partitions)
    for p in range(partitions):
        for m in t.fetch(TOPIC, p, 0, t.end_offset(TOPIC, p)):
            j.produce(TOPIC, m.value, key=m.key, partition=p,
                      timestamp_ms=m.timestamp_ms)
    return t, j


def test_publish_passes_broker_produce_once_a_record():
    """The generator produces record by record in both packages, so
    ``broker.produce`` counts every record; ``produce_many`` is one hit a
    call in both."""
    eng = faults.arm(ChaosEngine([]))
    b = Broker()
    FleetGenerator(FleetScenario(num_cars=10)).publish(b, TOPIC, n_ticks=3)
    assert eng.hits == {"broker.produce": 30}
    b.produce_many(TOPIC, [(None, b"x", 0)] * 5)
    assert eng.hits["broker.produce"] == 31
    jeng = j_faults.arm(j_faults.ChaosEngine([]))
    jb = JBroker()
    jb.produce_many(TOPIC, [(None, b"x", 0)] * 5)
    assert jeng.hits == {"broker.produce": 1}


@pytest.mark.parametrize("at", [1, 3])
def test_scorer_poll_crash_rewinds_like_jax(at):
    """``scorer.poll`` raises ConnectionError at hit ``at``;
    ``run_forever`` rewinds to the committed offsets and re-drains: the
    same hits, rewinds, duplicates and commits in both packages, no row
    lost."""
    tb, jb = _seed(3000)
    specs = [f"{TOPIC}:{p}:0" for p in range(2)]
    jp = J_AE.init(__import__("jax").random.PRNGKey(0),
                   np.zeros((1, 18), np.float32))["params"]
    for b in (tb, jb):
        b.create_topic("preds")
    t = StreamScorer(CAR_AUTOENCODER, params_from_jax(jp),
                     SensorBatches(StreamConsumer(tb, specs, group="c"),
                                   batch_size=100),
                     OutputSequence(tb, "preds", partition=0), device="cpu")
    j = JStreamScorer(J_AE, jp,
                      JSensorBatches(JStreamConsumer(jb, specs, group="c"),
                                     batch_size=100),
                      JOutputSequence(jb, "preds", partition=0))
    for s in (t, j):
        s.max_super_batches = 8
    spec = [(at, "scorer.poll", "error", {}, 1),
            (2, "broker.fetch", "delay", {"seconds": 0.0}, 3)]
    rewinds = t_metrics.scorer_rewinds.value()
    out = []
    for scorer, arm, eng_cls, ev_cls, broker in (
            (t, faults.arm, ChaosEngine, FaultEvent, tb),
            (j, j_faults.arm, j_faults.ChaosEngine, JFaultEvent, jb)):
        eng = arm(eng_cls(_events(ev_cls, spec)))
        scorer.run_forever(poll_interval_s=0.0, max_rounds=3)
        faults.disarm()
        j_faults.disarm()
        preds = broker.end_offset("preds", 0)
        out.append((dict(eng.hits), dict(eng.injected), scorer.scored, preds,
                    [broker.committed("c", TOPIC, p) for p in range(2)]))
    assert out[0] == out[1]
    hits, injected, scored, preds, committed = out[0]
    assert injected["scorer.poll:error"] == 1
    assert committed == [tb.end_offset(TOPIC, p) for p in range(2)]
    dupes = scored - 3000
    assert preds == scored and dupes == 800 * (at - 1)
    assert t.rewinds == 1
    assert t_metrics.scorer_rewinds.value() - rewinds == 1


def test_trainer_poll_delay_and_ckpt_write_crash_like_jax(tmp_path):
    """Registry-mode rounds under ``trainer.poll`` delays and one
    ``ckpt.write`` crash: the crashed snapshot is lost (registry
    untouched, ``last_error`` set), the next one lands; hits, injected
    counts, versions and committed offsets equal JAX's."""
    tb, jb = _seed(4000)
    spec = [(1, "trainer.poll", "delay", {"seconds": 0.001}, 2),
            (2, "ckpt.write", "error", {"exc": "OSError"}, 1)]
    out = []
    for cls, reg_cls, broker, arm, eng_cls, ev_cls, kw in (
            (ContinuousTrainer, ModelRegistry, tb, faults.arm, ChaosEngine,
             FaultEvent, {"device": "cpu"}),
            (JContinuousTrainer, JModelRegistry, jb, j_faults.arm,
             j_faults.ChaosEngine, JFaultEvent, {})):
        tr = cls(broker, TOPIC, None, take_batches=10, group="ck",
                 registry=reg_cls(str(tmp_path / cls.__module__)), **kw)
        eng = arm(eng_cls(_events(ev_cls, spec)))
        versions = []
        for _ in range(3):
            assert tr.train_round()
            try:
                versions.append(tr.checkpointer.write_once())
            except OSError:
                versions.append("crash")
        # the poll loop: the log holds no full round now, so it polls
        tr.run(stop=lambda: eng.hits.get("trainer.poll", 0) >= 3,
               poll_interval_s=0.0)
        faults.disarm()
        j_faults.disarm()
        out.append((dict(eng.hits), dict(eng.injected), versions,
                     tr.registry.versions(),
                     [broker.committed("ck", TOPIC, p) for p in range(2)],
                     tr.checkpointer.last_error is not None))
    assert out[0] == out[1]
    hits, injected, versions, _, committed, _ = out[0]
    assert versions == [1, "crash", 2] and out[0][3] == [1, 2]
    assert hits["trainer.poll"] == 3
    assert injected == {"trainer.poll:delay": 2, "ckpt.write:error": 1}


def test_registry_commit_crash_leaves_a_torn_version_recover_sweeps(tmp_path):
    before = t_metrics.registry_torn_recovered.value()
    regs = (ModelRegistry(str(tmp_path / "t")),
            JModelRegistry(str(tmp_path / "j")))
    for reg, arm, eng_cls, ev_cls in (
            (regs[0], faults.arm, ChaosEngine, FaultEvent),
            (regs[1], j_faults.arm, j_faults.ChaosEngine, JFaultEvent)):
        arm(eng_cls(_events(ev_cls, [(2, "registry.commit", "error", {},
                                      1)])))
        reg.publish({"model.h5": b"one"})
        with pytest.raises(ConnectionError):
            reg.publish({"model.h5": b"two"})
        faults.disarm()
        j_faults.disarm()
    assert regs[0].versions() == regs[1].versions() == [1]
    assert regs[0].recover() == regs[1].recover() == 1
    assert t_metrics.registry_torn_recovered.value() - before == 1
    assert regs[0].publish({"model.h5": b"three"}).version == 2


def test_online_update_crash_surfaces_from_the_drain():
    from iotml_torch.online.learner import OnlineLearner

    tb, _ = _seed(1000, partitions=1)
    learner = OnlineLearner(tb, TOPIC, window=100, publish_every=10**9,
                            device="cpu")
    eng = faults.arm(ChaosEngine(_events(
        FaultEvent, [(3, "online.update", "error", {}, 1)])))
    with pytest.raises(ConnectionError, match="online.update"):
        learner.process_available()
    assert eng.hits["online.update"] == 3


def test_wire_client_points_short_write_and_recv_error():
    broker = Broker()
    broker.produce(TOPIC, b"v")
    with KafkaWireServer(broker) as srv:
        client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
        try:
            # a FETCH is idempotent: the client reconnects and retries
            # once, so a torn send or a dead recv costs a round trip
            for point, action in (("kafka_wire.send", "short_write"),
                                  ("kafka_wire.recv", "error")):
                eng = faults.arm(ChaosEngine(_events(
                    FaultEvent, [(1, point, action, {}, 1)])))
                assert client.fetch(TOPIC, 0, 0)[0].value == b"v"
                faults.disarm()
                assert eng.injected == {f"{point}:{action}": 1}
                # the server's in-process broker passes broker.fetch too:
                # once a whole request it received
                again = int(point == "kafka_wire.recv")
                assert eng.hits == {"kafka_wire.send": 2,
                                    "kafka_wire.recv": 1 + again,
                                    "broker.fetch": 1 + again}
            # a produce is not: the torn send surfaces to the caller
            client.produce(TOPIC, b"w0")  # the topic's metadata cached
            faults.arm(ChaosEngine(_events(
                FaultEvent, [(1, "kafka_wire.send", "short_write", {}, 1)])))
            with pytest.raises(ConnectionError, match="non-idempotent"):
                client.produce(TOPIC, b"w")
        finally:
            faults.disarm()
            client.close()
