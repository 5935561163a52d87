"""The port's consumer-group coordinator and group consumer
(``iotml_torch.stream.group``) held against ``iotml.stream.group`` on the
CPU.

Each scenario of the JAX package's ``tests/test_group.py`` runs through
both packages on identically fed brokers, with the same fake clock and
the same member ids (``uuid.uuid4`` replaced by a counter in both), and
records what a member sees: generations, assignments, the delivered
(topic, partition, offset) sequence of every poll, commit verdicts and
the committed offsets.  Tolerance: none, the records must be equal.
``SensorBatches`` over the elastic pair compares the batches' rows
exactly.
"""

import types
import uuid

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.stream import group as j_group
from iotml.stream.broker import Broker as JBroker
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.stream import group as t_group
from iotml_torch.stream.broker import Broker

PACKAGES = {
    "torch": types.SimpleNamespace(Broker=Broker, group=t_group,
                                   SensorBatches=SensorBatches,
                                   FleetGenerator=FleetGenerator,
                                   FleetScenario=FleetScenario),
    "jax": types.SimpleNamespace(Broker=JBroker, group=j_group,
                                 SensorBatches=JSensorBatches,
                                 FleetGenerator=JFleetGenerator,
                                 FleetScenario=JFleetScenario),
}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _counting_uuid4(monkeypatch):
    """Member ids from a counter: ``uuid4().hex[:8]`` is 00000001, ..."""
    count = iter(range(1, 1 << 20))
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=next(count) << 96))


def _broker(pkg):
    b = pkg.Broker()
    b.create_topic("sensor-data", partitions=10)
    for i in range(200):
        b.produce("sensor-data", f"r{i}".encode(), partition=i % 10)
    return b


def _tpo(msgs):
    return [(m.topic, m.partition, m.offset) for m in msgs]


def _committed(b, group="g", topic="sensor-data", parts=10):
    return [b.committed(group, topic, p) for p in range(parts)]


# ------------------------------------------------------------- assignors
@settings(max_examples=60, deadline=None)
@given(n_members=st.integers(0, 7),
       topics=st.dictionaries(st.sampled_from(["a", "b", "t", "zz"]),
                              st.integers(0, 13), max_size=4),
       shuffle=st.randoms(use_true_random=False))
def test_assignors_match_jax(n_members, topics, shuffle):
    members = [f"m{i}" for i in range(n_members)]
    shuffle.shuffle(members)
    for name in ("range", "roundrobin"):
        assert t_group.ASSIGNORS[name](members, topics) == \
            j_group.ASSIGNORS[name](members, topics)


def test_assignor_shapes():
    a = t_group.range_assign(["m1", "m2", "m3"], {"t": 10})
    assert sorted(len(v) for v in a.values()) == [3, 3, 4]
    for parts in a.values():
        ps = [p for _, p in parts]
        assert ps == list(range(ps[0], ps[0] + len(ps)))
    r = t_group.roundrobin_assign(["m1", "m2"], {"t1": 3, "t2": 3})
    assert r["m1"] == [("t1", 0), ("t1", 2), ("t2", 1)]
    with pytest.raises(ValueError, match="unknown assignor"):
        t_group.GroupCoordinator(Broker(), "g", assignor="sticky")


# ------------------------------------------------------------- scenarios
def scenario_split(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    log.append(("c1", c1.member_id, coord.generation, c1.assignment))
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    log.append(("c2", c2.member_id, coord.generation, c2.assignment))
    log.append(("heal", _tpo(c1.poll())))
    log.append((c1.assignment, c2.assignment, c1.rebalances))
    assert sorted(c1.assignment + c2.assignment) == \
        [("sensor-data", p) for p in range(10)]


def scenario_all_consumed(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g", assignor="roundrobin")
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    seen = []
    for c in (c1, c2):
        while True:
            msgs = c.poll()
            if not msgs:
                break
            log.append(_tpo(msgs))
            seen.extend(m.value for m in msgs)
    assert len(set(seen)) == 200


def scenario_graceful_leave(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    healed = c1.poll()
    got = c2.poll(30)
    log.append((_tpo(healed), _tpo(got), c2.commit()))
    c2.close()
    log.append(("after leave", coord.generation, coord.members()))
    msgs = list(healed)
    while True:
        chunk = c1.poll()
        if not chunk:
            break
        log.append(_tpo(chunk))
        msgs.extend(chunk)
    log.append((c1.assignment, _committed(b)))
    assert len(msgs) + len(got) == 200


def scenario_crash_timeout(pkg, log):
    b = _broker(pkg)
    clock = FakeClock()
    coord = pkg.group.GroupCoordinator(b, "g", session_timeout_s=5.0,
                                       clock=clock)
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    log.append(("healed", _tpo(c1.poll())))
    log.append(("first", _tpo(c2.poll(20)), c2.commit()))
    uncommitted = c2.poll(20)
    log.append(("uncommitted", _tpo(uncommitted)))
    clock.t += 6.0  # c2 crashes: no leave, no heartbeats
    msgs = c1.poll()
    log.append(("adopt", _tpo(msgs), c1.rebalances, c1.assignment,
                coord.generation, coord.members()))
    while True:
        chunk = c1.poll()
        if not chunk:
            break
        msgs.extend(chunk)
    log.append(("rest", _tpo(msgs), c1.commit(), _committed(b)))
    assert set(_tpo(uncommitted)) <= set(_tpo(msgs))


def scenario_scale_out(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    part1 = c1.poll(50)
    log.append((_tpo(part1), c1.commit()))
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    rest = []
    for c in (c1, c2):
        while True:
            chunk = c.poll()
            if not chunk:
                break
            rest.extend(chunk)
            log.append(_tpo(chunk))
    log.append((c1.commit(), c2.commit(), _committed(b)))
    assert len(set(m.value for m in part1 + rest)) == len(part1 + rest) \
        == 200


def scenario_stale_heartbeat(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    m1, gen1, a1 = coord.join(["sensor-data"])
    m2, gen2, a2 = coord.join(["sensor-data"])
    log.append((m1, gen1, a1, m2, gen2, a2))
    log.append((coord.heartbeat(m1, gen1),
                coord.heartbeat_verdict(m1, gen1),
                coord.sync(m1, gen1), coord.sync(m2, gen2),
                coord.sync("nobody", gen2),
                coord.heartbeat_verdict("nobody", gen2)))
    rejoin = coord.join(["sensor-data"], m1)
    log.append((rejoin, coord.heartbeat(m1, rejoin[1]),
                coord.sync(m1, rejoin[1]), coord.subscriptions(),
                coord.assignment(m2)))
    assert rejoin[0] == m1 and rejoin[1] == coord.generation


def scenario_fenced_commit(pkg, log):
    b = _broker(pkg)
    clock = FakeClock()
    coord = pkg.group.GroupCoordinator(b, "g", session_timeout_s=5.0,
                                       clock=clock)
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    for _ in range(3):
        log.append(_tpo(c1.poll(30)))
    clock.t += 10.0  # c1's session expires
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    while not c2.at_end():
        log.append(_tpo(c2.poll(1000)))
    log.append((c2.commit(), _committed(b), c2.positions()))
    log.append((c1.commit(), coord.fenced_commit_detailed(
        c1.member_id, c1.generation, c1.positions())))
    c1.close()
    log.append((_committed(b), coord.generation))


def scenario_revocation_grace(pkg, log):
    """A survivor commits its old partitions' progress at the old
    generation (commit before release), never backwards."""
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    m1, g1, a1 = coord.join(["sensor-data"])
    coord.join(["sensor-data"])  # a second member: m1 pending rejoin
    log.append(coord.fenced_commit_detailed(
        m1, g1, [("sensor-data", p, 7) for p in range(10)]))
    log.append(coord.fenced_commit_detailed(
        m1, g1, [("sensor-data", p, 3) for p in range(10)]))
    log.append(_committed(b))
    coord.join(["sensor-data"], m1)  # rejoined: the window closes
    log.append(coord.fenced_commit_detailed(
        m1, g1, [("sensor-data", 0, 9)]))
    log.append(_committed(b))


def scenario_alternating_polls(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    c1 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    c2 = pkg.group.GroupConsumer(coord, ["sensor-data"])
    seen = set()
    for _ in range(40):
        for c in (c1, c2):
            msgs = c.poll(16)
            log.append(_tpo(msgs))
            for m in msgs:
                assert m.value not in seen
                seen.add(m.value)
    log.append((c1.rebalances, c2.rebalances, coord.generation))
    assert len(seen) == 200


def scenario_subscribe_before_topic(pkg, log):
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g", metadata_max_age_s=0.0)
    c = pkg.group.GroupConsumer(coord, ["late-topic"])
    log.append((c.assignment, c.poll()))
    b.create_topic("late-topic", partitions=3)
    b.produce("late-topic", b"x", partition=1)
    got = c.poll() or c.poll()
    log.append((_tpo(got), c.assignment, coord.generation))
    assert [m.value for m in got] == [b"x"]


def scenario_metadata_rate_limit(pkg, log):
    b = _broker(pkg)
    clock = FakeClock()
    coord = pkg.group.GroupCoordinator(b, "g", clock=clock,
                                       metadata_max_age_s=5.0)
    c = pkg.group.GroupConsumer(coord, ["sensor-data", "late-topic"])
    log.append(c.assignment)
    b.create_topic("late-topic", partitions=2)
    clock.t += 1.0
    log.append((_tpo(c.poll()), c.assignment, coord.generation))
    clock.t += 5.0
    log.append((_tpo(c.poll()), c.assignment, coord.generation))
    assert ("late-topic", 0) in c.assignment


def scenario_seek_and_rewind(pkg, log):
    """seek_to_start goes to the group's committed position;
    rewind_to_committed resets the cursors there too."""
    b = _broker(pkg)
    coord = pkg.group.GroupCoordinator(b, "g")
    c = pkg.group.GroupConsumer(coord, ["sensor-data"])
    log.append(_tpo(c.poll(25)))
    log.append((c.commit(), c.positions()))
    log.append(_tpo(c.poll(25)))
    c.rewind_to_committed()
    log.append(c.positions())
    log.append(_tpo(c.poll(5)))
    c.seek_to_start()
    log.append((c.positions(), c.at_end(), len(list(c))))


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_split, scenario_all_consumed, scenario_graceful_leave,
    scenario_crash_timeout, scenario_scale_out, scenario_stale_heartbeat,
    scenario_fenced_commit, scenario_revocation_grace,
    scenario_alternating_polls, scenario_subscribe_before_topic,
    scenario_metadata_rate_limit, scenario_seek_and_rewind)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_group_scenario_matches_jax(name, monkeypatch):
    logs = {}
    for which, pkg in PACKAGES.items():
        _counting_uuid4(monkeypatch)
        logs[which] = []
        SCENARIOS[name](pkg, logs[which])
    assert logs["torch"] == logs["jax"]
    assert logs["torch"]


def test_group_elastic_sensorbatches_pipeline_matches_jax():
    """JAX's test_group_elastic_sensorbatches_pipeline in both packages:
    two members batch a 10-partition framed-Avro stream, one crashes
    after a drain without committing, the survivor adopts its partitions
    after the session timeout; row counts and rows equal."""
    out = {}
    for which, pkg in PACKAGES.items():
        b = pkg.Broker()
        gen = pkg.FleetGenerator(pkg.FleetScenario(num_cars=50,
                                                   failure_rate=0.0))
        assert gen.publish(b, "SENSOR_DATA_S_AVRO", n_ticks=20,
                           partitions=10) == 1000
        clock = FakeClock()
        coord = pkg.group.GroupCoordinator(b, "scorers",
                                           session_timeout_s=5.0,
                                           clock=clock)
        c1 = pkg.group.GroupConsumer(coord, ["SENSOR_DATA_S_AVRO"],
                                     member_id="scorer-a")
        c2 = pkg.group.GroupConsumer(coord, ["SENSOR_DATA_S_AVRO"],
                                     member_id="scorer-b")
        pre = len(c1.poll(1))
        crashed = list(pkg.SensorBatches(c2, batch_size=100))
        clock.t += 6.0
        survivor = list(pkg.SensorBatches(c1, batch_size=100))
        assert c1.commit()
        assert pre + sum(x.n_valid for x in survivor) == 1000
        assert c1.assignment == [("SENSOR_DATA_S_AVRO", p)
                                 for p in range(10)]
        out[which] = (pre, crashed, survivor, _committed(
            b, "scorers", "SENSOR_DATA_S_AVRO"))
    t, j = out["torch"], out["jax"]
    assert t[0] == j[0] and t[3] == j[3]
    for got, want in ((t[1], j[1]), (t[2], j[2])):
        assert [x.n_valid for x in got] == [x.n_valid for x in want]
        assert sum(x.n_valid for x in got) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.x, w.x)
            assert g.first_index == w.first_index
