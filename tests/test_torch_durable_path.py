"""The slice whole at a small size, on the CPU: fleet records published
into a durable broker, a child process appending one more tick with
``fsync=always`` SIGKILLed after a few acknowledged batches, a torn
tail written by a mount dropped without ``close()``, the remount, then
B1 (the fused fit, its plain version on the CPU) and the scorer from
the recovered log; and a backfill from a timestamp, the tiered log and
the durable platform the same way.

Held against the JAX package: the same recovered records in JAX's
durable broker, the same converted starting params, JAX's
``fit_compiled``: batches exactly equal; losses rtol 2e-4 / atol 1e-6
and params rtol 5e-3 / atol 2e-5 (the fused-fit bounds,
tests/test_fused_train.py); the scorer's reconstruction errors rtol 1e-5
and its payloads' printed values atol 1e-6.  Every acknowledged record
re-serves, equal to the seeded generator's by regeneration.  The child
has a deadline and is killed in a ``finally``.
"""

import inspect
import json
import os
import selectors
import subprocess
import sys
import time
import zlib
from pathlib import Path

import jax
import numpy as np
import pytest

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.evaluate.anomaly import \
    reconstruction_errors as j_reconstruction_errors
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.store import StorePolicy as JStorePolicy
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.evaluate.anomaly import reconstruction_errors
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.ops import fused_train
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.store import StorePolicy, TierPolicy
from iotml_torch.store.log import store_recovery_truncated
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.native import NativeCodec
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import Trainer, TrainState

ROOT = Path(__file__).resolve().parent.parent
TOPIC = "SENSOR_DATA_S_AVRO"
PARTS, CARS, TICKS = 10, 300, 4
CRASH_BATCH, CRASH_ACKS = 30, 4
GROUP = "crash-g"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
ERR_TOL = dict(rtol=1e-5, atol=0.0)
PAYLOAD_ATOL = 1e-6


def _ticks(n: int, cars: int = CARS):
    """The fleet's first ``n`` ticks as produce entries: [(car key,
    Confluent-framed Avro value, tick ms)] a tick."""
    gen = FleetGenerator(FleetScenario(num_cars=cars, interval_s=10))
    codec = NativeCodec(KSQL_CAR_SCHEMA)
    out = []
    for _ in range(n):
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        out.append([(gen.scenario.car_id(i).encode(), m, ts)
                    for i, m in enumerate(msgs)])
    return out


#: the crash child: mounts the store with fsync=always, appends tick
#: TICKS + 1 in batches, commits each batch's ends for GROUP, then prints
#: one JSON line of the partitions' ends: every line is an ack
CHILD = f"""
import json, sys
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.store import StorePolicy
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.native import NativeCodec
CARS = {CARS}
{inspect.getsource(_ticks)}
d, ticks, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
b = Broker(store_dir=d, store_policy=StorePolicy(fsync="always"))
tick = _ticks(ticks, int(sys.argv[4]))[-1]
for i in range(0, len(tick), batch):
    b.produce_many({TOPIC!r}, tick[i:i + batch])
    ends = [b.end_offset({TOPIC!r}, p) for p in range({PARTS})]
    b.commit_many({GROUP!r}, {TOPIC!r}, list(enumerate(ends)))
    print(json.dumps(ends), flush=True)
print("done", flush=True)
"""


def _crash_child(d: str, acks: int, deadline_s: float = 120.0) -> list:
    """Run CHILD on ``d`` and SIGKILL it after ``acks`` ack lines; returns
    the lines read (the last is the newest ack the parent saw)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", CHILD, d, str(TICKS + 1), str(CRASH_BATCH),
         str(CARS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    lines = []
    sel = selectors.DefaultSelector()
    try:
        sel.register(proc.stdout, selectors.EVENT_READ)
        deadline = time.monotonic() + deadline_s
        while len(lines) < acks:
            left = deadline - time.monotonic()
            assert left > 0, f"crash child: {len(lines)} acks in time"
            if not sel.select(timeout=left):
                continue
            line = proc.stdout.readline()
            assert line and line.strip() != "done", \
                f"child ended early: {proc.stderr.read()}"
            lines.append(json.loads(line))
        proc.kill()
        proc.wait(timeout=30)
    finally:
        sel.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == -9
    return lines


def _expected(ticks) -> list:
    """Each partition's records in offset order, as the broker places
    them: crc32(key) % PARTS, in produce order."""
    out = [[] for _ in range(PARTS)]
    for tick in ticks:
        for key, value, ts in tick:
            part = out[zlib.crc32(key) % PARTS]
            part.append((len(part), key, value, ts))
    return out


def _records(b, topic=TOPIC):
    return [[(m.offset, m.key, m.value, m.timestamp_ms)
             for m in b.fetch(topic, p, 0, 10 ** 7)]
            for p in range(b.topic(topic).partitions)]


def _specs(b, topic=TOPIC):
    return [f"{topic}:{p}:0" for p in range(b.topic(topic).partitions)]


def _batches(side, broker, group, take=10):
    cls, cons = ((SensorBatches, StreamConsumer) if side == "port"
                 else (JSensorBatches, JStreamConsumer))
    return list(next(cls(cons(broker, _specs(broker), group=group),
                         batch_size=100, take=take,
                         only_normal=True).epochs(1)))


def _converted(jt):
    st = jt.state
    adam = st.opt_state[0]
    return TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def _check_fit(th, jh, tt, jt):
    np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
    j_params = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for name, v in tt.state.params.items():
        np.testing.assert_allclose(v.numpy(), j_params[name].numpy(),
                                   err_msg=name, **STATE_TOL)


@pytest.fixture(scope="module")
def recovered(tmp_path_factory):
    """Publish TICKS ticks durably; crash a child mid-tick; tear the tail
    of one partition with a mount dropped without close(); remount."""
    d = str(tmp_path_factory.mktemp("durable") / "store")
    b = Broker(store_dir=d, store_policy=StorePolicy(fsync="interval"))
    b.create_topic(TOPIC, partitions=PARTS, retention_ms=100_000)
    for tick in _ticks(TICKS):
        b.produce_many(TOPIC, tick)
    b.commit_many(GROUP, TOPIC, [(p, 0) for p in range(PARTS)])
    b.close()
    acks = _crash_child(d, CRASH_ACKS)
    crashed = Broker(store_dir=d)
    victim = crashed.store.log_for(TOPIC, 3)
    torn = victim.simulate_torn_write()
    truncated = store_recovery_truncated.value()
    del crashed, victim  # the chaos runner's kill: no close()
    t0 = time.perf_counter()
    b = Broker(store_dir=d)
    mount_s = time.perf_counter() - t0
    yield {"dir": d, "broker": b, "acks": acks, "torn": torn,
           "truncated": store_recovery_truncated.value() - truncated,
           "mount_s": mount_s}
    b.close()


def test_every_acked_record_reserves_after_the_kill(recovered):
    b = recovered["broker"]
    want = _expected(_ticks(TICKS + 1))
    got = _records(b)
    last_ack = recovered["acks"][-1]
    for p in range(PARTS):
        # a prefix of the generator's records, at least the acked ones;
        # records written past the last ack the parent saw are the
        # generator's too (the kill lost no written byte)
        assert len(got[p]) >= last_ack[p]
        assert got[p] == want[p][:len(got[p])]
    assert recovered["truncated"] >= recovered["torn"] > 0
    committed = [b.committed(GROUP, TOPIC, p) for p in range(PARTS)]
    assert all(last_ack[p] <= committed[p] <= len(got[p])
               for p in range(PARTS))


def test_fit_and_score_from_the_recovered_log_equal_jax(recovered,
                                                        tmp_path):
    b = recovered["broker"]
    jb = JBroker(store_dir=str(tmp_path / "jax"),
                 store_policy=JStorePolicy(fsync="never"))
    try:
        jb.create_topic(TOPIC, partitions=PARTS)
        for p, rows in enumerate(_records(b)):
            jb.produce_many(TOPIC, [(k, v, ts) for _o, k, v, ts in rows],
                            partition=p)
        assert _records(jb) == _records(b)
        tb, jbs = _batches("port", b, "fit"), _batches("jax", jb, "fit")
        assert len(tb) == len(jbs) == 10
        for x, y in zip(tb, jbs):
            assert np.array_equal(x.x, y.x) and np.array_equal(x.mask,
                                                               y.mask)
        tt, jt = Trainer(CAR_AUTOENCODER, device="cpu"), JTrainer(J_AE)
        jt._ensure_state(np.zeros((100, 18), np.float32))
        tt.state = _converted(jt)
        th = tt.fit_compiled(tb, epochs=3)
        jh = jt.fit_compiled(jbs, epochs=3)
        _check_fit(th, jh, tt, jt)

        # the scorer into the durable model-predictions, read back after
        # a remount, against JAX's scorer from JAX's params
        b.create_topic("model-predictions", partitions=1)
        tsc = StreamScorer(CAR_AUTOENCODER, tt.state.params,
                           SensorBatches(StreamConsumer(b, _specs(b),
                                                        group="serve"),
                                         batch_size=100, take=5),
                           OutputSequence(b, "model-predictions",
                                          partition=0), device="cpu")
        jsc = JStreamScorer(J_AE, jt.state.params,
                            JSensorBatches(JStreamConsumer(jb, _specs(jb),
                                                           group="serve"),
                                           batch_size=100, take=5),
                            JOutputSequence(jb, "model-predictions",
                                            partition=0))
        assert tsc.score_available() == jsc.score_available() == 500
        got = [m.value for m in b.fetch("model-predictions", 0, 0, 10 ** 6)]
        want = [m.value for m in jb.fetch("model-predictions", 0, 0,
                                          10 ** 6)]
        assert len(got) == len(want) == 500
        for g, w in zip(got, want):
            np.testing.assert_allclose(
                np.array(g.decode().strip("[]").split(), np.float64),
                np.array(w.decode().strip("[]").split(), np.float64),
                rtol=0, atol=PAYLOAD_ATOL)
        x = np.concatenate([t.x[:t.n_valid] for t in tb[:5]])
        np.testing.assert_allclose(
            reconstruction_errors(CAR_AUTOENCODER, tt.state.params, x,
                                  device="cpu"),
            np.asarray(j_reconstruction_errors(J_AE, jt.state.params, x)),
            **ERR_TOL)
    finally:
        jb.close()
    # one more remount: the payloads read back as written
    b.close()
    b2 = Broker(store_dir=recovered["dir"])
    recovered["broker"] = b2
    assert [m.value for m in b2.fetch("model-predictions", 0, 0,
                                      10 ** 6)] == got


def _counting_fits(monkeypatch) -> list:
    """Count the trainer's calls of the fused fit (B1's wrapper, which on
    CPU tensors runs its plain version and counts no launch)."""
    calls = []
    real = fused_train.fused_fit

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(fused_train, "fused_fit", counting)
    return calls


def test_backfill_starts_every_partition_at_the_timestamp(recovered,
                                                          tmp_path,
                                                          monkeypatch):
    b = recovered["broker"]
    since = _ticks(3)[2][0][2]  # tick 3's timestamp
    ct = ContinuousTrainer(b, TOPIC, ArtifactStore(str(tmp_path / "art")),
                           group="backfill", backfill_since_ms=since,
                           take_batches=2, device="cpu")
    starts = {p: off for _t, p, off in ct.consumer.positions()}
    for p, rows in enumerate(_records(b)):
        linear = next((o for o, _k, _v, ts in rows if ts >= since),
                      len(rows))
        assert starts[p] == b.offset_for_timestamp(TOPIC, p, since) == \
            linear > 0
    calls = _counting_fits(monkeypatch)
    rounds = [ct.train_round() for _ in range(2)]
    assert all(r for r in rounds)
    assert calls == [(2, 100, 18)] * 2  # one B1 call a round


def test_tiered_log_serves_the_same_batches(recovered, tmp_path):
    """The recovered store remounted with a tier whose hot budget holds
    one segment: after a tiering pass the head lives only remotely, and
    the fit's batches are the local log's exactly."""
    b = recovered["broker"]
    want = _batches("port", b, "tier-fit")
    b.close()
    pol = StorePolicy(segment_bytes=16 * 1024)
    tb = Broker(store_dir=recovered["dir"], store_policy=pol,
                tier=TierPolicy(uri=str(tmp_path / "bucket"),
                                local_hot_bytes=16 * 1024))
    try:
        # roll each partition so its old records seal, then tier them out
        for p in range(PARTS):
            tb.store.log_for(TOPIC, p).roll()
        stats = tb.run_tiering()
        assert stats and all(s["uploaded"] >= 1 for s in stats.values())
        assert any(tb.store.log_for(TOPIC, p).local_base_offset > 0
                   for p in range(PARTS))
        got = _batches("port", tb, "tier-fit")
        assert len(got) == len(want)
        for x, y in zip(got, want):
            assert np.array_equal(x.x, y.x) and np.array_equal(x.mask,
                                                               y.mask)
    finally:
        tb.close()
    recovered["broker"] = Broker(store_dir=recovered["dir"])


def test_durable_platform_reserves_the_ksql_leg(tmp_path, monkeypatch):
    """Platform(store_dir=) publishes a fleet tick over MQTT into KSQL and
    stops; a second Platform on the same directory re-serves
    SENSOR_DATA_S_AVRO whole, and the fit runs on it."""
    from iotml_torch.cli.up import Platform
    from iotml_torch.mqtt.wire import MqttClient

    d = str(tmp_path / "plat")
    scenario = FleetScenario(num_cars=300, interval_s=10)
    gen = FleetGenerator(scenario)
    cols = gen.step_columns()
    tick = [(f"vehicles/sensor/data/{scenario.car_id(i)}",
             json.dumps(gen.row_record(cols, i, KSQL_CAR_SCHEMA)).encode())
            for i in range(scenario.num_cars)]
    plat = Platform(partitions=2, store_dir=d, device="cpu").start()
    try:
        clients = [MqttClient("127.0.0.1", plat.mqtt.port, f"c{i}")
                   for i in range(4)]
        try:
            for i, (topic, payload) in enumerate(tick):
                clients[i % 4].publish(topic, payload, qos=0)
        finally:
            for c in clients:
                c.disconnect()
        deadline = time.monotonic() + 30
        while plat.bridge.forwarded() < len(tick):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        while plat.pump():
            pass
        before = _records(plat.broker, "SENSOR_DATA_S_AVRO")
    finally:
        plat.stop()
    assert sum(len(p) for p in before) == len(tick)
    plat2 = Platform(partitions=2, store_dir=d, device="cpu").start()
    try:
        assert _records(plat2.broker, "SENSOR_DATA_S_AVRO") == before
        bs = _batches("port", plat2.broker, "plat-fit", take=None)
        assert sum(x.n_valid for x in bs) > 0
        calls = _counting_fits(monkeypatch)
        hist = Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(
            bs, epochs=2)
        assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
        assert len(calls) == 1
    finally:
        plat2.stop()
    assert os.path.isdir(os.path.join(d, "segments"))
