"""The port's one-process platform (``iotml_torch.cli.up``: ``Platform``
and ``main``) held against the JAX package's.

- Fixed records published over MQTT TCP into both packages' platforms
  give the same ``sensor-data`` and ``SENSOR_DATA_S_AVRO`` records: on
  one partition the same list (keys, values, offsets) and the same
  training batches; on four, the same records per partition as a
  multiset and per key in offset order (the KSQL pump thread and the
  test's pumps cut the source partitions at other points, so only the
  order per car is defined).
- The demo's steps on those batches from the same converted params: the
  fit at the fused-fit bounds (losses rtol 2e-4 / atol 1e-6, params
  rtol 5e-3 / atol 2e-5), the threshold (99th percentile of 512 normal
  rows' errors) at rtol 1e-5, the payloads at the scorer's bounds
  (printed values atol 1e-6, the printed error one last digit apart,
  verdicts equal away from the threshold by 1e-4).
- The REST surfaces, the wire port, a live fleet, the registry mount,
  ``main`` and every left-out flag (NotImplementedError naming its
  ROADMAP item); Kafka Connect and the car-health twin
  (``connect_port``, ``--connect-port``): the Connect REST, the sink
  pumped, the ``connect-driver`` unit and the control center's
  ``connectors`` / ``car_health`` against JAX's; no device and no card
  raises.

Every server binds 127.0.0.1:0; every platform stops in a ``finally``.
"""

import collections
import http.client
import json
import os
import socket
import sys
import tempfile
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from iotml.cli import up as j_up
from iotml.cli.up import Platform as JPlatform
from iotml.store import StorePolicy as JStorePolicy
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.evaluate.anomaly import \
    reconstruction_errors as j_reconstruction_errors
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.cli import up
from iotml_torch.cli.up import Platform
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.evaluate.anomaly import reconstruction_errors
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.mqtt.wire import MqttClient
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.store import StorePolicy, TieredLog, TierPolicy
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.loop import Trainer, TrainState

AVRO = "SENSOR_DATA_S_AVRO"
CARS, TICKS = 40, 15
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
PAYLOAD_ATOL, VERDICT_MARGIN = 1e-6, 1e-4


def _wait_for(fn, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return fn()


def _fleet_json():
    """(topic, payload) of CARS cars for TICKS ticks, as the platform's
    fleet writes them."""
    sc = FleetScenario(num_cars=CARS, failure_rate=0.05)
    gen = FleetGenerator(sc)
    out = []
    for _ in range(TICKS):
        cols = gen.step_columns()
        out += [(f"vehicles/sensor/data/{sc.car_id(i)}",
                 json.dumps(gen.row_record(cols, i,
                                           KSQL_CAR_SCHEMA)).encode())
                for i in range(CARS)]
    return out


def _records(broker, topic):
    n = broker.topic(topic).partitions
    return [[(m.offset, m.key, m.value)
             for m in broker.fetch(topic, p, 0, 10 ** 6)] for p in range(n)]


def _drive(plat):
    """Publish the fixed records over MQTT TCP (QoS 1, one connection:
    acked in order), wait for the bridge, pump until quiet."""
    c = MqttClient("127.0.0.1", plat.mqtt.port, "fleet")
    try:
        for topic, payload in _fleet_json():
            c.publish(topic, payload, qos=1)
    finally:
        c.disconnect()
    assert _wait_for(lambda: plat.bridge.forwarded() == CARS * TICKS)
    while plat.pump():
        pass
    return _records(plat.broker, "sensor-data"), _records(plat.broker, AVRO)


@pytest.fixture(scope="module")
def platforms():
    """One port and one JAX platform on one partition, fed the fixed
    records."""
    t = Platform(partitions=1, device="cpu").start()
    try:
        j = JPlatform(partitions=1).start()
        try:
            yield t, j, _drive(t), _drive(j)
        finally:
            j.stop()
    finally:
        t.stop()


def test_one_partition_records_and_batches_equal_jax(platforms):
    t, j, got, want = platforms
    assert got == want
    assert [len(p) for p in got[1]] == [CARS * TICKS]
    tb, jb = _batches("port", t.broker), _batches("jax", j.broker)
    assert len(tb) == len(jb) >= 5
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.mask, b.mask)


def _per_key(parts):
    out = []
    for records in parts:
        by_key = collections.defaultdict(list)
        for _off, key, value in records:
            by_key[key].append(value)
        out.append((collections.Counter((k, v) for _, k, v in records),
                    dict(by_key)))
    return out


def test_four_partitions_records_equal_jax_per_key():
    t = Platform(partitions=4, device="cpu").start()
    try:
        got = _drive(t)
    finally:
        t.stop()
    j = JPlatform(partitions=4).start()
    try:
        want = _drive(j)
    finally:
        j.stop()
    for g, w in zip(got, want):
        assert _per_key(g) == _per_key(w)
    assert sum(len(p) for p in got[1]) == CARS * TICKS


def _batches(side, broker, batch_size=100, group="fit", take=None):
    cls, cons = ((SensorBatches, StreamConsumer) if side == "port"
                 else (JSensorBatches, JStreamConsumer))
    n = broker.topic(AVRO).partitions
    return list(cls(cons(broker, [f"{AVRO}:{p}:0" for p in range(n)],
                         group=group),
                    batch_size=batch_size, take=take, only_normal=True))


def test_demo_steps_from_converted_params_equal_jax(platforms):
    t, j, _, _ = platforms
    tt, jt = Trainer(CAR_AUTOENCODER, device="cpu"), JTrainer(J_AE)
    jt._ensure_state(np.zeros((100, 18), np.float32))
    st = jt.state
    adam = st.opt_state[0]
    tt.state = TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))
    th = tt.fit_compiled(_batches("port", t.broker), epochs=5)
    jh = jt.fit_compiled(_batches("jax", j.broker), epochs=5)
    np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
    assert th["loss"][-1] <= th["loss"][0]
    j_params = params_from_jax(jax.tree.map(np.asarray, jt.state.params))
    for name, v in tt.state.params.items():
        np.testing.assert_allclose(v.numpy(), j_params[name].numpy(),
                                   err_msg=name, **STATE_TOL)

    # the demo's threshold: 99th percentile over 512 normal rows
    ts_ = _batches("port", t.broker, 512, "thr", take=1)[0]
    js_ = _batches("jax", j.broker, 512, "thr", take=1)[0]
    t_thr = float(np.percentile(reconstruction_errors(
        CAR_AUTOENCODER, tt.state.params, ts_.x[:ts_.n_valid],
        device="cpu"), 99.0))
    j_thr = float(np.percentile(np.asarray(j_reconstruction_errors(
        J_AE, jt.state.params, js_.x[:js_.n_valid])), 99.0))
    np.testing.assert_allclose(t_thr, j_thr, rtol=1e-5)

    def spec(b):
        return [f"{AVRO}:{p}:0" for p in range(b.topic(AVRO).partitions)]

    tsc = StreamScorer(CAR_AUTOENCODER, tt.state.params,
                       SensorBatches(StreamConsumer(t.broker, spec(t.broker),
                                                    group="serve"),
                                     batch_size=100),
                       OutputSequence(t.broker, "model-predictions",
                                      partition=0),
                       threshold=t_thr, device="cpu")
    jsc = JStreamScorer(J_AE, jt.state.params,
                        JSensorBatches(JStreamConsumer(j.broker,
                                                       spec(j.broker),
                                                       group="serve"),
                                       batch_size=100),
                        JOutputSequence(j.broker, "model-predictions",
                                        partition=0),
                        threshold=t_thr)
    assert tsc.score_available() == jsc.score_available() == CARS * TICKS
    got = [m.value.decode() for m in t.broker.fetch(
        "model-predictions", 0, 0, 10 ** 6)]
    want = [m.value.decode() for m in j.broker.fetch(
        "model-predictions", 0, 0, 10 ** 6)]
    assert len(got) == len(want) == CARS * TICKS
    for g, w in zip(got, want):
        g_row, g_verdict, g_err = g.split("|")
        w_row, w_verdict, w_err = w.split("|")
        np.testing.assert_allclose(
            np.array(g_row.strip("[]").split(), np.float64),
            np.array(w_row.strip("[]").split(), np.float64),
            rtol=0, atol=PAYLOAD_ATOL)
        assert abs(round(float(g_err) * 1e6) - round(float(w_err) * 1e6)) \
            <= 1
        if abs(float(w_err) - t_thr) > VERDICT_MARGIN:
            assert g_verdict == w_verdict


def _get(url):
    host, port = url.split("//")[1].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("GET", "/subjects")
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _rest(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return r.status, json.loads(r.read())


def test_rest_surfaces_and_wire_port(platforms):
    t, j, _, _ = platforms
    eps = t.endpoints()
    assert set(eps) == {"kafka", "mqtt", "schema-registry", "ksql"}
    assert _get(eps["schema-registry"]) == _get(
        j.endpoints()["schema-registry"])
    host, port = eps["ksql"].split("//")[1].rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=10)
    try:
        conn.request("POST", "/ksql", json.dumps({"ksql": "SHOW QUERIES;"}),
                     {"Content-Type": "application/json"})
        queries = json.loads(conn.getresponse().read())[0]["queries"]
    finally:
        conn.close()
    assert len(queries) == 3
    client = KafkaWireBroker(eps["kafka"])
    try:
        topics = client.topics()
        assert {"sensor-data", "model-predictions", AVRO} <= set(topics)
        with pytest.raises(PermissionError):  # engine-owned
            client.produce(AVRO, b"x", key=b"k")
    finally:
        client.close()


def test_platform_with_live_fleet_and_registry(tmp_path):
    p = Platform(partitions=2, device="cpu",
                 registry_dir=str(tmp_path / "reg")).start()
    try:
        assert p.endpoints()["registry"] == str(tmp_path / "reg")
        assert p.registry_watcher._thread.is_alive()
        p.start_fleet(num_cars=5, rate_hz=20.0)
        assert _wait_for(lambda: p.bridge.forwarded() >= 10)
        p.stop_fleet()
        p.pump()
        end = sum(p.broker.end_offset(AVRO, q)
                  for q in range(p.broker.topic(AVRO).partitions))
        assert end == p.bridge.forwarded() >= 10
        thread = p.registry_watcher._thread
    finally:
        p.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("arg,value,item", [
    ("connect_port", 0, "A16")])
def test_left_out_arguments_raise(arg, value, item):
    """``connect_port``, once left out (ROADMAP A16), serves Kafka
    Connect: its REST lists the ``car-health-twin`` sink, and ``pump()``
    moves the ``car-health`` records into the twin's documents, latest
    state per car."""
    p = Platform(partitions=1, device="cpu", **{arg: value}).start()
    try:
        url = p.endpoints()["connect"]
        assert url == p.connect.url and p.connect._driver.is_alive()
        assert _rest(url, "/connectors") == (200, ["car-health-twin"])
        status, doc = _rest(url, "/connectors/car-health-twin/status")
        assert status == 200 and doc["type"] == "sink"
        p.connect.poll_interval_s = 3600  # pump() alone from here
        for car, state in (("c1", "ALERT"), ("c2", "OK"), ("c1", "OK")):
            p.broker.produce("car-health", json.dumps(
                {"car": car, "state": state}).encode(), key=car.encode())
        p.pump()
        assert p.car_twin.docs == {"c1": {"car": "c1", "state": "OK"},
                                   "c2": {"car": "c2", "state": "OK"}}
        assert p.broker.committed("connect-car-health-twin", "car-health",
                                  0) == 3
    finally:
        p.stop()
    assert not p.connect._driver.is_alive()
    bare = Platform(partitions=1, device="cpu")
    assert bare.connect is None and bare.car_twin is None
    assert "car-health" not in bare.broker.topics()


@pytest.mark.parametrize("arg", ["store_dir", "store_policy", "tier"])
def test_durable_arguments_mount_the_store(tmp_path, arg):
    """store_dir mounts a durable broker with a compactor; store_policy
    reaches every log; tier adds the uploader and the tier endpoint.
    Each background thread runs while started and is gone after stop."""
    kw = {"store_dir": str(tmp_path / "s")}
    if arg == "store_policy":
        kw["store_policy"] = StorePolicy(fsync="always", segment_bytes=4096)
    if arg == "tier":
        kw["tier"] = TierPolicy(uri=str(tmp_path / "bucket"),
                                interval_s=3600.0)
    p = Platform(partitions=2, device="cpu", **kw).start()
    try:
        assert p.broker.durable
        assert p.endpoints()["store"] == kw["store_dir"]
        assert p.compactor._thread.is_alive()
        log = p.broker.store.log_for("sensor-data", 0)
        if arg == "store_policy":
            assert (log.policy.fsync, log.policy.segment_bytes) == \
                ("always", 4096)
        if arg == "tier":
            assert isinstance(log, TieredLog)
            assert p.endpoints()["tier"] == str(tmp_path / "bucket")
            assert p.uploader._thread.is_alive()
        else:
            assert p.uploader is None and "tier" not in p.endpoints()
        threads = [t for t in (p.compactor._thread,
                               p.uploader and p.uploader._thread) if t]
    finally:
        p.stop()
    assert not any(t.is_alive() for t in threads)
    # the directory lock went with stop(): another process may mount it
    _mount_in_child(kw["store_dir"])


def _mount_in_child(store_dir: str) -> None:
    import subprocess
    import sys

    code = ("from iotml_torch.stream.broker import Broker\n"
            f"Broker(store_dir={store_dir!r}).close()\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=str(Path(__file__).resolve().parent.parent))
    assert run.returncode == 0, run.stderr


def test_durable_platform_restart_reserves_records_as_jax(tmp_path):
    """A Platform over a store dir, records and a commit in, stopped; a
    second Platform over the same dir serves the same records and the
    committed offset, as the JAX package's does over its own dir."""
    got = {}
    for name, cls, policy in (("port", Platform, StorePolicy),
                              ("jax", JPlatform, JStorePolicy)):
        d = str(tmp_path / name)
        kw = {"device": "cpu"} if name == "port" else {}
        plat = cls(partitions=2, store_dir=d,
                   store_policy=policy(fsync="always"), **kw).start()
        try:
            plat.broker.create_topic("raw")
            for i in range(10):
                plat.broker.produce("raw", str(i).encode(), partition=0,
                                    timestamp_ms=100 + i)
            plat.broker.commit("g", "raw", 0, 4)
        finally:
            plat.stop()
        plat = cls(partitions=2, store_dir=d,
                   store_policy=policy(fsync="always"), **kw).start()
        try:
            assert plat.endpoints()["store"] == d
            assert "sensor-data" in plat.broker.topics()
            got[name] = ([(m.offset, m.value, m.timestamp_ms) for m in
                          plat.broker.fetch("raw", 0, 0, 100)],
                         plat.broker.committed("g", "raw", 0))
        finally:
            plat.stop()
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == 10 and got["port"][1] == 4


def test_supervised_raises_a14():
    """``supervised()``, once left out, returns the platform's supervisor:
    its probed units, running once started, stopped by the caller."""
    p = Platform(partitions=1, device="cpu").start()
    try:
        sup = p.supervised(poll_interval_s=0.02)
        assert [u.name for u in sup.units()] == [
            "kafka-wire", "mqtt-front", "ksql-tasks", "schema-registry"]
        sup.start()
        try:
            assert _wait_for(lambda: all(u.state == "running"
                                         for u in sup.units()))
        finally:
            sup.stop()
    finally:
        p.stop()


def test_no_device_and_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Platform()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        up.main(["--quiet", "--metrics-port", "0"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_serves_until_ctrl_c(capsys, monkeypatch):
    seen = {}

    def sleep(_seconds):
        """main's wait: returns control once the fleet has published,
        as Ctrl-C would."""
        plat = seen["plat"]
        assert _wait_for(lambda: plat.bridge.forwarded() >= 3)
        plat.pump()
        raise KeyboardInterrupt

    real = up.Platform

    def platform(*a, **kw):
        seen["plat"] = real(*a, **kw)
        return seen["plat"]

    monkeypatch.setattr(up, "Platform", platform)
    monkeypatch.setattr(up, "time", types.SimpleNamespace(sleep=sleep))
    port = _free_port()
    assert up.main(["--fleet", "3", "--rate", "20", "--metrics-port",
                    str(port)], device="cpu") == 0
    out = capsys.readouterr().out
    plat = seen["plat"]
    assert out.startswith("iotml platform up:")
    for name in ("kafka", "mqtt", "schema-registry", "ksql", "metrics"):
        assert f"  {name}" in out
    assert "3 cars @ 20.0 Hz" in out and out.rstrip().endswith("stopped.")
    assert not plat.started and plat.metrics_server is None


class _Built(Exception):
    """Raised in place of building the platform."""


@pytest.mark.parametrize("flag,item", [
    (["--supervise"], "supervised"),
    (["--connect-port", "0"], "A16"),
    (["--decode-ring-buffers", "4"], "IOTML_DECODE_RING_BUFFERS"),
    (["--raw-batch-bytes", "4096"], "IOTML_RAW_BATCH_BYTES"),
    (["--raw-produce", "off"], "IOTML_RAW_PRODUCE"),
    (["--produce-batch-bytes", "8192"], "IOTML_PRODUCE_BATCH_BYTES"),
    # the case that refused the flag before the mesh path was ported
    pytest.param(["--prefetch-depth", "2"], "IOTML_PREFETCH_DEPTH",
                 id="flag6-A10")])
def test_left_out_flags_raise(flag, item, monkeypatch):
    """The columnar ring's, the raw produce plane's and the prefetcher's
    flags set their knob in the environment before the platform is
    built, as JAX's CLI does;
    ``--supervise``, once left out, runs the platform under its
    supervisor, and ``--connect-port`` serves Kafka Connect."""
    if item == "supervised":
        made = []
        real = Platform.supervised

        def supervised(self, *a, **kw):
            made.append(real(self, *a, **kw))
            return made[-1]

        monkeypatch.setattr(Platform, "supervised", supervised)
        rc, seen = _main_platform(monkeypatch, flag)
        assert rc == 0 and not seen["plat"].started
        # kafka-wire, mqtt-front, ksql-tasks, connect-driver, registry, cc
        assert [len(sup.units()) for sup in made] == [6]
        return
    if item == "A16":
        # --connect-port, once left out, serves Kafka Connect there
        port = _free_port()
        rc, seen = _main_platform(monkeypatch, ["--connect-port",
                                                str(port)])
        assert rc == 0 and seen["kw"]["connect_port"] == port
        assert seen["endpoints"]["connect"] == f"http://127.0.0.1:{port}"
        assert not seen["plat"].started
        return
    if item.startswith("IOTML_"):  # every other case
        monkeypatch.setenv(item, "")  # restored after the test

        def platform(*a, **kw):
            assert os.environ[item] == flag[1]
            raise _Built

        monkeypatch.setattr(up, "Platform", platform)
        with pytest.raises(_Built):
            up.main(flag + ["--quiet"], device="cpu")


def _main_platform(monkeypatch, argv, env=None):
    """``up.main(argv)`` up to its wait, then Ctrl-C: the platform it
    built (stopped) and its return code."""
    seen = {}
    real = up.Platform

    def platform(*a, **kw):
        seen["plat"] = real(*a, **kw)
        seen["kw"] = kw
        return seen["plat"]

    def sleep(_seconds):
        seen["endpoints"] = seen["plat"].endpoints()
        raise KeyboardInterrupt

    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(up, "Platform", platform)
    monkeypatch.setattr(up, "time", types.SimpleNamespace(sleep=sleep))
    rc = up.main(argv + ["--quiet", "--metrics-port", "0"], device="cpu")
    return rc, seen


@pytest.mark.parametrize("flag", ["--durable", "--store-dir", "--tier-uri"])
def test_durable_flags_resolve_as_jax(tmp_path, monkeypatch, flag):
    """--durable takes IOTML_STORE_DIR, else iotml-store in the temporary
    directory; --store-dir wins and alone enables durable mode;
    --tier-uri mounts the tier over the store; the store.* section's
    policy reaches the broker (IOTML_STORE_FSYNC)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    env = {"IOTML_STORE_FSYNC": "always"}
    if flag == "--durable":
        argv, want = ["--durable"], str(tmp_path / "tmp" / "iotml-store")
    elif flag == "--store-dir":
        argv, want = ["--store-dir", str(tmp_path / "flag")], \
            str(tmp_path / "flag")
        env["IOTML_STORE_DIR"] = str(tmp_path / "env")
    else:
        argv = ["--durable", "--tier-uri", str(tmp_path / "bucket")]
        want = str(tmp_path / "env")
        env["IOTML_STORE_DIR"] = want
    rc, seen = _main_platform(monkeypatch, argv, env)
    assert rc == 0
    assert seen["endpoints"]["store"] == want
    assert seen["kw"]["store_policy"].fsync == "always"
    assert not seen["plat"].started
    if flag == "--tier-uri":
        assert seen["endpoints"]["tier"] == str(tmp_path / "bucket")
        assert seen["kw"]["tier"].uri == str(tmp_path / "bucket")
    else:
        assert seen["kw"]["tier"] is None and "tier" not in seen["endpoints"]
    _mount_in_child(want)  # stopped: the lock is free


def test_tier_uri_without_durable_mode_is_a_usage_error(capsys):
    for main in (lambda a: up.main(a, device="cpu"), j_up.main):
        with pytest.raises(SystemExit) as e:
            main(["--tier-uri", "/x", "--quiet"])
        assert e.value.code == 2
        assert "--tier-uri requires durable mode" in capsys.readouterr().err


def test_gs_tier_without_google_cloud_storage_says_so(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "google.cloud.storage", None)
    monkeypatch.setitem(sys.modules, "google.cloud", None)
    with pytest.raises(ImportError, match="google-cloud-storage"):
        up.main(["--store-dir", str(tmp_path / "s"), "--tier-uri",
                 "gs://bucket/prefix", "--quiet"], device="cpu")
    # refused before the store was mounted: nothing holds its lock
    assert not (tmp_path / "s").exists()


def test_negative_retention_is_a_usage_error():
    with pytest.raises(SystemExit):
        up.main(["--retention", "-5", "--quiet"], device="cpu")


def test_connect_driver_unit_equals_jax():
    """With Connect, ``supervised()`` has JAX's units, ``connect-driver``
    among them, in JAX's order; a dead driver thread is respawned."""
    names = {}
    for kind, make in (("jax", lambda: JPlatform(partitions=1)),
                       ("port", lambda: Platform(partitions=1, cc_port=0,
                                                 connect_port=0,
                                                 device="cpu"))):
        plat = make().start()
        try:
            names[kind] = [u.name for u in plat.supervised().units()]
            if kind == "port":
                sup = plat.supervised(poll_interval_s=0.02).start()
                try:
                    assert _wait_for(lambda: sup.unit(
                        "connect-driver").state == "running")
                    old = plat.connect._driver
                    plat.connect._stop.set()  # the driver loop exits
                    old.join(timeout=10)
                    assert not old.is_alive()
                    plat.connect._stop.clear()
                    assert _wait_for(lambda: sup.unit(
                        "connect-driver").restarts >= 1
                        and plat.connect._driver is not old
                        and plat.connect._driver.is_alive())
                finally:
                    sup.stop()
        finally:
            plat.stop()
    assert names["port"] == names["jax"] == [
        "kafka-wire", "mqtt-front", "ksql-tasks", "connect-driver",
        "schema-registry", "control-center"]


def test_control_center_connectors_and_car_health_equal_jax():
    """The control center's ``connectors`` and ``car_health`` over the
    same platform state (car-health records pumped through the twin sink)
    equal JAX's, and so do the topics."""
    from iotml.obs.control_center import ControlCenter as JControlCenter
    from iotml_torch.obs.control_center import ControlCenter

    records = [("c%d" % (i % 7), {"car": "c%d" % (i % 7),
                                  "state": "ALERT" if i % 3 else "OK",
                                  "t": 1000 + i, "source": "mean",
                                  "ema": 0.5 + i})
               for i in range(40)]
    snaps = {}
    for kind, make, cc in (
            ("jax", lambda: JPlatform(partitions=2), JControlCenter),
            ("port", lambda: Platform(partitions=2, connect_port=0,
                                      cc_port=0, device="cpu"),
             ControlCenter)):
        plat = make()
        plat.connect.poll_interval_s = 3600
        plat.start()
        try:
            for car, doc in records:
                plat.broker.produce("car-health", json.dumps(doc).encode(),
                                    key=car.encode())
            plat.pump()
            snap = cc(plat).snapshot()
            snaps[kind] = {k: snap[k] for k in ("connectors", "car_health",
                                                "topics", "mqtt_sessions")}
        finally:
            plat.stop()
    assert snaps["port"] == snaps["jax"]
    ch = snaps["port"]["car_health"]
    assert snaps["port"]["connectors"] == ["car-health-twin"]
    assert ch["cars_tracked"] == 7 and ch["n_active"] == \
        len(ch["active_alerts"]) > 0
