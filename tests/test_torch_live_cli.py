"""The port's live CLI, ``iotml_torch.cli.live``, on the CPU: ``train`` and
``score`` through ``main(argv, device="cpu")`` in two threads over the
port's Kafka wire server with SASL/PLAIN (the native client on both
ends), bounded by ``--max-seconds``, with the artifact store's pointer
and with a model registry (``--registry`` or ``IOTML_MLOPS_REGISTRY_DIR``);
then its defaults and argument errors against the JAX package's CLI, the
unported flags, an unreachable server and the device rule.

Tolerance: none; return codes, rounds, counts and topics are exact.
"""

import argparse
import json
import os
import socket
import threading

import pytest
import torch

from iotml.cli import live as j_live
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml_torch.cli import live
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.kafka_wire import KafkaWireServer

TOPIC = "SENSOR_DATA_S_AVRO"
CREDS = ("svc", "pw")


def _records(n=4000, partitions=2):
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.05)).publish(
        broker, TOPIC, n_ticks=n // 100, partitions=partitions)
    broker.create_topic("model-predictions")
    return broker


@pytest.mark.parametrize("extra", [
    ([], []),
    (["--normalize", "full"],
     ["--normalize", "full", "--car-feature-heads", "--car-threshold",
      "auto", "--threshold", "0.5"]),
])
def test_train_and_score_in_threads_over_the_wire(tmp_path, capsys, extra):
    broker = _records()
    root = str(tmp_path)
    rcs = {}
    with KafkaWireServer(broker, credentials=CREDS) as srv:
        addr = f"127.0.0.1:{srv.port}"
        sasl = ["--sasl", ":".join(CREDS), "--stats"]
        argvs = {"train": ["train", addr, TOPIC, root, "--take-batches",
                           "10", "--max-seconds", "6", *sasl, *extra[0]],
                 "score": ["score", addr, TOPIC, "model-predictions", root,
                           "--max-seconds", "9", *sasl, *extra[1]]}

        def run(cmd):
            rcs[cmd] = live.main(argvs[cmd], device="cpu")

        threads = [threading.Thread(target=run, args=(c,)) for c in argvs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert rcs == {"train": 0, "score": 0}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    rounds = [s for s in lines if "round" in s]
    drains = [s for s in lines if "scored" in s]
    # 4,000 records, 1,000 a round, a round waits for 1,101 new ones
    assert [s["round"] for s in rounds] == [1, 2, 3]
    assert rounds[-1]["records_cum"] == 3000
    assert all(s["artifact"] == f"cardata-live.h5.r{s['round']}"
               for s in rounds)
    last = drains[-1]
    assert last["scored"] == 4000 and sum(last["quality"].values()) == 4000
    assert last["model_updates"] >= 1 and last["drain_complete"]
    assert last["artifact"].startswith("cardata-live.h5.r")
    assert last["carhealth"]["cars_seen"] == 100
    assert broker.end_offset("model-predictions", 0) == 4000
    assert "car-health" in broker.topics()
    assert broker.committed("cardata-live-train", TOPIC, 0) is not None
    assert sum(broker.committed("cardata-live-score", TOPIC, p)
               for p in range(2)) == 4000
    value = broker.fetch("model-predictions", 0, 0, 1)[0].value
    assert value.startswith(b"[") and value.count(b"|") == 2


def _run_threads(argvs):
    rcs = {}

    def run(cmd):
        rcs[cmd] = live.main(argvs[cmd], device="cpu")

    threads = [threading.Thread(target=run, args=(c,)) for c in argvs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return rcs


@pytest.mark.parametrize("how", ["flag", "env"])
def test_registry_train_and_score_in_threads_over_the_wire(
        tmp_path, capsys, monkeypatch, how):
    """``--registry``: every round a committed version (cadence 0) and an
    h5 blob in the store, the
    group's committed offsets those of the newest manifest at the end,
    the scorer following the serving channel to the newest version; the
    JAX package reads the same registry."""
    broker = _records()
    root, reg_dir = str(tmp_path / "store"), str(tmp_path / "reg")
    reg = ["--registry", reg_dir] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("IOTML_MLOPS_REGISTRY_DIR", reg_dir)
    monkeypatch.setenv("IOTML_MLOPS_KEEP_VERSIONS", "2")
    with KafkaWireServer(broker, credentials=CREDS) as srv:
        addr = f"127.0.0.1:{srv.port}"
        sasl = ["--sasl", ":".join(CREDS), "--stats", *reg]
        rcs = _run_threads({
            "train": ["train", addr, TOPIC, root, "--take-batches", "10",
                      "--checkpoint-interval-s", "0", "--max-seconds", "6",
                      *sasl],
            "score": ["score", addr, TOPIC, "model-predictions", root,
                      "--max-seconds", "9", *sasl]})
    assert rcs == {"train": 0, "score": 0}
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    rounds = [s for s in lines if "round" in s]
    drains = [s for s in lines if "scored" in s]
    assert [s["round"] for s in rounds] == [1, 2, 3]
    # the store's pointer flow rides along, as in the JAX CLI
    assert all(s["artifact"] == f"cardata-live.h5.r{s['round']}"
               for s in rounds)
    jreg = JModelRegistry(reg_dir)
    assert jreg.versions() == [2, 3]  # IOTML_MLOPS_KEEP_VERSIONS=2
    assert jreg.channel("serving") == 3
    newest = jreg.manifest(3)
    assert newest.step == 30 and newest.metrics["records"] == 3000.0
    assert [broker.committed("cardata-live-train", t, p)
            for t, p, _ in newest.offsets] == [o for _, _, o in newest.offsets]
    last = drains[-1]
    assert last["scored"] == 4000 and last["drain_complete"]
    assert last["artifact"].startswith("registry:v")


class _Parsed(Exception):
    pass


def _parsed(main, argv, monkeypatch):
    """The namespace ``main`` parses ``argv`` into (stopped right after)."""
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(real(self, args, namespace))

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as e:
            main(argv)
    return vars(e.value.args[0])


@pytest.mark.parametrize("argv", [["train", "h:1", TOPIC, "root"],
                                  ["score", "h:1", TOPIC, "out", "root"]])
def test_defaults_match_jax(monkeypatch, argv):
    """Every option both CLIs have defaults alike: ``--model-name``
    ``cardata-live.h5``, ``--checkpoint-interval-s`` 0.5, ``--registry``
    none, ``--metrics-port`` 0 (off), ..."""
    got = _parsed(live.main, argv, monkeypatch)
    want = _parsed(j_live.main, argv, monkeypatch)
    assert got == want
    assert got["metrics_port"] == 0
    assert got["model_name"] == "cardata-live.h5"
    assert got.get("checkpoint_interval_s", 0.5) == 0.5


@pytest.mark.parametrize("argv", [
    [],
    ["train"],
    ["train", "127.0.0.1:1", TOPIC],
    ["score", "127.0.0.1:1", TOPIC, "out"],
    ["serve", "127.0.0.1:1", TOPIC, "root"],
    ["train", "127.0.0.1:1", TOPIC, "root", "--normalize", "both"],
    ["train", "127.0.0.1:1", TOPIC, "root", "--take-batches", "x"],
    ["score", "127.0.0.1:1", TOPIC, "out", "root", "--threshold", "high"],
])
def test_argument_errors_exit_as_jax(argv):
    codes = []
    for main in (live.main, j_live.main):
        with pytest.raises(SystemExit) as e:
            main(list(argv))
        codes.append(e.value.code)
    assert codes == [2, 2]


#: each knob flag → the environment variable it sets; the ids of the
#: three mesh flags are those of the cases that refused them before
#: the mesh path was ported
UNPORTED = [pytest.param("--mesh-data", "2", "IOTML_MESH_DATA",
                         id="--mesh-data-2-A10"),
            pytest.param("--device-normalize", "1", "IOTML_DEVICE_NORMALIZE",
                         id="--device-normalize-1-A10"),
            pytest.param("--prefetch-depth", "2", "IOTML_PREFETCH_DEPTH",
                         id="--prefetch-depth-2-A10"),
            ("--decode-ring-buffers", "4", "IOTML_DECODE_RING_BUFFERS"),
            ("--raw-batch-bytes", "4096", "IOTML_RAW_BATCH_BYTES"),
            ("--raw-produce", "on", "IOTML_RAW_PRODUCE"),
            ("--produce-batch-bytes", "4096", "IOTML_PRODUCE_BATCH_BYTES")]


@pytest.mark.parametrize("cmd", ["train", "score"])
@pytest.mark.parametrize("flag,value,item", UNPORTED)
def test_unported_flags_name_their_item(cmd, flag, value, item,
                                        monkeypatch):
    """Each knob flag sets its knob for the process before the client
    connects (here to a port nothing listens on), in both packages;
    ``--mesh-data 2`` lays a train mesh over two of ``devices`` first,
    and ``--device-normalize 1`` without a mesh is a usage error in
    both."""
    pos = ["127.0.0.1:1", TOPIC, "root"] if cmd == "train" else \
        ["127.0.0.1:1", TOPIC, "out", "root"]
    for k in ("IOTML_MESH_DATA", "IOTML_DEVICE_NORMALIZE", item):
        monkeypatch.setenv(k, "")  # restored after the test
    argv = [cmd, *pos, flag, value]
    cpu = [torch.device("cpu")] * 2
    if item == "IOTML_DEVICE_NORMALIZE":
        codes = []
        for main, kw in ((live.main, {"device": "cpu", "devices": cpu}),
                         (j_live.main, {})):
            with pytest.raises(SystemExit) as e:
                main(argv, **kw)
            codes.append(e.value.code)
        assert codes == [2, 2]
        return
    for main, kw in ((live.main, {"device": "cpu", "devices": cpu}),
                     (j_live.main, {})):
        monkeypatch.setenv(item, "")
        with pytest.raises(OSError):
            main(argv, **kw)
        assert os.environ[item] == value
    # more mesh devices than there are is a usage error, as in JAX's CLI
    if flag == "--mesh-data" and cmd == "train":
        with pytest.raises(SystemExit) as e:
            live.main(argv, device="cpu", devices=cpu[:1])
        assert e.value.code == 2


def test_unreachable_server_raises_oserror(tmp_path):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(OSError):
        live.main(["train", f"127.0.0.1:{port}", TOPIC, str(tmp_path)],
                  device="cpu")


def test_missing_topic_returns_1(tmp_path, capsys):
    with KafkaWireServer(Broker()) as srv:
        rc = live.main(["train", f"127.0.0.1:{srv.port}", TOPIC,
                        str(tmp_path), "--wait-topic-seconds", "0.3"],
                       device="cpu")
    assert rc == 1
    assert f"topic {TOPIC} not available" in capsys.readouterr().out


def test_no_card_and_no_device_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        live.main(["train", "127.0.0.1:1", TOPIC, str(tmp_path)])


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("cmd", ["train", "score"])
def test_metrics_port_serves_metrics_and_healthz(tmp_path, cmd):
    """The service answers ``/metrics`` and ``/healthz`` on
    ``--metrics-port`` while it runs, with its own families and
    watermarks; the server is gone when ``main`` returns."""
    import urllib.request

    broker = _records(n=3000)
    root = str(tmp_path)
    port = _free_port()
    rcs = {}
    with KafkaWireServer(broker, credentials=CREDS) as srv:
        addr = f"127.0.0.1:{srv.port}"
        sasl = ["--sasl", ":".join(CREDS)]
        argvs = {"train": ["train", addr, TOPIC, root, "--take-batches",
                           "10", "--max-seconds", "5", *sasl],
                 "score": ["score", addr, TOPIC, "model-predictions", root,
                           "--max-seconds", "7", *sasl]}
        for c in argvs:
            if c == cmd:
                argvs[c] += ["--metrics-port", str(port)]

        def run(c):
            rcs[c] = live.main(argvs[c], device="cpu")

        threads = [threading.Thread(target=run, args=(c,)) for c in argvs]
        for t in threads:
            t.start()
        want = ("live_train_rounds_total" if cmd == "train"
                else "iotml_records_scored_total")
        metrics = health = None
        deadline = __import__("time").time() + 60
        while __import__("time").time() < deadline:
            try:
                metrics = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=5
                ).read().decode()
                health = json.loads(urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz", timeout=5).read())
            except OSError:
                metrics = None
            stage = "train" if cmd == "train" else "score"
            if metrics and any(k.startswith(f"{stage}:")
                               for k in health.get("watermarks", {})):
                break
            __import__("time").sleep(0.1)
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert rcs == {"train": 0, "score": 0}
    assert metrics is not None and f"# TYPE {want}" in metrics
    assert health["status"] == "ok"
    assert any(k.startswith("consume:") for k in health["watermarks"])
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=2)


@pytest.mark.parametrize("cmd", ["train", "score"])
def test_metrics_port_that_cannot_bind_raises(tmp_path, cmd):
    """A ``--metrics-port`` another socket holds raises EADDRINUSE before
    the service connects to its broker (here nobody listens)."""
    import errno

    holder = socket.socket()
    holder.bind(("0.0.0.0", 0))
    holder.listen(1)
    pos = ["127.0.0.1:1", TOPIC, str(tmp_path)] if cmd == "train" else \
        ["127.0.0.1:1", TOPIC, "out", str(tmp_path)]
    try:
        with pytest.raises(OSError) as e:
            live.main([cmd, *pos, "--metrics-port",
                       str(holder.getsockname()[1])], device="cpu")
    finally:
        holder.close()
    assert e.value.errno == errno.EADDRINUSE
