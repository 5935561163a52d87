"""The port's live CLI, ``iotml_torch.cli.live``, on the CPU: ``train`` and
``score`` through ``main(argv, device="cpu")`` in two threads over the
port's Kafka wire server with SASL/PLAIN (the native client on both
ends), bounded by ``--max-seconds``; then its argument errors against the
JAX package's CLI, the unported flags and ``.h5`` names, an unreachable
server and the device rule.

Tolerance: none; return codes, rounds, counts and topics are exact.
"""

import json
import socket
import threading

import pytest
import torch

from iotml.cli import live as j_live
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
    assert all(s["artifact"] == f"cardata-live.r{s['round']}"
               for s in rounds)
    last = drains[-1]
    assert last["scored"] == 4000 and sum(last["quality"].values()) == 4000
    assert last["model_updates"] >= 1 and last["drain_complete"]
    assert last["artifact"].startswith("cardata-live.r")
    assert last["carhealth"]["cars_seen"] == 100
    assert broker.end_offset("model-predictions", 0) == 4000
    assert "car-health" in broker.topics()
    assert broker.committed("cardata-live-train", TOPIC, 0) is not None
    assert sum(broker.committed("cardata-live-score", TOPIC, p)
               for p in range(2)) == 4000
    value = broker.fetch("model-predictions", 0, 0, 1)[0].value
    assert value.startswith(b"[") and value.count(b"|") == 2


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


UNPORTED = [("--registry", "/tmp/reg", "A5"),
            ("--mesh-data", "2", "A10"), ("--device-normalize", "1", "A10"),
            ("--prefetch-depth", "2", "A7"),
            ("--decode-ring-buffers", "4", "A3, item 13"),
            ("--raw-batch-bytes", "4096", "A3, item 13"),
            ("--raw-produce", "on", "A13"),
            ("--produce-batch-bytes", "4096", "A13"),
            ("--metrics-port", "9137", "A13")]


@pytest.mark.parametrize("cmd", ["train", "score"])
@pytest.mark.parametrize("flag,value,item", UNPORTED)
def test_unported_flags_name_their_item(cmd, flag, value, item):
    pos = ["127.0.0.1:1", TOPIC, "root"] if cmd == "train" else \
        ["127.0.0.1:1", TOPIC, "out", "root"]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        live.main([cmd, *pos, flag, value], device="cpu")


def test_checkpoint_interval_and_h5_names_raise_a5():
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        live.main(["train", "127.0.0.1:1", TOPIC, "root",
                   "--checkpoint-interval-s", "0.5"], device="cpu")
    for argv in (["train", "127.0.0.1:1", TOPIC, "root"],
                 ["score", "127.0.0.1:1", TOPIC, "out", "root"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A5"):
            live.main([*argv, "--model-name", "cardata-live.h5"],
                      device="cpu")


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
