"""The port's CLIs on ``host:port``, as the deploy manifests run them
(``deploy/model-training.yaml``, ``deploy/model-predictions.yaml``), over
the port's ``KafkaWireServer`` with SASL/PLAIN, on the CPU at a small size
(fleet logs of 3,000 records, batch 10, 2 epochs).

- ``cardata`` train then predict over the wire store the same params and
  write the same payloads, byte for byte, as the same job on
  ``emulator``: the server's backing broker is the emulator's log.
- ``serve ... committed`` over the wire, with a resume, writes the same
  payloads, byte for byte, as on ``emulator``.
- ``serve ... group``: two members in threads (JAX's
  tests/test_serve_cli.py:50-110) commit every partition at its end, and
  score between n and 2n records; a member that stops polling is expired
  after a 300 ms session and the survivor takes its partitions.
- ``host:port`` with nothing listening raises the same exception type in
  both packages.

Every server binds 127.0.0.1:0; every thread join has a timeout.
"""

import json
import threading
import time

import numpy as np
import pytest

from iotml.cli import cardata as j_cardata
from iotml.cli import serve as j_serve
from iotml_torch.cli import _app
from iotml_torch.cli import cardata
from iotml_torch.cli import serve
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import PARAM_NAMES
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.group import GroupConsumer
from iotml_torch.stream.kafka_wire import (KafkaWireBroker, KafkaWireServer,
                                           RemoteGroupCoordinator)
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager

TOPIC, RESULTS = "SENSOR_DATA_S_AVRO", "model-predictions"
SMALL = ["--train.epochs=2", "--train.batch_size=10"]
CREDS = ("svc", "s3cret")
JOIN_S = 120.0


@pytest.fixture
def sasl_env(monkeypatch):
    """The manifests' credentials, by environment."""
    monkeypatch.setenv("IOTML_BROKER_SASL_USERNAME", CREDS[0])
    monkeypatch.setenv("IOTML_BROKER_SASL_PASSWORD", CREDS[1])


def _emulator_log(n=3000):
    """The log ``emulator:<n>`` makes, to back a wire server."""
    return _app._broker_for(f"emulator:{n}", TOPIC)


def _manifest_argv(servers, mode, root):
    """deploy/model-training.yaml's argv, host and root replaced."""
    return [servers, TOPIC, "0", RESULTS, mode, "model1", str(root), *SMALL]


def _run_emulator(main, argv, **kw):
    """Run a CLI on emulator; returns (rc, the broker it made)."""
    made = []
    real = _app._broker_for

    def spy(*a):
        made.append(real(*a))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_app, "_broker_for", spy)
        rc = main(argv, **kw)
    return rc, made[0]


def _payloads(broker, start=0):
    end = broker.end_offset(RESULTS, 0)
    return [m.value for m in broker.fetch(RESULTS, 0, start, end + 1)]


def _params(root, tmp_path, tag):
    ckpt = CheckpointManager.load_dir(ArtifactStore(str(root)).download_tree(
        "model1", str(tmp_path / f"restore_{tag}")))
    return ckpt


def _stats(out: str) -> dict:
    return json.loads(out.split("stats: ")[-1].splitlines()[0])


def test_cardata_manifest_over_the_wire_matches_emulator(tmp_path, sasl_env,
                                                         capsys):
    backing = _emulator_log()
    with KafkaWireServer(backing, credentials=CREDS) as srv:
        servers = f"127.0.0.1:{srv.port}"
        for mode in ("train", "predict"):
            assert cardata.main(_manifest_argv(servers, mode,
                                               tmp_path / "wire"),
                                device="cpu") == 0
            assert _stats(capsys.readouterr().out)["broker"] == "wire"
    for mode in ("train", "predict"):
        rc, emu = _run_emulator(cardata.main, _manifest_argv(
            "emulator:3000", mode, tmp_path / "emu"), device="cpu")
        assert rc == 0
        assert _stats(capsys.readouterr().out)["broker"] == "emulator"
    # the same stored params, bit for bit, and the same cursor
    wire, want = _params(tmp_path / "wire", tmp_path, "w"), \
        _params(tmp_path / "emu", tmp_path, "e")
    for k in PARAM_NAMES:
        assert np.array_equal(wire["params"][k].numpy(),
                              want["params"][k].numpy())
    assert wire["cursors"] == want["cursors"] == [(TOPIC, 0, 1010)]
    # the same payloads, byte for byte, written back over the wire
    got = _payloads(backing)
    assert len(got) == 1000 and got == _payloads(emu)
    assert backing.committed("cardata-autoencoder", TOPIC, 0) == 2000


@pytest.fixture(scope="module")
def model_root(tmp_path_factory):
    """A model trained by the port's CLI on emulator, as ``model1``."""
    root = tmp_path_factory.mktemp("serve_model")
    rc, _ = _run_emulator(cardata.main, _manifest_argv("emulator:3000",
                                                        "train", root),
                          device="cpu")
    assert rc == 0
    return str(root)


def _serve_argv(servers, offset, root):
    """deploy/model-predictions.yaml's argv, host and root replaced."""
    return [servers, TOPIC, offset, RESULTS, "model1", root,
            "--serve.poll_interval_s=0", "--serve.threshold=0.2"]


def test_serve_committed_over_the_wire_matches_emulator(model_root, sasl_env,
                                                        monkeypatch, capsys):
    logs = {}
    for kind in ("wire", "emulator"):
        log = _emulator_log()
        if kind == "emulator":
            monkeypatch.setattr(_app, "_broker_for", lambda *a, b=log: b)
            servers, srv = "emulator:3000", None
        else:
            srv = KafkaWireServer(log, credentials=CREDS).start()
            servers = f"127.0.0.1:{srv.port}"
        try:
            assert serve.main(_serve_argv(servers, "committed", model_root),
                              max_rounds=2, device="cpu") == 0
            stats = _stats(capsys.readouterr().out)
            assert (stats["broker"], stats["rows"]) == (kind, 3000)
            assert log.committed(serve.GROUP, TOPIC, 0) == 3000
            FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01)) \
                .publish(log, TOPIC, n_ticks=5)
            assert serve.main(_serve_argv(servers, "committed", model_root),
                              max_rounds=2, device="cpu") == 0
            assert _stats(capsys.readouterr().out)["rows"] == 500
            assert log.committed(serve.GROUP, TOPIC, 0) == 3500
        finally:
            if srv is not None:
                srv.shutdown()
                srv.server_close()
        logs[kind] = _payloads(log)
    assert len(logs["wire"]) == 3500
    assert logs["wire"] == logs["emulator"]
    assert {p.split(b"|")[1] for p in logs["wire"]} == {b"normal", b"anomaly"}


def test_serve_group_two_members_over_the_wire(model_root, sasl_env):
    """Two scorer replicas (separate wire clients, threads here) share
    the group through the server: every partition ends committed at its
    end offset, and n <= scored <= 2n (a rebalance mid-drain redelivers
    uncommitted records: at-least-once)."""
    backing = Broker()
    n = FleetGenerator(FleetScenario(num_cars=40, failure_rate=0.0)).publish(
        backing, TOPIC, n_ticks=50, partitions=4)
    backing.create_topic(RESULTS, partitions=1)
    with KafkaWireServer(backing, credentials=CREDS) as srv:
        argv = [f"127.0.0.1:{srv.port}", TOPIC, "group", RESULTS, "model1",
                model_root, "--serve.poll_interval_s=0.05"]
        rcs = [None, None]

        def run(i):
            rcs[i] = serve.main(list(argv), max_rounds=6, device="cpu")

        threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
            assert not t.is_alive()
        assert rcs == [0, 0]
    for p in range(4):
        assert backing.committed(serve.GROUP, TOPIC, p) == \
            backing.end_offset(TOPIC, p)
    assert n <= backing.end_offset(RESULTS, 0) <= 2 * n


def test_group_member_crash_over_the_wire_is_healed():
    """A member that stops polling is expired by the server after its
    300 ms session; the survivor takes every partition at the last
    commits and every record is delivered."""
    backing = Broker()
    backing.create_topic("t", partitions=4)
    for i in range(400):
        backing.produce("t", b"r%d" % i, partition=i % 4)
    with KafkaWireServer(backing) as srv:
        addr = f"127.0.0.1:{srv.port}"
        c1, c2 = (KafkaWireBroker(addr, timeout_s=5.0) for _ in range(2))
        a = GroupConsumer(RemoteGroupCoordinator(c1, "g", 300), ["t"],
                          member_id="a")
        b = GroupConsumer(RemoteGroupCoordinator(c2, "g", 300), ["t"],
                          member_id="b")
        seen = [m.value for m in a.poll(1)]  # heal after b's join
        assert len(a.assignment) == len(b.assignment) == 2
        seen += [m.value for m in b.poll()]
        assert b.commit() is True
        # b crashes: no more polls, no leave
        deadline = time.monotonic() + 10.0
        while a.assignment != [("t", p) for p in range(4)]:
            assert time.monotonic() < deadline
            time.sleep(0.1)
            seen += [m.value for m in a.poll()]
        while True:
            msgs = a.poll()
            if not msgs:
                break
            seen += [m.value for m in msgs]
        assert a.commit() is True
        assert sorted(set(seen)) == sorted(b"r%d" % i for i in range(400))
        assert [backing.committed("g", "t", p) for p in range(4)] == \
            [100] * 4
        c1.close()
        c2.close()


@pytest.mark.parametrize("which", ["cardata", "serve"])
def test_nothing_listening_raises_like_jax(tmp_path, which):
    servers = "127.0.0.1:1"
    if which == "cardata":
        argv = _manifest_argv(servers, "train", tmp_path)
        t_main = lambda: cardata.main(argv, device="cpu")  # noqa: E731
        j_main = lambda: j_cardata.main(argv)  # noqa: E731
    else:
        argv = _serve_argv(servers, "committed", str(tmp_path))
        t_main = lambda: serve.main(argv, device="cpu")  # noqa: E731
        j_main = lambda: j_serve.main(argv)  # noqa: E731
    with pytest.raises(OSError) as t_err:
        t_main()
    with pytest.raises(OSError) as j_err:
        j_main()
    assert type(t_err.value) is type(j_err.value) is ConnectionRefusedError
    assert not (tmp_path / "model1").exists()


def test_wrong_sasl_password_is_refused_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("IOTML_BROKER_SASL_USERNAME", CREDS[0])
    monkeypatch.setenv("IOTML_BROKER_SASL_PASSWORD", "wrong")
    with KafkaWireServer(_emulator_log(100), credentials=CREDS) as srv:
        argv = _manifest_argv(f"127.0.0.1:{srv.port}", "train", tmp_path)
        with pytest.raises(ConnectionError):
            cardata.main(argv, device="cpu")
        with pytest.raises(ConnectionError):
            j_cardata.main(argv)
    assert not (tmp_path / "model1").exists()
