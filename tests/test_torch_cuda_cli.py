"""Card-only checks of the port's CLIs: train and predict on ``cuda``
through ``iotml_torch.cli.cardata.main``, and the long-lived scorer
``iotml_torch.cli.serve.main`` on the card, as a user runs them, on
``emulator`` and over the port's Kafka wire server (``host:port`` with
SASL/PLAIN, as the deploy manifests run them), the live train and
score services (``iotml_torch.cli.live``) as two processes, and the
creditcard job, the LSTM CLI and the MNIST smoke against their CPU runs.
Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cli.py

Tolerance: payloads parsed as floats within atol 1e-6 of the same job's
CPU run (float32 forwards whose sums run in another order on each
device); counts, offsets and return codes equal.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from iotml_torch.cli import _app
from iotml_torch.cli import cardata
from iotml_torch.cli import serve
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.ops import fused_train
from iotml_torch.serve import fastfmt
from iotml_torch.serve import scorer
from iotml_torch.stream import native
from iotml_torch.stream.kafka_wire import KafkaWireServer

ARGS = ["SENSOR_DATA_S_AVRO", "0", "model-predictions"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(monkeypatch, argv, **kw):
    brokers = []
    real = _app._broker_for

    def spy(*a):
        brokers.append(real(*a))
        return brokers[-1]

    monkeypatch.setattr(_app, "_broker_for", spy)
    return cardata.main(argv, **kw), brokers[0]


def _payloads(broker):
    end = broker.end_offset("model-predictions", 0)
    return [np.array(m.value.decode().strip("[]").split(), float)
            for m in broker.fetch("model-predictions", 0, 0, end + 1)]


@pytest.mark.cuda
def test_cli_train_predict_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The reference job at its own shape: one fit launch through the
    rows design, 10,000 predictions, the native engine on both legs."""
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)
    root = str(tmp_path / "store")
    rc, _ = _run(monkeypatch, ["emulator:30000", *ARGS, "train", "m1", root])
    assert rc == 0
    assert fused_train.fused_fit.launches == 1
    assert fused_train.fused_fit.launches_by_design["rows"] == 1
    native.reset_stats()
    formatted = []
    real_format = scorer.format_rows

    def format_spy(rows):
        formatted.append(rows)
        return real_format(rows)

    monkeypatch.setattr(scorer, "format_rows", format_spy)
    rc, card = _run(monkeypatch,
                    ["emulator:30000", *ARGS, "predict", "m1", root])
    assert rc == 0
    assert native.stats["decode_rows"] == 20_000
    # the engine formatted every row its fast path takes, numpy the rest
    rows = np.concatenate(formatted)
    assert rows.shape[0] == 10_000
    assert native.stats["format_rows"] == int(fastfmt.fast_rows(rows).sum())
    assert native.stats["format_rows"] > 0
    rc, cpu = _run(monkeypatch,
                   ["emulator:30000", *ARGS, "predict", "m1", root],
                   device="cpu")
    assert rc == 0
    got, want = _payloads(card), _payloads(cpu)
    assert len(got) == len(want) == 10_000
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("argv", [
    ["too", "few"],
    ["emulator", "t", "0", "r", "badmode", "m", "/x"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--train.epochs=abc"],
])
def test_cli_argument_errors_on_the_card(cuda_device, argv):
    assert cardata.main(argv) == 1


@pytest.mark.cuda
def test_serve_committed_on_the_card(cuda_device, tmp_path, monkeypatch):
    """``serve ... committed`` scores the whole stream on the card with
    threshold verdicts, resumes with only the new records, and its
    payloads equal a CPU serve of the same log."""
    root = str(tmp_path / "store")
    rc, _ = _run(monkeypatch, ["emulator:30000", *ARGS, "train", "m1", root])
    assert rc == 0
    logs = {}
    make_broker = _app._broker_for
    for device in ("cuda", "cpu"):
        broker = make_broker("emulator:30000", ARGS[0])
        monkeypatch.setattr(_app, "_broker_for", lambda *a, b=broker: b)
        argv = ["emulator:30000", ARGS[0], "committed", ARGS[2], "m1", root,
                "--serve.poll_interval_s=0", "--serve.threshold=5"]
        kw = {} if device == "cuda" else {"device": "cpu"}
        assert serve.main(argv, max_rounds=2, **kw) == 0
        assert broker.end_offset("model-predictions", 0) == 30_000
        assert broker.committed(serve.GROUP, ARGS[0], 0) == 30_000
        # 500 more records: only they are scored
        FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01)) \
            .publish(broker, ARGS[0], n_ticks=5)
        assert serve.main(argv, max_rounds=2, **kw) == 0
        assert broker.end_offset("model-predictions", 0) == 30_500
        end = broker.end_offset("model-predictions", 0)
        logs[device] = [m.value.decode() for m in
                        broker.fetch("model-predictions", 0, 0, end)]
    assert all(p.split("|")[1] in ("normal", "anomaly")
               for p in logs["cuda"])
    for g, w in zip(logs["cuda"], logs["cpu"]):
        np.testing.assert_allclose(
            np.array(g.split("|")[0].strip("[]").split(), float),
            np.array(w.split("|")[0].strip("[]").split(), float),
            rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_serve_argument_errors_on_the_card(cuda_device):
    assert serve.main(["too", "few"]) == 1


@pytest.mark.cuda
def test_cli_over_the_wire_on_the_card(cuda_device, tmp_path, monkeypatch):
    """cardata train + predict and serve committed on ``127.0.0.1:<port>``
    with SASL credentials from the environment: one fit launch through
    the rows design, and payloads byte-identical to the same jobs on
    ``emulator`` on the card."""
    monkeypatch.setenv("IOTML_BROKER_SASL_USERNAME", "svc")
    monkeypatch.setenv("IOTML_BROKER_SASL_PASSWORD", "pw")
    backing = _app._broker_for("emulator:30000", ARGS[0])
    wire_root, emu_root = str(tmp_path / "wire"), str(tmp_path / "emu")
    with KafkaWireServer(backing, credentials=("svc", "pw")) as srv:
        servers = f"127.0.0.1:{srv.port}"
        fused_train.fused_fit.launches = 0
        fused_train.fused_fit.launches_by_design = dict.fromkeys(
            fused_train.DESIGNS, 0)
        assert cardata.main([servers, *ARGS, "train", "m1", wire_root]) == 0
        assert fused_train.fused_fit.launches == 1
        assert fused_train.fused_fit.launches_by_design["rows"] == 1
        assert cardata.main([servers, *ARGS, "predict", "m1", wire_root]) \
            == 0
    for mode in ("train", "predict"):
        rc, emu = _run(monkeypatch, ["emulator:30000", *ARGS, mode, "m1",
                                     emu_root])
        assert rc == 0
    end = backing.end_offset("model-predictions", 0)
    assert end == 10_000
    assert [m.value for m in backing.fetch("model-predictions", 0, 0, end)] \
        == [m.value for m in emu.fetch("model-predictions", 0, 0, end)]

    log = _app._broker_for("emulator:30000", ARGS[0])
    with KafkaWireServer(log, credentials=("svc", "pw")) as srv:
        argv = [f"127.0.0.1:{srv.port}", ARGS[0], "committed", ARGS[2], "m1",
                wire_root, "--serve.poll_interval_s=0", "--serve.threshold=5"]
        assert serve.main(argv, max_rounds=2) == 0
    assert log.end_offset("model-predictions", 0) == 30_000
    assert log.committed(serve.GROUP, ARGS[0], 0) == 30_000


@pytest.mark.cuda
def test_live_services_as_two_processes_on_the_card(cuda_device, tmp_path):
    """``python -m iotml_torch.cli.live train`` and ``score`` as two OS
    processes on the card over ``127.0.0.1:<port>`` with SASL/PLAIN,
    through the native client: at least 3 rounds published, every record
    scored, at least one hot swap, both exit 0 on a STOP line."""
    backing = _app._broker_for("emulator:10000", ARGS[0])
    root = str(tmp_path / "live")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with KafkaWireServer(backing, credentials=("svc", "pw")) as srv:
        addr = f"127.0.0.1:{srv.port}"
        common = ["--sasl", "svc:pw", "--stats", "--max-seconds", "300"]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "iotml_torch.cli.live", *argv, *common],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=repo)
            for argv in (["train", addr, ARGS[0], root],
                         ["score", addr, ARGS[0], ARGS[2], root])]
        try:
            deadline = time.time() + 240
            while time.time() < deadline and \
                    backing.end_offset("model-predictions", 0) < 10_000:
                time.sleep(0.2)
            while time.time() < deadline and (backing.committed(
                    "cardata-live-train", ARGS[0], 0) or 0) < 6000:
                time.sleep(0.2)
            outs = []
            for p in procs:
                p.stdin.write("STOP\n")
                p.stdin.flush()
                outs.append(p.communicate(timeout=60)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    rounds, drains = ([json.loads(line) for line in out.splitlines()
                       if line.startswith("{")] for out in outs)
    assert rounds[-1]["round"] >= 3
    assert drains[-1]["scored"] == 10_000
    assert drains[-1]["model_updates"] >= 1
    assert backing.end_offset("model-predictions", 0) == 10_000


@pytest.mark.cuda
def test_creditcard_job_on_the_card(cuda_device, monkeypatch):
    """The creditcard job on the card: one fit launch through the rows
    design at (30, 14, 7), B = 32; its params within the fit bounds
    (rtol 5e-3 / atol 2e-5) and final loss within rtol 2e-4 / atol 1e-6
    of the same job on the CPU; AUC > 0.9 on both, within 1e-3 of each
    other (scores from params a fit bound apart)."""
    from iotml_torch.cli import creditcard

    trainers = []

    class Recorded(creditcard.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    monkeypatch.setattr(creditcard, "Trainer", Recorded)
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)
    card = creditcard.run(["synth:3000"])
    assert fused_train.fused_fit.launches == 1
    assert fused_train.fused_fit.launches_by_design["rows"] == 1
    cpu = creditcard.run(["synth:3000"], device="cpu")
    np.testing.assert_allclose(card["final_loss"], cpu["final_loss"],
                               rtol=2e-4, atol=1e-6)
    for k, v in trainers[0].state.params.items():
        np.testing.assert_allclose(v.cpu().numpy(),
                                   trainers[1].state.params[k].numpy(),
                                   rtol=5e-3, atol=2e-5, err_msg=k)
    assert card["report"]["n"] == cpu["report"]["n"] == 3000
    assert card["report"]["roc_auc"] > 0.9
    assert abs(card["report"]["roc_auc"] - cpu["report"]["roc_auc"]) < 1e-3


@pytest.mark.cuda
def test_lstm_cli_on_the_card(cuda_device, tmp_path, monkeypatch):
    """The LSTM CLI trains on the card (no kernel launch) within the fit
    bounds of the CPU's train, and the card's predict from the CPU's
    checkpoint writes the CPU predict's payloads (atol 1e-6)."""
    from iotml_torch.cli import lstm

    fused_train.fused_fit.launches = 0
    roots = {d: str(tmp_path / d) for d in ("cuda", "cpu")}
    losses = {}
    for d, root in roots.items():
        kw = {} if d == "cuda" else {"device": "cpu"}
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc, _ = _run_main(monkeypatch, lstm.main,
                              ["emulator:4000", *ARGS, "train", "l1", root],
                              **kw)
        assert rc == 0
        stats = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith("stats: ")]
        losses[d] = json.loads(stats[-1][len("stats: "):])["loss"]
    assert fused_train.fused_fit.launches == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=2e-4,
                               atol=1e-6)
    payloads = {}
    for d in ("cuda", "cpu"):
        kw = {} if d == "cuda" else {"device": "cpu"}
        rc, broker = _run_main(monkeypatch, lstm.main,
                               ["emulator:4000", *ARGS, "predict", "l1",
                                roots["cpu"]], **kw)
        assert rc == 0
        payloads[d] = [np.array(m.value.decode().replace("[", " ")
                                .replace("]", " ").split(), float)
                       for m in broker.fetch("model-predictions", 0, 0,
                                             1 << 20)]
    assert len(payloads["cuda"]) == len(payloads["cpu"]) == 192
    for g, w in zip(payloads["cuda"], payloads["cpu"]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _run_main(monkeypatch, main, argv, **kw):
    brokers = []
    real = _app._broker_for
    monkeypatch.setattr(_app, "_broker_for",
                        lambda *a: brokers.append(real(*a)) or brokers[-1])
    return main(argv, **kw), brokers[0]


@pytest.mark.cuda
def test_mnist_smoke_on_the_card(cuda_device):
    """The MNIST smoke on the card: ingestion intact, and both models'
    losses and accuracies within rtol 1e-4 of the CPU's run (the same
    seeded init on both)."""
    from iotml_torch.cli import mnist_smoke

    card = mnist_smoke.run(["--n", "640"])
    cpu = mnist_smoke.run(["--n", "640"], device="cpu")
    assert card["ingestion_intact"] is cpu["ingestion_intact"] is True
    for path in ("streamed", "control"):
        for metric in ("loss", "accuracy"):
            np.testing.assert_allclose(card[path][metric], cpu[path][metric],
                                       rtol=1e-4, atol=0)
