"""Card-only checks of the port's cardata CLI: train and predict on
``cuda`` through ``iotml_torch.cli.cardata.main``, as a user runs it.
Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cli.py

Tolerance: payloads parsed as floats within atol 1e-6 of the same job's
CPU run (float32 forwards whose sums run in another order on each
device); counts, offsets and return codes equal.
"""

import numpy as np
import pytest
import torch

from iotml_torch.cli import _app
from iotml_torch.cli import cardata
from iotml_torch.ops import fused_train
from iotml_torch.serve import fastfmt
from iotml_torch.serve import scorer
from iotml_torch.stream import native

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
