"""The port's LSTM CLI (``iotml_torch.cli.lstm``) against the JAX
package's on the CPU: train, then predict, on ``emulator:4000``, as
JAX's tests/test_lstm_cli.py runs it.

Tolerances:
- return codes, messages, committed offsets, checkpoint cursors and the
  number and order of predictions: equal;
- the port's own payloads against a recompute from its restored
  checkpoint: byte-equal (the same forward on the same rows);
- payloads of the two CLIs from the same (JAX-trained, converted)
  checkpoint: the printed values parsed as floats, atol 1e-6
  (``np.array2string`` of float32 forwards an ulp apart can differ in a
  last digit).
"""

import json

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from iotml.cli import _app as j_app
from iotml.cli import lstm as j_lstm
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml_torch.cli import _app as t_app
from iotml_torch.cli import lstm
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.models.convert import (lstm_adam_from_optax,
                                        lstm_params_from_jax)
from iotml_torch.models.lstm import LSTMSpec
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.loop import TrainState

TOPIC, GROUP = "SENSOR_DATA_S_AVRO", "cardata-lstm"
PAYLOAD_ATOL = 1e-6
#: 15 batches of 64 windows trained; 3 batches scored after them
N_PAYLOADS = 3 * 64


def _argv(mode, root, model="lstm1", servers="emulator:4000"):
    return [servers, TOPIC, "0", "model-predictions", mode, model, str(root)]


def _run(main, app, argv, **kw):
    """Run a CLI main; returns (rc, the broker it made)."""
    seen = []
    real = app._broker_for

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(app, "_broker_for", spy)
        rc = main(argv, **kw)
    return rc, seen[0] if seen else None


def _payloads(broker):
    end = broker.end_offset("model-predictions", 0)
    return [m.value.decode()
            for m in broker.fetch("model-predictions", 0, 0, end + 1)]


def _parse(payload):
    return np.array(payload.replace("[", " ").replace("]", " ").split(),
                    np.float64)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's train and predict."""
    root = tmp_path_factory.mktemp("jax_store")
    rc, train_broker = _run(j_lstm.main, j_app, _argv("train", root))
    assert rc == 0
    rc, predict_broker = _run(j_lstm.main, j_app, _argv("predict", root))
    assert rc == 0
    restore = tmp_path_factory.mktemp("jax_restore") / "ckpt"
    JArtifactStore(str(root)).download_tree("lstm1", str(restore))
    return {"train": train_broker, "predict": predict_broker,
            "payload": ocp.PyTreeCheckpointer().restore(str(restore))}


def _recompute(params, n_records=4000):
    """The predict slice's payloads from ``params``, computed here."""
    broker = t_app._broker_for(f"emulator:{n_records}", TOPIC)
    batches = SensorBatches(StreamConsumer(broker, [f"{TOPIC}:0:0"]),
                            batch_size=64, window=1, skip=15, take=3)
    module = LSTMSpec().build("cpu")
    module.load_state_dict(params)
    out = []
    with torch.no_grad():
        for b in batches:
            pred = module(torch.from_numpy(b.x)).numpy()
            out += [np.array2string(r) for r in pred[: b.n_valid]]
    return out


def test_train_then_predict(tmp_path, jax_cli, capsys):
    rc, train_broker = _run(lstm.main, t_app, _argv("train", tmp_path),
                            device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert "Training complete" in out and "stored successfully" in out
    stats = json.loads(out.split("stats: ")[1])
    assert stats["records"] == 15 * 64 and len(stats["loss"]) == 5
    assert all(np.isfinite(stats["loss"]))
    # the group cursor after train: the JAX CLI's, and the checkpoint's
    committed = train_broker.committed(GROUP, TOPIC, 0)
    assert committed == jax_cli["train"].committed(GROUP, TOPIC, 0)
    local = ArtifactStore(str(tmp_path)).download_tree(
        "lstm1", str(tmp_path / "restore"))
    ckpt = CheckpointManager.load_dir(local)
    assert ckpt["cursors"] == [(TOPIC, 0, committed)] == \
        [tuple(c) for c in jax_cli["payload"]["cursors"]]
    assert ckpt["step"] == ckpt["opt_state"].count == 75
    assert set(ckpt["params"]) == set(LSTMSpec().build("cpu").state_dict())

    rc, predict_broker = _run(lstm.main, t_app, _argv("predict", tmp_path),
                              device="cpu")
    assert rc == 0
    out = capsys.readouterr().out
    assert "predict complete" in out
    got = _payloads(predict_broker)
    assert len(got) == len(_payloads(jax_cli["predict"])) == N_PAYLOADS
    assert got == _recompute(ckpt["params"])  # index order, exactly
    assert predict_broker.committed(GROUP, TOPIC, 0) == \
        jax_cli["predict"].committed(GROUP, TOPIC, 0)


def test_predict_from_jax_trained_checkpoint_matches_jax(tmp_path, jax_cli):
    """The JAX CLI's trained checkpoint, converted to the port's format,
    predicts the JAX CLI's payloads."""
    p = jax_cli["payload"]
    adam = p["opt_state"][0]
    state = TrainState(
        step=int(p["step"]), params=lstm_params_from_jax(p["params"]),
        opt_state=lstm_adam_from_optax(adam["count"], adam["mu"],
                                       adam["nu"]))
    path = CheckpointManager(str(tmp_path / "ckpt")).save(
        state, cursors=p["cursors"])
    ArtifactStore(str(tmp_path / "store")).upload_tree(path, "lstm1")
    rc, broker = _run(lstm.main, t_app, _argv("predict", tmp_path / "store"),
                      device="cpu")
    assert rc == 0
    got, want = _payloads(broker), _payloads(jax_cli["predict"])
    assert len(got) == len(want) == N_PAYLOADS
    for g, w in zip(got, want):
        assert g.startswith("[[")
        np.testing.assert_allclose(_parse(g), _parse(w), rtol=0,
                                   atol=PAYLOAD_ATOL)


@pytest.mark.parametrize("argv", [
    [],
    ["too", "few"],
    ["e", "t", "0", "r", "bogus", "m", "a"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--train.epochs=abc"],
])
def test_usage_errors_return_1_like_jax(argv, capsys):
    assert lstm.main(argv, device="cpu") == 1
    got = capsys.readouterr().out
    assert j_lstm.main(argv) == 1
    want = capsys.readouterr().out
    assert got.splitlines()[-1].replace("iotml_torch.", "iotml.") == \
        want.splitlines()[-1]


def test_h5_model_file_returns_1_with_jax_message(tmp_path, capsys):
    argv = _argv("train", tmp_path / "store", model="lstm1.h5")
    assert lstm.main(argv, device="cpu") == 1
    got = capsys.readouterr().out
    assert j_lstm.main(argv) == 1
    want = capsys.readouterr().out
    assert got == want
    assert "autoencoder CLI only" in got
    assert not (tmp_path / "store").exists()


def test_lstm_cli_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lstm.main(_argv("train", tmp_path))


def test_jax_params_tree_is_what_the_converter_reads(jax_cli):
    tree = jax.tree.map(np.asarray, jax_cli["payload"]["params"])
    assert {f"OptimizedLSTMCell_{i}" for i in range(4)} | {"head"} == \
        set(tree)
