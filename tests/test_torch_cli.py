"""The port's cardata CLI, its config, checkpoint and artifact store, held
against the JAX package on the CPU at a small size (emulator:3000,
batch 10, 2 epochs).

Tolerances:
- return codes, committed offsets, checkpoint cursors, config values and
  the number and order of predictions: equal;
- a checkpoint round trip: exact (arrays bit for bit, counts equal);
- predict payloads of the two CLIs from the same (JAX-trained, converted)
  params: the printed values parsed as floats, atol 1e-6 — not as bytes,
  since ``np.array2string`` of two float32 forwards an ulp apart can
  differ in the last printed digit.
"""

import json
import os
import zipfile

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from iotml import config as j_config
from iotml.cli import _app as j_app
from iotml.cli import cardata as j_cardata
from iotml.models import autoencoder as j_ae
from iotml.train import loop as j_loop
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml_torch import config as t_config
from iotml_torch.cli import _app as t_app
from iotml_torch.cli import cardata
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.loop import TrainState

TOPIC, GROUP = "SENSOR_DATA_S_AVRO", "cardata-autoencoder"
SMALL = ["--train.epochs=2", "--train.batch_size=10"]
PAYLOAD_ATOL = 1e-6


def _argv(mode, root, servers="emulator:3000", model="m1"):
    return [servers, TOPIC, "0", "model-predictions", mode, model, str(root),
            *SMALL]


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
    msgs = broker.fetch("model-predictions", 0, 0, end + 1)
    return [m.value.decode() for m in msgs]


def _parse(payload):
    return np.array(payload.strip("[]").split(), np.float64)


@pytest.fixture(scope="module")
def jax_cli(tmp_path_factory):
    """The JAX CLI's train and predict at the small size."""
    root = tmp_path_factory.mktemp("jax_store")
    rc, train_broker = _run(j_cardata.main, j_app, _argv("train", root))
    assert rc == 0
    rc, predict_broker = _run(j_cardata.main, j_app, _argv("predict", root))
    assert rc == 0
    restore = tmp_path_factory.mktemp("jax_restore") / "ckpt"
    JArtifactStore(str(root)).download_tree("m1", str(restore))
    return {"train": train_broker, "predict": predict_broker,
            "payload": ocp.PyTreeCheckpointer().restore(str(restore))}


def test_train_predict_handoff_matches_jax(tmp_path, jax_cli, capsys):
    rc, train_broker = _run(cardata.main, t_app, _argv("train", tmp_path),
                            device="cpu")
    assert rc == 0
    train_stats = json.loads(capsys.readouterr().out.split("stats: ")[1])
    assert train_stats["records"] == 1000 and len(train_stats["loss"]) == 2
    # the group cursor after train: the JAX CLI's, and the checkpoint's
    assert train_broker.committed(GROUP, TOPIC, 0) == \
        jax_cli["train"].committed(GROUP, TOPIC, 0) == 1010
    local = ArtifactStore(str(tmp_path)).download_tree(
        "m1", str(tmp_path / "restore"))
    ckpt = CheckpointManager.load_dir(local)
    assert ckpt["cursors"] == [(TOPIC, 0, 1010)] == \
        [tuple(c) for c in jax_cli["payload"]["cursors"]]
    assert ckpt["step"] == ckpt["opt_state"].count == 200

    rc, predict_broker = _run(cardata.main, t_app,
                              _argv("predict", tmp_path), device="cpu")
    assert rc == 0
    got, want = _payloads(predict_broker), _payloads(jax_cli["predict"])
    assert len(got) == len(want) == 1000
    assert all(p.startswith("[") for p in got)
    assert predict_broker.committed(GROUP, TOPIC, 0) == \
        jax_cli["predict"].committed(GROUP, TOPIC, 0) == 2000


def test_predict_from_jax_trained_params_matches_jax(tmp_path, jax_cli):
    """The JAX CLI's trained checkpoint, converted to the port's format,
    predicts the JAX CLI's payloads."""
    p = jax_cli["payload"]
    adam = p["opt_state"][0]
    state = TrainState(step=int(p["step"]), params=params_from_jax(p["params"]),
                       opt_state=adam_from_optax(adam["count"], adam["mu"],
                                                 adam["nu"]))
    path = CheckpointManager(str(tmp_path / "ckpt")).save(
        state, cursors=p["cursors"])
    ArtifactStore(str(tmp_path / "store")).upload_tree(path, "m1")
    rc, broker = _run(cardata.main, t_app,
                      _argv("predict", tmp_path / "store"), device="cpu")
    assert rc == 0
    got, want = _payloads(broker), _payloads(jax_cli["predict"])
    assert len(got) == len(want) == 1000
    for g, w in zip(got, want):
        np.testing.assert_allclose(_parse(g), _parse(w), rtol=0,
                                   atol=PAYLOAD_ATOL)


@pytest.mark.parametrize("argv", [
    ["too", "few"],
    ["emulator", "t", "0", "r", "badmode", "m", "/x"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--train.epochs=abc"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--bogus.x=1"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--train.nope=1"],
    ["emulator", "t", "0", "r", "train", "m", "/x", "--train.epochs"],
])
def test_argument_errors_return_1_like_jax(argv):
    assert cardata.main(argv, device="cpu") == 1
    assert j_cardata.main(argv) == 1


@pytest.mark.parametrize("change,env,item", [
    ({7: "--stream.topic=x"}, {}, "A6"),        # the stream config section
    ({7: "--mesh.data=4"}, {}, "A10"),          # a device mesh
    ({}, {"IOTML_MESH_DATA": "2"}, "A10"),
    ({}, {"JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": "1"}, "A10"),
    ({}, {"IOTML_STREAM_TOPIC": "x"}, "A6"),
])
def test_unported_paths_raise_naming_roadmap(tmp_path, monkeypatch, change,
                                             env, item):
    argv = _argv("train", tmp_path / "store")
    for i, v in change.items():
        argv[i] = v
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        cardata.main(argv, device="cpu")
    # refused before anything was trained or stored
    assert not (tmp_path / "store").exists()


def test_cli_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cardata.main(_argv("train", tmp_path))


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("argv,env,file", [
    ([], {}, None),
    (["--train.epochs=3", "pos"], {}, None),
    (["--train.epochs", "4", "--train.learning_rate=0.01"], {}, None),
    ([], {"IOTML_TRAIN_BATCH_SIZE": "50", "IOTML_TRAIN_ONLY_NORMAL": "no"},
     None),
    (["--train.take_batches=7"], {"IOTML_TRAIN_TAKE_BATCHES": "9"},
     {"train": {"take_batches": 11, "epochs": 5}}),
    ([], {"IOTML_TRAIN_EPOCHS": "6", "IOTML_TEST_PLATFORM": "cpu"},
     {"train": {"epochs": 5}}),
])
def test_load_config_matches_jax(tmp_path, argv, env, file):
    path = None
    if file is not None:
        path = str(tmp_path / "cfg.json")
        with open(path, "w") as fh:
            json.dump(file, fh)
    t_cfg, t_rest = t_config.load_config(argv, env=env, path=path)
    j_cfg, j_rest = j_config.load_config(argv, env=env, path=path)
    assert t_rest == j_rest
    assert t_cfg.applied == j_cfg.applied
    for f in ("epochs", "batch_size", "take_batches", "learning_rate",
              "only_normal"):
        assert getattr(t_cfg.train, f) == getattr(j_cfg.train, f), f


@pytest.mark.parametrize("argv,env", [
    (["--train.epochs=x"], {}),
    (["--train.only_normal=maybe"], {}),
    (["--nosection.x=1"], {}),
    (["--train.epochs"], {}),
    ([], {"IOTML_NOPE_X": "1"}),
    ([], {"IOTML_TRAIN_NOPE": "1"}),
])
def test_load_config_errors_like_jax(argv, env):
    with pytest.raises(ValueError):
        t_config.load_config(argv, env=env)
    with pytest.raises(ValueError):
        j_config.load_config(argv, env=env)


# ------------------------------------------------------------ checkpoint
def _jax_trained_state():
    """A JAX TrainState after a few Adam steps, as the port's."""
    model = j_ae.DenseAutoencoder(input_dim=18)
    tx = optax.adam(1e-3)
    st = j_loop.TrainState.create(model, jax.random.PRNGKey(3),
                                  np.zeros((1, 18), np.float32), tx=tx)
    step = j_loop.make_train_step(model, tx)
    x = np.random.default_rng(0).uniform(-1, 1, (16, 18)).astype(np.float32)
    for _ in range(3):
        st, _ = step(st, x, x, np.ones((16,), np.float32))
    adam = st.opt_state[0]
    return TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def test_checkpoint_round_trips_a_jax_trained_state(tmp_path):
    state = _jax_trained_state()
    assert state.step == state.opt_state.count == 3
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore() is None and mgr.latest_step() is None
    mgr.save(state, cursors=[("T", 0, 42)])
    got = mgr.restore()
    assert (got["step"], got["opt_state"].count, got["cursors"]) == \
        (3, 3, [("T", 0, 42)])
    for tree, want in (("params", state.params),
                       ("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        have = got["params"] if tree == "params" \
            else getattr(got["opt_state"], tree)
        assert set(have) == set(PARAM_NAMES)
        for k in PARAM_NAMES:
            assert torch.equal(have[k], want[k]), (tree, k)


def test_checkpoint_skips_a_torn_newest_step(tmp_path):
    state = _jax_trained_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, cursors=[("T", 0, 1)], step=1)
    newest = mgr.save(state, cursors=[("T", 0, 2)], step=2)
    with open(os.path.join(newest, "arrays.npz"), "r+b") as fh:
        fh.truncate(100)  # a torn write
    os.makedirs(tmp_path / ".tmp_step_0000000003")  # a killed save
    assert mgr.steps() == [1, 2] and mgr.latest_step() == 2
    got = mgr.restore()
    assert got["cursors"] == [("T", 0, 1)] and mgr.skipped_torn == 1
    with pytest.raises((ValueError, OSError, zipfile.BadZipFile)):
        mgr.restore(step=2)  # the caller named it: no silent skip


# -------------------------------------------------------- artifact store
def test_artifact_store_publishes_atomically(tmp_path):
    store = ArtifactStore(str(tmp_path / "root"))
    src = tmp_path / "blob.bin"
    src.write_bytes(b"x" * 1000)
    store.upload(str(src), "sub/blob.bin")
    assert store.exists("sub/blob.bin") and not store.exists("nope")
    assert os.listdir(tmp_path / "root" / "sub") == ["blob.bin"]
    store.download("sub/blob.bin", str(tmp_path / "out" / "b"))
    assert (tmp_path / "out" / "b").read_bytes() == b"x" * 1000
    tree = tmp_path / "tree"
    (tree / "d").mkdir(parents=True)
    (tree / "a.txt").write_text("a")
    (tree / "d" / "b.txt").write_text("b")
    store.upload_tree(str(tree), "t1")
    assert store.exists("t1.zip")
    back = store.download_tree("t1", str(tmp_path / "back"))
    assert open(os.path.join(back, "d", "b.txt")).read() == "b"


# ------------------------------------------------ scorer offset commits
def test_scorer_commits_once_per_completed_drain():
    """A drain cut by max_rows commits nothing (the cursor runs ahead of
    the scored rows); the completed drain commits the cursor."""
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=20)).publish(broker, "T",
                                                       n_ticks=10)
    consumer = StreamConsumer(broker, ["T:0:0"], group="s")
    scorer = StreamScorer(CAR_AUTOENCODER,
                          CAR_AUTOENCODER.build("cpu").state_dict(),
                          SensorBatches(consumer, batch_size=10),
                          OutputSequence(broker, "P", partition=0),
                          device="cpu")
    scorer.max_super_batches = 2
    assert scorer.score_available(max_rows=20) == 20
    assert broker.committed("s", "T", 0) is None
    assert scorer.score_available() == 180
    assert broker.committed("s", "T", 0) == 200
    assert broker.end_offset("P", 0) == 200
