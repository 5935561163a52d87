"""The port's long-lived scorer CLI (``iotml_torch.cli.serve``), its
``serve`` config section, ``StreamScorer.run_forever`` and ``ExpBackoff``,
held against the JAX package on the CPU at a small size (emulator
streams of 3,000 records).

Both CLIs serve from the same params: a JAX state after three Adam
steps, stored as JAX's orbax checkpoint for ``iotml.cli.serve`` and,
converted with ``params_from_jax``, as the port's npz + JSON checkpoint.
Each package's ``_broker_for`` is patched to hand back one broker of
its own per test, fed identically, so a second call resumes on the same
log (the JAX suite does this with a wire server over a backing broker).

Tolerances:
- return codes, committed offsets, counts and order of predictions,
  rewinds, config values and backoff delays: equal;
- payloads: the printed values parsed as floats, atol 1e-6; the
  reconstruction error after the verdict (printed to 6 decimals) at
  most one last digit apart; the verdicts equal wherever the error is
  more than 1e-4 from the threshold (float32 forwards an ulp apart may
  print a last digit apart).
"""

import functools
import json
import random
import subprocess
import sys
import time

import jax
import numpy as np
import optax
import pytest
import torch

from iotml import config as j_config
from iotml.cli import _app as j_app
from iotml.cli import serve as j_serve
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.models.autoencoder import CAR_AUTOENCODER as J_CAR_AUTOENCODER
from iotml.serve import scorer as j_scorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train import loop as j_loop
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml.train.checkpoint import CheckpointManager as JCheckpointManager
from iotml.utils.backoff import ExpBackoff as JExpBackoff
from iotml_torch import config as t_config
from iotml_torch.cli import _app as t_app
from iotml_torch.cli import serve as t_serve
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.serve import scorer as t_scorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.loop import TrainState
from iotml_torch.utils.backoff import ExpBackoff

TOPIC, GROUP = "SENSOR_DATA_S_AVRO", "iotml-serve"
PAYLOAD_ATOL = 1e-6
VERDICT_MARGIN = 1e-4
#: a threshold inside the three-step model's error range, so both
#: verdicts occur, and the notebook's 5
THRESHOLDS = (0.2, 5.0)
PACKAGES = {
    "torch": dict(Broker=Broker, gen=FleetGenerator, scen=FleetScenario,
                  app=t_app),
    "jax": dict(Broker=JBroker, gen=JFleetGenerator, scen=JFleetScenario,
                app=j_app),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """(JAX artifact root, port artifact root, JAX params) holding the
    same model as ``m1``."""
    tx = optax.adam(1e-3)
    st = j_loop.TrainState.create(J_CAR_AUTOENCODER, jax.random.PRNGKey(3),
                                  np.zeros((1, 18), np.float32), tx=tx)
    step = j_loop.make_train_step(J_CAR_AUTOENCODER, tx)
    x = np.random.default_rng(0).uniform(-1, 1, (64, 18)).astype(np.float32)
    for _ in range(3):
        st, _ = step(st, x, x, np.ones((64,), np.float32))
    j_root = str(tmp_path_factory.mktemp("jax_store"))
    t_root = str(tmp_path_factory.mktemp("torch_store"))
    ck = tmp_path_factory.mktemp("ck")
    JArtifactStore(j_root).upload_tree(
        JCheckpointManager(str(ck / "jax")).save(st, cursors=[]), "m1")
    adam = st.opt_state[0]
    state = TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))
    ArtifactStore(t_root).upload_tree(
        CheckpointManager(str(ck / "torch")).save(state, cursors=[]), "m1")
    return {"jax": j_root, "torch": t_root,
            "params": jax.tree.map(np.asarray, st.params)}


def _brokers(monkeypatch, ticks=30, partitions=1):
    """One fleet-fed broker per package, handed out by its _broker_for."""
    out = {}
    for which, pkg in PACKAGES.items():
        b = pkg["Broker"]()
        pkg["gen"](pkg["scen"](num_cars=100, failure_rate=0.01)).publish(
            b, TOPIC, n_ticks=ticks, partitions=partitions)
        b.create_topic("model-predictions")
        monkeypatch.setattr(pkg["app"], "_broker_for",
                            lambda *a, b=b: b)
        out[which] = b
    return out


def _publish_more(brokers, ticks, partitions=1):
    for which, pkg in PACKAGES.items():
        pkg["gen"](pkg["scen"](num_cars=100, failure_rate=0.01)).publish(
            brokers[which], TOPIC, n_ticks=ticks, partitions=partitions)


def _serve(which, argv, max_rounds):
    if which == "torch":
        return t_serve.main(list(argv), max_rounds=max_rounds, device="cpu")
    return j_serve.main(list(argv), max_rounds=max_rounds)


def _argv(root, offset, threshold):
    return ["emulator:3000", TOPIC, offset, "model-predictions", "m1", root,
            "--serve.poll_interval_s=0", f"--serve.threshold={threshold}"]


def _payloads(broker, start=0):
    end = broker.end_offset("model-predictions", 0)
    return [m.value.decode()
            for m in broker.fetch("model-predictions", 0, start, end + 1)]


def _assert_payloads_match(got, want, threshold):
    assert len(got) == len(want) > 0
    verdicts = set()
    for g, w in zip(got, want):
        g_row, g_verdict, g_err = g.split("|")
        w_row, w_verdict, w_err = w.split("|")
        np.testing.assert_allclose(
            np.array(g_row.strip("[]").split(), np.float64),
            np.array(w_row.strip("[]").split(), np.float64),
            rtol=0, atol=PAYLOAD_ATOL)
        # printed to 6 decimals: at most one last digit apart
        assert abs(round(float(g_err) * 1e6) - round(float(w_err) * 1e6)) \
            <= 1
        if abs(float(w_err) - threshold) > VERDICT_MARGIN:
            assert g_verdict == w_verdict
        verdicts.add(g_verdict)
    assert verdicts <= {"normal", "anomaly"}
    return verdicts


# ------------------------------------------------------------- the CLI
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_committed_serve_then_resume_matches_jax(stores, monkeypatch,
                                                 threshold, capsys):
    brokers = _brokers(monkeypatch)
    for which in PACKAGES:
        assert _serve(which, _argv(stores[which], "committed", threshold),
                      3) == 0
    stats = json.loads(capsys.readouterr().out.split("stats: ")[1]
                       .splitlines()[0])
    assert (stats["rows"], stats["rounds"], stats["rewinds"]) == \
        (3000, 3, 0)
    assert stats["decode_rows"] == 3000
    got, want = _payloads(brokers["torch"]), _payloads(brokers["jax"])
    assert len(got) == 3000
    verdicts = _assert_payloads_match(got, want, threshold)
    if threshold == THRESHOLDS[0]:
        assert verdicts == {"normal", "anomaly"}
    for b in brokers.values():
        assert b.committed(GROUP, TOPIC, 0) == 3000

    # 500 more records: committed offsets mean only they are scored
    _publish_more(brokers, ticks=5)
    for which in PACKAGES:
        assert _serve(which, _argv(stores[which], "committed", threshold),
                      2) == 0
    got = _payloads(brokers["torch"], 3000)
    assert len(got) == 500
    _assert_payloads_match(got, _payloads(brokers["jax"], 3000), threshold)
    for b in brokers.values():
        assert b.committed(GROUP, TOPIC, 0) == b.end_offset(TOPIC, 0) == 3500


def test_absolute_offset_serve_matches_jax(stores, monkeypatch):
    brokers = _brokers(monkeypatch, ticks=10)
    for which in PACKAGES:
        assert _serve(which, _argv(stores[which], "250", 0.2), 2) == 0
    got = _payloads(brokers["torch"])
    assert len(got) == 750
    _assert_payloads_match(got, _payloads(brokers["jax"]), 0.2)
    for b in brokers.values():
        assert b.committed(GROUP, TOPIC, 0) == 1000


def test_group_serve_with_one_member_scores_everything(stores, monkeypatch):
    brokers = _brokers(monkeypatch, ticks=20, partitions=4)
    for which in PACKAGES:
        assert _serve(which, _argv(stores[which], "group", 0.2), 3) == 0
    got = _payloads(brokers["torch"])
    assert len(got) == 2000
    _assert_payloads_match(got, _payloads(brokers["jax"]), 0.2)
    for b in brokers.values():
        for p in range(4):
            assert b.committed(GROUP, TOPIC, p) == b.end_offset(TOPIC, p)


@pytest.mark.parametrize("argv", [
    ["too", "few"],
    ["a", "b", "c", "d", "e", "f", "g"],
    ["emulator", "t", "0", "r", "m", "/x", "--serve.threshold=abc"],
    ["emulator", "t", "0", "r", "m", "/x", "--serve.poll_interval_s"],
    ["emulator", "t", "0", "r", "m", "/x", "--serve.nope=1"],
    ["emulator", "t", "0", "r", "m", "/x", "--bogus.x=1"],
])
def test_argument_and_config_errors_return_1_like_jax(argv, capsys):
    assert t_serve.main(argv, device="cpu") == 1
    t_out = capsys.readouterr().out
    assert j_serve.main(argv) == 1
    j_out = capsys.readouterr().out
    assert ("usage" in t_out) == ("usage" in j_out)
    assert ("config error" in t_out) == ("config error" in j_out)


def test_module_entry_prints_usage_and_returns_1():
    run = subprocess.run([sys.executable, "-m", "iotml_torch.cli.serve",
                          "too", "few"], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 1
    assert "usage: python -m iotml_torch.cli.serve" in run.stdout


def test_unported_servers_and_sections_raise_naming_roadmap(tmp_path):
    # host:port is ported: with nothing listening both packages raise the
    # same connection error
    argv = ["127.0.0.1:1", TOPIC, "committed", "model-predictions", "m1",
            str(tmp_path)]
    with pytest.raises(OSError) as t_err:
        t_serve.main(argv, device="cpu")
    with pytest.raises(OSError) as j_err:
        j_serve.main(argv)
    assert type(t_err.value) is type(j_err.value) is ConnectionRefusedError
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        t_serve.main(["emulator", *argv[1:], "--stream.topic=x"],
                     device="cpu")


def test_serve_needs_a_card_unless_told(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(t_app, "_broker_for", lambda *a: built.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.main(["emulator:100", TOPIC, "0", "model-predictions", "m1",
                      str(tmp_path)])
    assert built == []  # raised before anything was built


# ---------------------------------------------------------------- config
@pytest.mark.parametrize("argv,env,file", [
    ([], {}, None),
    (["--serve.threshold=5", "pos"], {}, None),
    (["--serve.poll_interval_s", "0.01", "--serve.take_batches=3"], {}, None),
    ([], {"IOTML_SERVE_SKIP_BATCHES": "7",
          "IOTML_SERVE_CHECKPOINT_EVERY_BATCHES": "9"}, None),
    (["--serve.threshold=2.5"], {"IOTML_SERVE_THRESHOLD": "4"},
     {"serve": {"threshold": 3, "poll_interval_s": 0.25}}),
    ([], {"IOTML_SERVE_POLL_INTERVAL_S": "0", "IOTML_TRAIN_BATCH_SIZE": "50"},
     {"serve": {"skip_batches": 1}, "train": {"epochs": 2}}),
])
def test_serve_config_matches_jax(tmp_path, argv, env, file):
    path = None
    if file is not None:
        path = str(tmp_path / "cfg.json")
        with open(path, "w") as fh:
            json.dump(file, fh)
    t_cfg, t_rest = t_config.load_config(argv, env=env, path=path)
    j_cfg, j_rest = j_config.load_config(argv, env=env, path=path)
    assert t_rest == j_rest
    assert t_cfg.applied == j_cfg.applied
    for f in ("skip_batches", "take_batches", "poll_interval_s",
              "checkpoint_every_batches", "threshold"):
        got, want = getattr(t_cfg.serve, f), getattr(j_cfg.serve, f)
        assert got == want and type(got) is type(want), f
    assert t_cfg.train.batch_size == j_cfg.train.batch_size


@pytest.mark.parametrize("argv,env", [
    (["--serve.threshold=x"], {}),
    (["--serve.skip_batches=1.5"], {}),
    ([], {"IOTML_SERVE_NOPE": "1"}),
    ([], {"IOTML_SERVE_POLL_INTERVAL_S": "soon"}),
])
def test_serve_config_errors_like_jax(argv, env):
    with pytest.raises(ValueError):
        t_config.load_config(argv, env=env)
    with pytest.raises(ValueError):
        j_config.load_config(argv, env=env)


# ------------------------------------------------------------ run_forever
def _failing(base, fail_on):
    class FailingBroker(base):
        """Raises ConnectionError on the listed fetch calls (1-based)."""

        calls = 0

        def fetch(self, *a, **kw):
            type(self).calls += 1
            if type(self).calls in fail_on:
                raise ConnectionError(f"fetch {type(self).calls} lost")
            return super().fetch(*a, **kw)

    return FailingBroker


@pytest.mark.parametrize("fail_on,poll_s", [
    ((2,), 0.0), ((3, 4, 5), 0.05), ((1, 6, 7), 0.3)])
def test_run_forever_rewinds_and_backs_off_like_jax(stores, monkeypatch,
                                                    fail_on, poll_s):
    """A fetch that raises ConnectionError rewinds the consumer to the
    committed offsets and sleeps the backoff; rows already written are
    written again at new indices.  Same rewinds, sleeps and payloads by
    index as JAX's run_forever."""
    sleeps = []
    monkeypatch.setattr(time, "sleep", sleeps.append)
    runs = {}
    for which in PACKAGES:
        pkg = PACKAGES[which]
        b = _failing(pkg["Broker"], fail_on)()
        pkg["gen"](pkg["scen"](num_cars=100, failure_rate=0.01)).publish(
            b, TOPIC, n_ticks=10)
        if which == "torch":
            monkeypatch.setattr(t_scorer, "ExpBackoff", functools.partial(
                ExpBackoff, rng=random.Random(11)))
            consumer = StreamConsumer(b, [f"{TOPIC}:0:0"], group="g",
                                      eof=False)
            scorer = t_scorer.StreamScorer(
                CAR_AUTOENCODER, params_from_jax(stores["params"]),
                SensorBatches(consumer, batch_size=100),
                OutputSequence(b, "P", partition=0), threshold=0.2,
                device="cpu")
        else:
            monkeypatch.setattr(j_scorer, "ExpBackoff", functools.partial(
                JExpBackoff, rng=random.Random(11)))
            consumer = JStreamConsumer(b, [f"{TOPIC}:0:0"], group="g",
                                       eof=False)
            scorer = j_scorer.StreamScorer(
                J_CAR_AUTOENCODER, stores["params"],
                JSensorBatches(consumer, batch_size=100),
                JOutputSequence(b, "P", partition=0), threshold=0.2)
        scorer.max_super_batches = 2
        rewinds = []
        real = consumer.rewind_to_committed
        consumer.rewind_to_committed = lambda: (rewinds.append(1), real())
        # poll chunks of 250 records: a drain spans several fetches
        if which == "torch":
            monkeypatch.setattr("iotml_torch.data.dataset.POLL_CHUNK", 250)
        else:
            scorer.batches.poll_chunk = 250
        del sleeps[:]
        scorer.run_forever(poll_interval_s=poll_s, max_rounds=6)
        runs[which] = dict(rewinds=len(rewinds), sleeps=list(sleeps),
                           scored=scorer.scored, payloads=_payloads_of(b),
                           committed=b.committed("g", TOPIC, 0))
        if which == "torch":
            assert scorer.rewinds == len(rewinds) and scorer.rounds == 6
    t, j = runs["torch"], runs["jax"]
    assert t["rewinds"] == j["rewinds"] == len(fail_on)
    assert t["sleeps"] == j["sleeps"]
    assert (t["scored"], t["committed"]) == (j["scored"], j["committed"])
    assert t["committed"] == 1000 and t["scored"] >= 1000
    _assert_payloads_match(t["payloads"], j["payloads"], 0.2)


def _payloads_of(b):
    end = b.end_offset("P", 0)
    return [m.value.decode() for m in b.fetch("P", 0, 0, end + 1)]


def test_set_params_stamps_the_version():
    s = t_scorer.StreamScorer(
        CAR_AUTOENCODER, CAR_AUTOENCODER.build("cpu").state_dict(),
        SensorBatches(StreamConsumer(Broker(), ["T:0:0"])),
        OutputSequence(), device="cpu")
    assert s.model_version is None and s.first_forward_s is None
    s.set_params(CAR_AUTOENCODER.build("cpu").state_dict(), version=4)
    assert s.model_version == 4
    s.set_params(CAR_AUTOENCODER.build("cpu").state_dict())
    assert s.model_version == 4


# ---------------------------------------------------------------- backoff
@pytest.mark.parametrize("kw", [
    {}, {"base_s": 0.01}, {"base_s": 0.3, "cap_s": 2.0},
    {"base_s": 0.5, "cap_s": 0.5, "factor": 3.0},
    {"base_s": 0.05, "cap_s": 1.0, "factor": 1.5}])
def test_backoff_matches_jax(kw):
    t = ExpBackoff(**kw, rng=random.Random(5))
    j = JExpBackoff(**kw, rng=random.Random(5))
    for n in (9, 3):
        got = [t.next_delay() for _ in range(n)]
        assert got == [j.next_delay() for _ in range(n)]
        assert t.attempt == j.attempt == n
        cap = kw.get("cap_s", 2.0)
        assert all(0 < d <= cap for d in got)
        t.reset()
        j.reset()
        assert t.attempt == 0


@pytest.mark.parametrize("kw", [
    {"base_s": 0}, {"base_s": -1}, {"base_s": 1.0, "cap_s": 0.5},
    {"factor": 1.0}, {"factor": 0.5}])
def test_backoff_bounds_raise_like_jax(kw):
    with pytest.raises(ValueError, match="need 0 < base_s"):
        ExpBackoff(**kw)
    with pytest.raises(ValueError, match="need 0 < base_s"):
        JExpBackoff(**kw)
