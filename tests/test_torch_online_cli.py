"""The port's online learner, drill and CLI (``iotml_torch.online``) held
against the JAX package's on the CPU: both learners warm-started from
one registry version written by JAX, the scenarios of
``tests/test_online.py`` for the learner, the drift-adapt-swap drill at
its defaults from the same initial weights, and ``python -m
iotml_torch.online list|drill|run``.

Tolerances:
- per-window pre-update losses and manifest losses: rtol 2e-4 /
  atol 1e-6 (the fused-vs-scanned bounds of tests/test_fused_train.py);
- adaptations (update index, signal, action), the learning rate after
  every window (float32 values), manifests' offsets and metric keys,
  committed offsets, record counts and versions: equal;
- the drill: every invariant's name and outcome, the detection delay,
  published and scored counts, adaptations, versions and hot-swaps
  equal; the histogram AUCs within 0.01.
"""

import contextlib
import io
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from iotml.gen.scenarios import AdversarialFleet as JAdversarialFleet
from iotml.gen.scenarios import condition as j_condition
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.mlops.checkpoint import params_to_h5_bytes as j_to_h5
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.online import learner as j_learner
from iotml.online.__main__ import main as j_main
from iotml.online.drill import drill_drift_adapt_swap as j_drill
from iotml.stream.broker import Broker as JBroker
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.scenarios import AdversarialFleet, condition
from iotml_torch.gen.simulator import FleetScenario
from iotml_torch.mlops import ModelRegistry, RegistryWatcher
from iotml_torch.models.autoencoder import AutoencoderSpec, CAR_AUTOENCODER
from iotml_torch.models.convert import params_from_jax
from iotml_torch.online import drill as t_drill
from iotml_torch.online.__main__ import main
from iotml_torch.online.learner import AdaptationPolicy, OnlineLearner
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireServer
from iotml_torch.stream.producer import OutputSequence

SEED = 7
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)


def _fleet(pkg, name="baseline", cars=25, **kw):
    if pkg == "jax":
        return JAdversarialFleet(
            JFleetScenario(num_cars=cars, failure_rate=0.0, seed=SEED),
            j_condition(name, **kw))
    return AdversarialFleet(
        FleetScenario(num_cars=cars, failure_rate=0.0, seed=SEED),
        condition(name, **kw))


def _learner(broker, topic, **kw):
    kw.setdefault("window", 50)
    kw.setdefault("publish_every", 10**9)
    return OnlineLearner(broker, topic, device="cpu", **kw)


def _record(learner):
    """Log (pre-update loss, rate after the window) of every window."""
    log = []
    real = learner._after_update

    def after(loss):
        real(loss)
        log.append((loss, learner.current_lr))

    learner._after_update = after
    return log


def _j_params(seed=0):
    return jax.device_get(J_AE.init(jax.random.PRNGKey(seed),
                                    np.zeros((1, 18), np.float32))["params"])


# ------------------------------------------------ the learner against JAX
@pytest.mark.parametrize("action", ["auto", "refit"])
def test_learner_matches_jax_from_one_jax_registry(tmp_path, action):
    """Both learners warm-start from the v1 JAX wrote (weights, no
    Adam state) over the same regional-drift stream of
    tests/test_online.py:344, publishing every 20 windows."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    JModelRegistry(jroot).publish({"model.h5": j_to_h5(_j_params())})
    shutil.copytree(jroot, troot)
    jb, tb = JBroker(), Broker()
    jf = _fleet("jax", "regional-drift", drift_tick=80)
    tf = _fleet("torch", "regional-drift", drift_tick=80)
    jl = j_learner.OnlineLearner(
        jb, "T", registry=JModelRegistry(jroot), window=50,
        publish_every=20, policy=j_learner.AdaptationPolicy(action=action))
    tl = _learner(tb, "T", registry=ModelRegistry(troot), publish_every=20,
                  policy=AdaptationPolicy(action=action))
    assert tl.restored_version == jl.restored_version == 1
    jlog, tlog = _record(jl), _record(tl)
    for ticks in (80, 120):
        jf.publish_stream(jb, "T", n_ticks=ticks)
        tf.publish_stream(tb, "T", n_ticks=ticks)
        jl.process_available()
        tl.process_available()
    assert tl.write_published() == jl.write_published()
    assert len(tlog) == len(jlog) == tl.updates == jl.updates
    np.testing.assert_allclose([l for l, _ in tlog], [l for l, _ in jlog],
                               **LOSS_TOL)
    assert [lr for _, lr in tlog] == [lr for _, lr in jlog]
    assert tl.adaptations == jl.adaptations and tl.adaptations
    assert tl.adaptations[0][2] == ("refit" if action == "refit"
                                    else "boost")
    assert tl.refits == sum(a[2] == "refit" for a in jl.adaptations)
    assert tl.records_trained == jl.records_trained
    assert tl.monitor.drifts == jl.monitor.drifts
    treg, jreg = ModelRegistry(troot), JModelRegistry(jroot)
    assert treg.versions() == jreg.versions() and len(treg.versions()) > 2
    for v in treg.versions()[1:]:
        tm, jm = treg.manifest(v), jreg.manifest(v)
        assert tm.offsets == jm.offsets
        assert sorted(tm.metrics) == sorted(jm.metrics)
        assert tm.step == jm.step
        for key in ("records", "drifts", "online"):
            assert tm.metrics[key] == jm.metrics[key]
        np.testing.assert_allclose(tm.metrics["loss"], jm.metrics["loss"],
                                   **LOSS_TOL)
    assert tb.committed(tl.group, "T", 0) == jb.committed(jl.group, "T", 0)
    newest = {p: off for _t, p, off in treg.manifest(treg.latest()).offsets}
    assert tl.checkpointer.offsets_lag == tb.end_offset("T", 0) - newest[0]


# ---------------------------- the scenarios of tests/test_online.py:306-441
def test_learner_lr_boost_is_runtime_mutable():
    b = Broker()
    fleet = _fleet("torch")
    fleet.publish_stream(b, "T", n_ticks=4)
    lrn = _learner(b, "T")
    assert lrn.process_available() > 0
    assert lrn.current_lr == pytest.approx(1e-3)
    lrn.set_lr(5e-3)
    assert lrn.current_lr == pytest.approx(5e-3)
    fleet.publish_stream(b, "T", n_ticks=2)
    assert lrn.process_available() > 0  # the same step, boosted
    assert np.isfinite(lrn.last_loss)
    assert lrn.updates == 3 and lrn.seconds["device_compute"] > 0


def test_learner_bounded_drains_lose_no_rows():
    b, jb = Broker(), JBroker()
    n = _fleet("torch").publish_stream(b, "T", n_ticks=13)
    assert _fleet("jax").publish_stream(jb, "T", n_ticks=13) == n == 325
    lrn = _learner(b, "T", only_normal=False)
    jlrn = j_learner.OnlineLearner(jb, "T", window=50, only_normal=False,
                                   publish_every=10**9)
    total = 0
    while True:
        got = lrn.process_available(max_updates=2)
        assert got == jlrn.process_available(max_updates=2)
        if not got:
            break
        total += got
        for _t, _p, off in lrn.consumer.positions():
            assert off <= lrn.records_trained + lrn.window
        assert lrn.consumer.positions() == jlrn.consumer.positions()
    assert lrn.records_trained == n == jlrn.records_trained
    assert total == lrn.updates == 7


def test_learner_detects_and_adapts_on_regional_drift():
    b = Broker()
    fleet = _fleet("torch", "regional-drift", drift_tick=80)
    lrn = _learner(b, "T")
    fleet.publish_stream(b, "T", n_ticks=80)
    lrn.process_available()
    assert lrn.monitor.drifts == 0  # stationary phase: no false fire
    fleet.publish_stream(b, "T", n_ticks=120)
    lrn.process_available()
    assert lrn.monitor.drifts >= 1
    assert lrn.adaptations and lrn.adaptations[0][2] in ("boost", "refit")
    assert lrn.adaptations[0][0] - 80 <= 20  # within 1000 records
    assert lrn.monitor.converged >= 1  # healed by stream end


def test_learner_publishes_through_registry_commit_trails_manifest(tmp_path):
    b = Broker()
    reg = ModelRegistry(str(tmp_path))
    lrn = _learner(b, "T", registry=reg, publish_every=4,
                   group="online-test")
    _fleet("torch").publish_stream(b, "T", n_ticks=20)
    lrn.process_available()
    versions = lrn.write_published()
    assert versions, "publish cadence produced no versions"
    m = reg.manifest(reg.latest())
    assert m.metrics.get("online") == 1.0
    committed = b.committed("online-test", "T", 0)
    stamped = {p: off for _t, p, off in m.offsets}[0]
    assert committed == stamped  # group commit trails manifest exactly
    assert lrn.checkpointer.offsets_lag == b.end_offset("T", 0) - stamped
    # a second incarnation resumes model + cursor as one unit
    lrn2 = _learner(b, "T", registry=reg, group="online-test")
    assert lrn2.restored_version == reg.latest()
    assert lrn2.consumer.positions()[0][2] == stamped
    # with its Adam state (the 23-leaf state.npz)
    assert lrn2.trainer.state.step == m.step == 8
    assert lrn2.trainer.state.opt_state.inner.count == 8
    assert lrn2.current_lr == lrn.current_lr
    with pytest.raises(ValueError, match="commit hook"):
        _learner(b, "T", checkpointer=lrn.checkpointer)


def test_drift_adapt_swap_e2e(tmp_path):
    """Drift → detect → adapt → publish → the watcher hot-swaps the
    scorer → nothing lost or doubled."""
    b = Broker()
    fleet = _fleet("torch", "regional-drift", drift_tick=80)
    reg = ModelRegistry(str(tmp_path))
    lrn = _learner(b, "T", registry=reg, publish_every=20)
    consumer = StreamConsumer(b, ["T:0:0"], group="swap-scorer")
    scorer = StreamScorer(CAR_AUTOENCODER, None,
                          SensorBatches(consumer, batch_size=50),
                          OutputSequence(b, "preds", partition=0),
                          device="cpu")
    watcher = RegistryWatcher(reg, scorers=[scorer])
    published = 0
    for phase_ticks in (80, 120):
        published += fleet.publish_stream(b, "T", n_ticks=phase_ticks)
        while lrn.process_available(max_updates=10):
            lrn.write_published()
            watcher.poll_once()
            if watcher.current_version is not None:
                scorer.score_available(max_rows=1000)
        scorer.score_available()
    assert lrn.monitor.drifts >= 1 and lrn.adaptations
    latest = reg.latest()
    assert latest is not None and watcher.swaps >= 1
    assert scorer.model_version == latest
    assert scorer.scored == published
    assert b.end_offset("preds", 0) == published


def test_learner_refuses_the_mesh_and_needs_a_card_unless_told(monkeypatch):
    """A mesh with a device, device_normalize or chip_monitors without a
    mesh, and a monitor count off the data axis refuse as JAX's learner
    does (ValueError); no card and no device raises."""
    from iotml.online.detectors import DriftMonitor as JDriftMonitor
    from iotml.online.learner import OnlineLearner as JOnlineLearner
    from iotml.parallel.mesh import make_mesh as j_make_mesh
    from iotml_torch.online.detectors import DriftMonitor
    from iotml_torch.parallel.mesh import make_mesh

    mesh = make_mesh((2,), ("data",), devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="mesh or device"):
        _learner(Broker(), "T", mesh=mesh)  # the helper passes device
    j_mesh = j_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    for t_kw, j_kw, match in (
            ({"device_normalize": True, "device": "cpu"},
             {"device_normalize": True}, "needs a mesh"),
            ({"chip_monitors": [DriftMonitor()], "device": "cpu"},
             {"chip_monitors": [JDriftMonitor()]}, "need a mesh"),
            ({"mesh": mesh, "chip_monitors": [DriftMonitor()] * 3},
             {"mesh": j_mesh, "chip_monitors": [JDriftMonitor()] * 3},
             "3 chip monitors for a 2-device mesh")):
        with pytest.raises(ValueError, match=match):
            OnlineLearner(Broker(), "T", **t_kw)
        with pytest.raises(ValueError, match=match):
            JOnlineLearner(JBroker(), "T", **j_kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OnlineLearner(Broker(), "T")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["drill"])


# ------------------------------------------------------- the drill itself
def _jax_init(monkeypatch):
    """Build every port autoencoder from the JAX package's PRNGKey(0)
    init, which the JAX drill's pre-training starts from."""
    params = params_from_jax(_j_params())
    build = AutoencoderSpec.build

    def from_jax(self, device=None, generator=None):
        model = build(self, device, generator)
        model.load_state_dict(params)
        return model

    monkeypatch.setattr(AutoencoderSpec, "build", from_jax)


def _capture_learners(monkeypatch, owner, cls):
    made = []

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(owner, "OnlineLearner", Recording)
    return made


def test_drill_at_its_defaults_reproduces_jax(monkeypatch):
    """Seed 7, 12,000 records, window 50: the same verdicts as the JAX
    package's drill — including its FAIL on adaptation_converged (the
    episode is still adapting when the stream ends)."""
    _jax_init(monkeypatch)
    jl = _capture_learners(monkeypatch, j_learner, j_learner.OnlineLearner)
    tl = _capture_learners(monkeypatch, t_drill, OnlineLearner)
    want = j_drill(seed=7)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["drill", "--seed", "7", "--json"], device="cpu")
    got = json.loads(out.getvalue())
    assert rc == (0 if got["ok"] else 1) == (0 if want.ok else 1) == 1
    inv = {i["name"]: i for i in got["invariants"]}
    assert [(i["name"], i["ok"]) for i in got["invariants"]] == \
        [(i.name, i.ok) for i in want.invariants]
    assert inv["adaptation_converged"]["ok"] is False
    for i in want.invariants:
        if i.name != "auc_recovered":
            assert inv[i.name]["detail"] == i.detail
    for key in ("published", "scored", "records", "seed"):
        assert got[key] == getattr(want, key)
    assert got["slos"]["detect_records"] == want.slos["detect_records"] == 250
    for key in ("auc_pre", "auc_during", "auc_post"):
        assert abs(got["slos"][key] - want.slos[key]) <= 0.01
    (t,), (j,) = tl, jl
    assert [tuple(a) for a in t.adaptations] == [tuple(a) for a in
                                                 j.adaptations]
    assert t.published_versions == j.published_versions
    assert t.monitor.describe()["state"] == "adapting"


# ------------------------------------------------------------------ CLI
def test_list_prints_what_jax_prints(capsys):
    assert main(["list"]) == 0
    got = capsys.readouterr().out
    assert j_main(["list"]) == 0
    assert got == capsys.readouterr().out
    assert main([]) == 2


def test_run_trains_publishes_and_commits_behind_the_manifest(tmp_path):
    broker = Broker()
    _fleet("torch", "regional-drift", drift_tick=30).publish_stream(
        broker, "SENSOR_DATA_S_AVRO", n_ticks=60)
    out = io.StringIO()
    with KafkaWireServer(broker) as srv, contextlib.redirect_stdout(out):
        rc = main(["run", "--servers", f"127.0.0.1:{srv.port}",
                   "--registry", str(tmp_path), "--window", "50",
                   "--max-seconds", "1.5"], device="cpu")
    assert rc == 0
    lines = [json.loads(s) for s in out.getvalue().splitlines()]
    final = lines[-1]
    assert final["updates"] == 30 and final["records_trained"] == 1500
    assert [d["updates"] for d in lines[:-1]] == sorted(
        d["updates"] for d in lines[:-1])
    assert set(lines[0]) == {"updates", "loss", "lr", "drifts", "state"}
    reg = ModelRegistry(str(tmp_path))
    m = reg.manifest(reg.latest())
    assert m.metrics["online"] == 1.0 and m.metrics["records"] == 1500.0
    stamped = {p: off for _t, p, off in m.offsets}
    assert stamped == {0: 1500}
    assert broker.committed("cardata-online", "SENSOR_DATA_S_AVRO", 0) \
        <= stamped[0]
