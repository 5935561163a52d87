"""The port's continuous services (``iotml_torch.train.live``
``ContinuousTrainer``, ``iotml_torch.serve.live`` ``LiveScorer``) held
against the JAX package's on the CPU: the scenarios of
``tests/test_live.py``, each run in both packages on the same records
and the same (converted) starting params.

Tolerances:
- per-round losses at the fused-fit bounds (tests/test_fused_train.py):
  rtol 2e-4 / atol 1e-6;
- each round's published params against the JAX package's h5 blob, read
  by its own ``h5_import``: rtol 5e-3 / atol 2e-5;
- records trained, committed cursors, pointers' round numbers, scored
  counts, quality counts and stats keys: equal;
- payloads of the two scorers from the same params: values parsed as
  floats within atol 1e-6, the error suffix within 1.5e-6 (one printed
  digit), verdicts equal more than 1e-4 from the threshold; car-health
  records equal apart from the wall-clock ``t``, their EMAs rtol 1e-5;
- the port's rounds over the in-memory broker, the pure wire client and
  the native client: stacked batches, losses and cursors equal.
"""

import json
import os
import tempfile

import jax
import numpy as np
import pytest

from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.models.h5_export import autoencoder_params_to_h5
from iotml.models.h5_import import autoencoder_params_from_h5
from iotml.serve.live import LiveScorer as JLiveScorer
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.artifacts import ArtifactStore as JArtifactStore
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.serve.live import LiveScorer
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.stream.native_kafka import NativeKafkaBroker
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import TrainState

TOPIC = "SENSOR_DATA_S_AVRO"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


def _seed(n_records, failure_rate=0.02, partitions=2):
    """A port and a JAX broker holding the same generated records."""
    t, j = Broker(), JBroker()
    FleetGenerator(FleetScenario(num_cars=100, failure_rate=failure_rate)) \
        .publish(t, TOPIC, n_ticks=n_records // 100, partitions=partitions)
    j.create_topic(TOPIC, partitions=partitions)
    for p in range(partitions):
        for m in t.fetch(TOPIC, p, 0, t.end_offset(TOPIC, p)):
            j.produce(TOPIC, m.value, key=m.key, partition=p,
                      timestamp_ms=m.timestamp_ms)
    return t, j


def _j_params(seed=0):
    return J_AE.init(jax.random.PRNGKey(seed),
                     np.zeros((1, 18), np.float32))["params"]


def _carry(jtrainer, ttrainer):
    """Start the port's trainer from the JAX trainer's initial state."""
    jtrainer._ensure_state(np.zeros((100, 18), np.float32))
    st = jtrainer.state
    adam = st.opt_state[0]
    ttrainer.state = TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def _trainers(t_broker, j_broker, root, **kw):
    tt = ContinuousTrainer(t_broker, TOPIC, ArtifactStore(str(root / "t")),
                           device="cpu", **kw)
    jt = JContinuousTrainer(j_broker, TOPIC, JArtifactStore(str(root / "j")),
                            **kw)
    _carry(jt.trainer, tt.trainer)
    return tt, jt


def _published(tt, jt, k):
    """Round k's params: both packages' h5 blobs, each read by the JAX
    package's importer, converted."""
    with tempfile.TemporaryDirectory() as tmp:
        got, want = (params_from_jax(autoencoder_params_from_h5(
            tr.store.download(f"cardata-live.h5.r{k}",
                              os.path.join(tmp, f"{i}.h5"))))
            for i, tr in enumerate((tt, jt)))
    return got, want


def _committed(broker, group, parts=2):
    return [broker.committed(group, TOPIC, p) for p in range(parts)]


# ----------------------------------------------------------------- trainer
def test_rounds_pointer_and_resume_match_jax(tmp_path):
    tb, jb = _seed(3000)
    tt, jt = _trainers(tb, jb, tmp_path, take_batches=10, group="t-live")
    assert tt.available() == jt.available() == 3000
    assert tt.min_available == jt.min_available == 1101
    t_stats, j_stats = [], []
    assert tt.run(max_rounds=2, on_round=t_stats.append) == 2
    assert jt.run(max_rounds=2, on_round=j_stats.append) == 2
    assert [set(s) for s in t_stats] == [set(s) for s in j_stats]
    np.testing.assert_allclose([s["loss"] for s in t_stats],
                               [s["loss"] for s in j_stats], **LOSS_TOL)
    for key in ("round", "records", "records_cum"):
        assert [s[key] for s in t_stats] == [s[key] for s in j_stats]
    assert [s["artifact"] for s in t_stats] == \
        ["cardata-live.h5.r1", "cardata-live.h5.r2"]
    assert (tt.rounds, tt.records_trained) == (jt.rounds, jt.records_trained) \
        == (2, 2000)
    for k in (1, 2):
        got, want = _published(tt, jt, k)
        for name in PARAM_NAMES:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       err_msg=f"r{k} {name}", **PARAM_TOL)
    assert tt.store.get_text("cardata-live.h5.latest") == \
        "cardata-live.h5.r2"
    # the commit trails the publish: a new trainer resumes past the slice
    assert _committed(tb, "t-live") == _committed(jb, "t-live")
    assert tt.consumer.positions() == jt.consumer.positions()
    tt2 = ContinuousTrainer(tb, TOPIC, tt.store, take_batches=10,
                            group="t-live", device="cpu")
    jt2 = JContinuousTrainer(jb, TOPIC, jt.store, take_batches=10,
                             group="t-live")
    assert tt2.available() == jt2.available() == tt.available() > 0


def test_trainer_waits_for_min_available(tmp_path):
    tb, jb = _seed(500)  # below 10 x 100 x 1.1
    tt, jt = _trainers(tb, jb, tmp_path, take_batches=10, group="t-wait")
    assert tt.run(stop=lambda: True) == jt.run(stop=lambda: True) == 0
    assert tt.rounds == jt.rounds == 0
    assert tt.store.get_text("cardata-live.h5.latest") is None
    assert jt.store.get_text("cardata-live.h5.latest") is None


def test_rounds_equal_over_three_transports(tmp_path):
    """The port's rounds over the in-memory broker, the pure wire client
    and the native client stack the same batches and train the same."""
    tb, _ = _seed(2400)
    runs = {}
    with KafkaWireServer(tb) as srv:
        addr = f"127.0.0.1:{srv.port}"
        for name, make in (("inproc", lambda: _copy(tb)),
                           ("wire", lambda: KafkaWireBroker(addr)),
                           ("native", lambda: NativeKafkaBroker(addr))):
            broker = make()
            tr = ContinuousTrainer(broker, TOPIC,
                                   ArtifactStore(str(tmp_path / name)),
                                   take_batches=10, group=f"g-{name}",
                                   device="cpu")
            stacked = []
            real = tr.trainer.fit_compiled

            def spy(batches, epochs=1, real=real, stacked=stacked):
                bs = list(next(batches.epochs(1)))
                stacked.append(np.stack([b.x for b in bs]))
                return real(bs, epochs)

            tr.trainer.fit_compiled = spy
            losses = []
            tr.run(max_rounds=2, on_round=lambda s: losses.append(s["loss"]))
            runs[name] = (stacked, losses, tr.consumer.positions(),
                          tr.trainer.state.params)
            if name != "inproc":
                broker.close()
    want = runs["inproc"]
    assert len(want[0]) == 2
    for name, got in runs.items():
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
        assert got[1] == want[1] and got[2] == want[2], name
        for k in PARAM_NAMES:
            assert np.array_equal(got[3][k].numpy(), want[3][k].numpy())


def _copy(broker):
    """A second in-process broker with the same records."""
    out = Broker()
    parts = broker.topic(TOPIC).partitions
    out.create_topic(TOPIC, partitions=parts)
    for p in range(parts):
        for m in broker.fetch(TOPIC, p, 0, broker.end_offset(TOPIC, p)):
            out.produce(TOPIC, m.value, key=m.key, partition=p,
                        timestamp_ms=m.timestamp_ms)
    return out


# ------------------------------------------------------------ scoring
def _parse(msg: bytes):
    parts = msg.decode().split("|")
    return np.array(parts[0].strip("[]").split(), np.float64), parts[1:]


def _assert_payloads_match(t_msgs, j_msgs, threshold):
    assert len(t_msgs) == len(j_msgs) > 0
    for tm, jm in zip(t_msgs, j_msgs):
        tv, tt = _parse(tm)
        jv, jt = _parse(jm)
        assert tv.shape == jv.shape == (18,)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)
        if threshold is None:
            assert tt == jt == []
            continue
        assert abs(float(tt[1]) - float(jt[1])) <= 1.5e-6
        if abs(float(jt[1]) - threshold) > 1e-4:
            assert tt[0] == jt[0]


def _scorers(tb, jb, threshold, parts, **kw):
    jp = _j_params()
    tb.create_topic("preds")
    jb.create_topic("preds")
    specs = [f"{TOPIC}:{p}:0" for p in range(parts)]
    t = StreamScorer(CAR_AUTOENCODER, params_from_jax(jp),
                     SensorBatches(StreamConsumer(tb, specs, group="q"),
                                   batch_size=100, keep_labels=True),
                     OutputSequence(tb, "preds", partition=0),
                     threshold=threshold, device="cpu", **kw)
    j = JStreamScorer(J_AE, jp,
                      JSensorBatches(JStreamConsumer(jb, specs, group="q"),
                                     batch_size=100, keep_labels=True),
                      JOutputSequence(jb, "preds", partition=0),
                      threshold=threshold, **kw)
    return t, j


def _preds(broker):
    return [m.value for m in broker.fetch("preds", 0, 0, 1 << 20)]


@pytest.mark.parametrize("threshold", [-1.0, 1e9])
def test_scorer_quality_confusion_counts_match_jax(threshold):
    tb, jb = _seed(2000, failure_rate=0.05)
    n_true = sum(1 for p in range(2) for m in tb.fetch(TOPIC, p, 0, 10_000)
                 if b"true" in m.value[-12:])
    t, j = _scorers(tb, jb, threshold, 2)
    assert t.score_available() == j.score_available() == 2000
    assert t.quality == j.quality
    if threshold < 0:
        assert t.quality == {"tp": n_true, "fp": 2000 - n_true, "fn": 0,
                             "tn": 0}
    else:
        assert t.quality == {"tp": 0, "fp": 0, "fn": n_true,
                             "tn": 2000 - n_true}
    _assert_payloads_match(_preds(tb), _preds(jb), threshold)


def test_set_params_mid_drain_no_drop_no_reorder():
    """A swap between super-batches of one drain: one prediction a row,
    in order, the rows after it from the new weights; JAX's alike."""
    tb, jb = _seed(2000, failure_rate=0.0, partitions=1)
    jp = _j_params()
    jp_b = jax.tree.map(np.zeros_like, jp)  # output == bias == 0

    class TSwap(StreamScorer):
        max_super_batches = 4
        swapped = False

        def _score_super_batch(self, bs, base):
            super()._score_super_batch(bs, base)
            if self.scored >= 800 and not self.swapped:
                self.swapped = True
                self.set_params(params_from_jax(jp_b))

    class JSwap(JStreamScorer):
        max_super_batches = 4

        def _score_super_batch(self, bs, base):
            super()._score_super_batch(bs, base)
            if self.scored >= 800 and self.params is jp:
                self.set_params(jp_b)

    for br in (tb, jb):
        br.create_topic("preds")
    t = TSwap(CAR_AUTOENCODER, params_from_jax(jp),
              SensorBatches(StreamConsumer(tb, [f"{TOPIC}:0:0"]),
                            batch_size=100),
              OutputSequence(tb, "preds", partition=0), device="cpu")
    j = JSwap(J_AE, jp, JSensorBatches(JStreamConsumer(jb, [f"{TOPIC}:0:0"]),
                                       batch_size=100),
              JOutputSequence(jb, "preds", partition=0))
    assert t.score_available() == j.score_available() == 2000
    msgs = _preds(tb)
    assert len(msgs) == 2000
    zeros = [m.startswith(b"[0. 0. 0. 0.") for m in msgs]
    assert not zeros[0] and zeros[-1]
    assert sum(zeros[i] != zeros[i - 1] for i in range(1, 2000)) == 1
    assert zeros.index(True) == 800
    _assert_payloads_match(msgs, _preds(jb), None)


def test_bounded_drain_resumes_without_loss():
    tb, jb = _seed(5000, failure_rate=0.0, partitions=3)
    t, j = _scorers(tb, jb, None, 3)
    totals = {}
    for name, sc, br in (("t", t, tb), ("j", j, jb)):
        sc.max_super_batches = 4
        total = calls = 0
        while True:
            got = sc.score_available(max_rows=700)
            if not got:
                break
            total, calls = total + got, calls + 1
            if sc._resume is not None:
                assert br.committed("q", TOPIC, 0) is None
        totals[name] = (total, calls, _committed(br, "q", 3))
    assert totals["t"] == totals["j"]
    assert totals["t"][0] == 5000 and totals["t"][1] > 1
    assert sum(totals["t"][2]) == 5000
    _assert_payloads_match(_preds(tb), _preds(jb), None)


def test_live_scorer_hotswap_from_store(tmp_path):
    tb, jb = _seed(3000, failure_rate=0.05)
    tb.create_topic("model-predictions")
    jb.create_topic("model-predictions")
    tt, jt = _trainers(tb, jb, tmp_path, take_batches=10, group="t-hs")
    ts = LiveScorer(tb, TOPIC, "model-predictions", tt.store, threshold=5.0,
                    group="s-hs", device="cpu")
    js = JLiveScorer(jb, TOPIC, "model-predictions", jt.store,
                     threshold=5.0, group="s-hs")
    for sc in (ts, js):
        with pytest.raises(TimeoutError):
            sc.wait_for_model(timeout_s=0.2)  # nothing published yet
    tt.run(max_rounds=1)
    jt.run(max_rounds=1)
    assert ts.wait_for_model() == js.wait_for_model() == "cardata-live.h5.r1"
    assert ts.model_updates == js.model_updates == 1
    assert ts.scorer.score_available() == js.scorer.score_available() == 3000
    assert ts.scorer.quality == js.scorer.quality
    assert sum(ts.scorer.quality.values()) == 3000
    tt.run(max_rounds=1)
    jt.run(max_rounds=1)
    assert ts.maybe_swap() and js.maybe_swap()
    assert ts.model_updates == js.model_updates == 2
    assert ts._current_artifact == "cardata-live.h5.r2"
    assert not ts.maybe_swap() and not js.maybe_swap()
    t_stats, j_stats = ts.stats(), js.stats()
    assert set(t_stats) == set(j_stats)
    for key in ("scored", "quality", "err_hist", "model_updates",
                "positions", "drain_complete"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["carhealth"]["cars_seen"] == 100


def _same_model(tt_store, jt_store, jp):
    """Round 1 of both stores holds the same params: the JAX package's h5,
    which the port reads too."""
    with tempfile.TemporaryDirectory() as tmp:
        h5 = os.path.join(tmp, "m.h5")
        autoencoder_params_to_h5(jax.tree.map(np.asarray, jp), h5)
        for store in (tt_store, jt_store):
            store.upload(h5, "cardata-live.h5.r1")
            store.put_text("cardata-live.h5.latest", "cardata-live.h5.r1")


def test_plain_model_name_rounds_store_the_port_checkpoint(tmp_path):
    """A name without ``.h5`` keeps the port's checkpoint (npz + JSON)
    for each round, which ``cli.serve`` serves too; the scorer follows it
    the same."""
    tb, _ = _seed(2400)
    tt = ContinuousTrainer(tb, TOPIC, ArtifactStore(str(tmp_path)),
                           model_name="cardata-live", take_batches=10,
                           group="plain", device="cpu")
    assert tt.run(max_rounds=1) == 1
    assert tt.store.get_text("cardata-live.latest") == "cardata-live.r1"
    ckpt = CheckpointManager.load_dir(tt.store.download_tree(
        "cardata-live.r1", str(tmp_path / "restore")))
    assert ckpt["step"] == ckpt["opt_state"].count == 10
    assert ckpt["cursors"] == tt.consumer.positions()
    for k in PARAM_NAMES:
        assert ckpt["params"][k].numpy().tobytes() == \
            tt.trainer.state.params[k].numpy().tobytes()
    ts = LiveScorer(tb, TOPIC, "model-predictions", tt.store,
                    model_name="cardata-live", carhealth_topic=None,
                    device="cpu")
    assert ts.wait_for_model(5.0) == "cardata-live.r1"
    assert ts.scorer.score_available() == 2400


@pytest.mark.parametrize("full", [False, True])
def test_live_scorers_match_jax_with_car_health(tmp_path, full):
    """Both LiveScorers from the same params: payloads, quality and the
    car-health records (feature heads on under full normalization)."""
    from iotml.core.normalize import FULL_NORMALIZER as J_FULL
    from iotml_torch.core.normalize import FULL_NORMALIZER as T_FULL

    tb, jb = _seed(4000, failure_rate=0.1)
    for br in (tb, jb):
        br.create_topic("model-predictions")
    stores = ArtifactStore(str(tmp_path / "t")), \
        JArtifactStore(str(tmp_path / "j"))
    _same_model(*stores, _j_params(1))
    kw = dict(threshold=0.3, group="s", car_threshold=0.3,
              car_feature_heads=full)
    ts = LiveScorer(tb, TOPIC, "model-predictions", stores[0], device="cpu",
                    normalizer=T_FULL if full else None, **kw)
    js = JLiveScorer(jb, TOPIC, "model-predictions", stores[1],
                     normalizer=J_FULL if full else None, **kw)
    if full:
        assert ts.scorer.verdict_mask.sum() == js.scorer.verdict_mask.sum()
    t_drains, j_drains = [], []
    assert ts.run(max_drains=1, on_drain=t_drains.append) == \
        js.run(max_drains=1, on_drain=j_drains.append) == 4000
    assert len(t_drains) == len(j_drains) >= 1
    assert ts.scorer.quality == js.scorer.quality
    _assert_payloads_match(
        [m.value for m in tb.fetch("model-predictions", 0, 0, 1 << 20)],
        [m.value for m in jb.fetch("model-predictions", 0, 0, 1 << 20)],
        0.3)
    recs = []
    for br in (tb, jb):
        out = []
        for m in br.fetch("car-health", 0, 0, 1 << 20):
            rec = json.loads(m.value)
            rec.pop("t")
            out.append((m.key, rec.pop("ema"), rec))
        recs.append(out)
    assert len(recs[0]) == len(recs[1]) > 0
    for (tk, te, tr), (jk, je, jr) in zip(*recs):
        assert (tk, tr) == (jk, jr)
        np.testing.assert_allclose(te, je, rtol=1e-5)
    assert ts.stats()["carhealth"] == js.stats()["carhealth"]
