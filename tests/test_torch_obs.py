"""The port's metrics registry, watermarks, profiler captures and the
instrumented paths (``iotml_torch.obs``) held against the JAX package's
(``iotml.obs``) on the CPU.

Tolerances:
- ``render()`` of two identically filled registries: byte-identical;
  every family of ``iotml.obs.metrics`` (and tracing's, chaos's and the
  car detector's): the same name, help text, type and buckets;
  ``cardinality_violations``: the same list;
- counters and histogram counts after the same run, taken as deltas
  (the registries are process-global), and the final values of every
  gauge that moved on either side: equal, for ``fit_compiled``,
  three registry-mode ``ContinuousTrainer`` rounds, a scorer drain and
  an online window group.  Gauges are compared by value: equal, except
  ``live_train_loss`` and ``online_drift_stat`` (functions of the
  per-round and per-window losses: the fit bounds, rtol 2e-4 /
  atol 1e-6), ``online_learning_rate`` (float32 rates, equal as the
  learner's own test holds them) and ``reconstruction_mse`` (a mean of
  scorer errors: rtol 1e-5, the scorer's error bound).  Histogram sums
  are wall-clock times and are not compared;
- watermarks under one monkeypatched wall clock: the same gauges and
  histogram series;
- ``/metrics`` and ``/healthz`` over HTTP from a server on port 0,
  shut down by the test that starts it.
"""

import json
import os
import urllib.request

import jax
import numpy as np
import pytest

from iotml.chaos import faults as j_faults
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.obs import metrics as j_metrics
from iotml.obs import tracing as j_tracing
from iotml.obs import watermark as j_watermark
from iotml.online import learner as j_learner
from iotml.serve.carhealth import CarHealthDetector as JCarHealthDetector
from iotml.serve.scorer import StreamScorer as JStreamScorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train.live import ContinuousTrainer as JContinuousTrainer
from iotml.train.loop import Trainer as JTrainer
from iotml_torch.chaos import faults as t_faults
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.scenarios import AdversarialFleet, condition
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.mlops import ModelRegistry
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs import profile, watermark
from iotml_torch.obs import tracing as t_tracing
from iotml_torch.online.learner import OnlineLearner
from iotml_torch.serve.carhealth import CarHealthDetector
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.live import ContinuousTrainer
from iotml_torch.train.loop import Trainer, TrainState

TOPIC = "SENSOR_DATA_S_AVRO"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(autouse=True)
def _restore_globals():
    """Tracing off, chaos disarmed, watermarks on: for both packages,
    whatever a test did."""
    yield
    for tr in (t_tracing, j_tracing):
        tr.configure(enabled=False, sample=1.0)
        tr.reset()
        tr._PATH = None
    t_faults.disarm()
    j_faults.disarm()
    watermark.configure(enabled=True)
    j_watermark.configure(enabled=True)


# ------------------------------------------------------------- families
def _families(mod):
    kinds = (mod.Counter, mod.Gauge, mod.Histogram)
    return {k: v for k, v in vars(mod).items() if isinstance(v, kinds)}


def _describe(m):
    return (type(m).__name__, m.name, m.help, getattr(m, "buckets", None))


@pytest.mark.parametrize("pair", ["metrics", "tracing", "chaos"])
def test_families_equal_jax(pair):
    t_mod, j_mod = {"metrics": (t_metrics, j_metrics),
                    "tracing": (t_tracing, j_tracing),
                    "chaos": (t_faults, j_faults)}[pair]
    kinds = (j_metrics.Counter, j_metrics.Gauge, j_metrics.Histogram)
    want = {k: _describe(v) for k, v in vars(j_mod).items()
            if isinstance(v, kinds)}
    got = {k: _describe(v) for k, v in _families(t_metrics).items()} \
        if pair == "metrics" else \
        {k: _describe(v) for k, v in vars(t_mod).items()
         if isinstance(v, (t_metrics.Counter, t_metrics.Gauge,
                           t_metrics.Histogram))}
    assert want and got == want
    for _, name, _, _ in want.values():
        assert name in t_metrics.default_registry._metrics


def test_car_health_families_equal_jax():
    CarHealthDetector()
    JCarHealthDetector()
    for name in ("car_health_alerts_total", "car_health_alerts_active"):
        assert _describe(t_metrics.default_registry._metrics[name]) == \
            _describe(j_metrics.default_registry._metrics[name])


def test_closed_vocabulary_and_declarations_equal_jax():
    assert t_metrics.ALLOWED_LABEL_KEYS == j_metrics.ALLOWED_LABEL_KEYS
    assert t_metrics.MAX_LABEL_SERIES == j_metrics.MAX_LABEL_SERIES
    assert t_metrics.DECLARED_METRIC_LABELS == \
        j_metrics.DECLARED_METRIC_LABELS


def _fill(mod):
    reg = mod.Registry()
    c = reg.counter("x_total", "a counter")
    c.inc()
    c.inc(2.5, topic='we"ird\\name\nline', partition=3)
    reg.counter("untouched_total", "never incremented")
    g = reg.gauge("x_gauge", "a gauge")
    g.set(7, component="scorer")
    g.set(-1.25)
    h = reg.histogram("x_seconds", "a histogram", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.1, 0.5, 3.0, 11.0):
        h.observe(v)
        h.observe(v * 2, stage="decode")
    reg.histogram("empty_seconds", "no observations")
    with h.time(stage="timed"):
        pass
    return reg


def test_render_byte_identical_to_jax():
    t, j = _fill(t_metrics), _fill(j_metrics)
    # the timed observation's sum is a clock reading: zero it on both
    for reg in (t, j):
        h = reg._metrics["x_seconds"]
        key = (("stage", "timed"),)
        h._sums[key] = 0.0
        h._series[key] = [1, 0, 0, 0]
    assert t.render().encode() == j.render().encode()
    assert t.collect() == j.collect()


@pytest.mark.parametrize("max_series", [256, 2])
def test_cardinality_violations_equal_jax(max_series):
    regs = []
    for mod in (t_metrics, j_metrics):
        reg = mod.Registry()
        c = reg.counter("ok_total")
        for p in range(3):
            c.inc(topic="t", partition=p)
        reg.counter("bad_total").inc(car="car7", trace="00ff")
        reg.histogram("h_seconds").observe(0.1, stage="consume")
        regs.append(mod.cardinality_violations(reg, max_series=max_series))
    assert regs[0] == regs[1] and regs[0]


def test_default_registry_stays_inside_the_vocabulary():
    assert t_metrics.cardinality_violations() == []


# --------------------------------------------------------------- deltas
def _snapshot(mod):
    out = {}
    for name, m in list(mod.default_registry._metrics.items()):
        if isinstance(m, mod.Histogram):
            with m._lock:
                for key, n in m._ns.items():
                    out[("hist", name, key)] = n
        else:
            kind = "gauge" if isinstance(m, mod.Gauge) else "counter"
            with m._lock:
                for key, v in m._vals.items():
                    out[(kind, name, key)] = v
    return out


def _changes(mod, before):
    """Counter and histogram-count deltas, gauge values that moved, in
    one registry (for windows whose keys no other test sets)."""
    after = _snapshot(mod)
    out = {}
    for k, v in after.items():
        old = before.get(k)
        if old == v:
            continue
        kind, name, key = k
        out[(name, key)] = v if kind == "gauge" else v - (old or 0)
    return out


def _paired_changes(t_before, j_before):
    """The port's and JAX's changes since the two snapshots: counter and
    histogram-count deltas, and for every gauge key that moved in EITHER
    registry, its current value on each side.

    The registries are process-global, so a gauge an earlier test left at
    the value this window sets does not move on one side while it moves
    on the other; comparing final values makes the window independent of
    what ran before it in the process.  A gauge key that only one side
    holds stays on that side alone, and fails the comparison."""
    t_after, j_after = _snapshot(t_metrics), _snapshot(j_metrics)
    moved = {k for after, before in ((t_after, t_before), (j_after, j_before))
             for k, v in after.items()
             if k[0] == "gauge" and before.get(k) != v}

    def side(after, before):
        out = {}
        for k, v in after.items():
            kind, name, key = k
            if kind == "gauge":
                if k in moved:
                    out[(name, key)] = v
            elif before.get(k) != v:
                out[(name, key)] = v - (before.get(k) or 0)
        return out

    return side(t_after, t_before), side(j_after, j_before)


#: gauges that are functions of the losses or errors, and their bounds
_CLOSE = {"live_train_loss": LOSS_TOL, "iotml_online_drift_stat": LOSS_TOL,
          "iotml_reconstruction_mse": dict(rtol=1e-5, atol=0.0)}


def _assert_changes_equal(got, want):
    assert sorted(got) == sorted(want)
    for (name, key), v in want.items():
        tol = _CLOSE.get(name)
        if tol is None:
            assert got[(name, key)] == v, (name, key)
        else:
            np.testing.assert_allclose(got[(name, key)], v, err_msg=name,
                                       **tol)


def _seed(n_records, partitions=2, failure_rate=0.02):
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
    return jax.device_get(J_AE.init(jax.random.PRNGKey(seed),
                                    np.zeros((1, 18), np.float32))["params"])


def _carry(jtrainer, ttrainer):
    jtrainer._ensure_state(np.zeros((100, 18), np.float32))
    st = jtrainer.state
    adam = st.opt_state[0]
    ttrainer.state = TrainState(
        step=int(st.step),
        params=params_from_jax(jax.tree.map(np.asarray, st.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def test_fit_compiled_counters_equal_jax():
    tb, jb = _seed(3000)
    specs = [f"{TOPIC}:{p}:0" for p in range(2)]
    tt = Trainer(CAR_AUTOENCODER, device="cpu")
    jt = JTrainer(J_AE)
    _carry(jt, tt)
    tbat = SensorBatches(StreamConsumer(tb, specs, group="fit"),
                         batch_size=100, take=20, only_normal=True)
    jbat = JSensorBatches(JStreamConsumer(jb, specs, group="fit"),
                          batch_size=100, take=20, only_normal=True)
    t0, j0 = _snapshot(t_metrics), _snapshot(j_metrics)
    th = tt.fit_compiled(tbat, epochs=3)
    jh = jt.fit_compiled(jbat, epochs=3)
    np.testing.assert_allclose(th["loss"], jh["loss"], **LOSS_TOL)
    got, want = _paired_changes(t0, j0)
    _assert_changes_equal(got, want)
    assert got[("iotml_records_trained_total", ())] == 6000
    assert got[("iotml_step_seconds",
                (("loop", "train"), ("phase", "device_compute")))] == 1


def _registry_rounds(tmp_path, prime=lambda: None):
    tb, jb = _seed(4000)
    kw = dict(take_batches=10, group="obs-live", checkpoint_interval_s=0.0)
    tt = ContinuousTrainer(tb, TOPIC, None, device="cpu",
                           registry=ModelRegistry(str(tmp_path / "t")), **kw)
    jt = JContinuousTrainer(jb, TOPIC, None,
                            registry=JModelRegistry(str(tmp_path / "j")),
                            **kw)
    _carry(jt.trainer, tt.trainer)
    prime()
    t0, j0 = _snapshot(t_metrics), _snapshot(j_metrics)
    for tr in (tt, jt):
        for _ in range(3):
            assert tr.train_round()
            tr.checkpointer.write_once()
    got, want = _paired_changes(t0, j0)
    _assert_changes_equal(got, want)
    assert got[("live_train_rounds_total", ())] == 3
    assert got[("iotml_registry_publishes_total", ())] == 3
    version = ("gauge", "iotml_model_version", (("component", "trainer"),))
    assert _snapshot(t_metrics)[version] == _snapshot(j_metrics)[version] \
        == 3


def test_registry_rounds_counters_equal_jax(tmp_path):
    _registry_rounds(tmp_path)


def test_scorer_drain_counters_equal_jax():
    tb, jb = _seed(2500, failure_rate=0.05)
    specs = [f"{TOPIC}:{p}:0" for p in range(2)]
    jp = _j_params()
    for b in (tb, jb):
        b.create_topic("preds")
    t = StreamScorer(CAR_AUTOENCODER, params_from_jax(jp),
                     SensorBatches(StreamConsumer(tb, specs, group="q"),
                                   batch_size=100, keep_labels=True),
                     OutputSequence(tb, "preds", partition=0),
                     threshold=5.0, device="cpu")
    j = JStreamScorer(J_AE, jp,
                      JSensorBatches(JStreamConsumer(jb, specs, group="q"),
                                     batch_size=100, keep_labels=True),
                      JOutputSequence(jb, "preds", partition=0),
                      threshold=5.0)
    t0, j0 = _snapshot(t_metrics), _snapshot(j_metrics)
    assert t.score_available() == j.score_available() == 2500
    t.set_params(params_from_jax(jp), version=4)
    j.set_params(jp, version=4)
    got, want = _paired_changes(t0, j0)
    _assert_changes_equal(got, want)
    assert got[("iotml_records_scored_total", ())] == 2500


def _online_window_group(prime=lambda: None):
    jb, tb = JBroker(), Broker()
    from iotml.gen.scenarios import AdversarialFleet as JAdversarialFleet
    from iotml.gen.scenarios import condition as j_condition
    from iotml.gen.simulator import FleetScenario as JFleetScenario

    JAdversarialFleet(JFleetScenario(num_cars=25, failure_rate=0.0, seed=7),
                      j_condition("baseline")).publish_stream(
        jb, "T", n_ticks=24)
    AdversarialFleet(FleetScenario(num_cars=25, failure_rate=0.0, seed=7),
                     condition("baseline")).publish_stream(tb, "T", n_ticks=24)
    jl = j_learner.OnlineLearner(jb, "T", window=50, publish_every=10**9,
                                 fuse=8)
    tl = OnlineLearner(tb, "T", window=50, publish_every=10**9, fuse=8,
                       device="cpu")
    jl.trainer._ensure_state(np.zeros((50, 18), np.float32))
    tl.trainer._ensure_state()
    tl.trainer.state = TrainState(
        step=0, params=params_from_jax(
            jax.tree.map(np.asarray, jl.trainer.state.params)),
        opt_state=tl.trainer.state.opt_state)
    prime()
    t0, j0 = _snapshot(t_metrics), _snapshot(j_metrics)
    assert tl.process_available() == jl.process_available() == 12
    got, want = _paired_changes(t0, j0)
    _assert_changes_equal(got, want)
    assert got[("iotml_online_updates_total", ())] == 12


def test_online_window_group_counters_equal_jax():
    _online_window_group()


def _prime_jax_gauges():
    """What an earlier test in the same worker may leave behind: JAX's
    gauges already at the values the windows set (the trainer's model
    version after three published rounds, the drift statistic after a
    window group without drift)."""
    j_metrics.model_version.set(3, component="trainer")
    j_metrics.online_drift_stat.set(0.0)


@pytest.mark.parametrize("window", ["registry_rounds", "online_window"])
def test_windows_equal_jax_after_jax_gauges_were_primed(tmp_path, window):
    """JAX's gauges do not move in the window (they already hold their
    final values) while the port's do: the comparison still holds,
    because it reads the final values of every gauge that moved on
    either side."""
    if window == "registry_rounds":
        _registry_rounds(tmp_path, prime=_prime_jax_gauges)
    else:
        _online_window_group(prime=_prime_jax_gauges)


# ----------------------------------------------------------- watermarks
def test_watermarks_equal_jax_under_one_clock(monkeypatch):
    import time

    monkeypatch.setattr(time, "time", lambda: 1_700_000_100.0)
    regs = []
    for mod, wm in ((t_metrics, watermark), (j_metrics, j_watermark)):
        before = _snapshot(mod)
        wm.observe("consume", "obs-wm", 0, 1_700_000_000_000,
                   1_700_000_050_000, group="g")
        wm.observe("consume", "obs-wm", 0, -1, -1, group="g")  # a no-op
        wm.observe("score", "obs-wm", 1, 1_700_000_099_000,
                   1_700_000_099_000)
        wm.observe_taken("train", {("obs-wm", 0): (1_700_000_000_000,
                                                   1_700_000_010_000)},
                         group="g")
        # monotone: an older batch never moves the watermark back
        wm.observe("consume", "obs-wm", 0, 0, 5, group="g")
        regs.append(_changes(mod, before))
    assert regs[0] == regs[1]
    key = (("group", "g"), ("partition", 0), ("stage", "consume"),
           ("topic", "obs-wm"))
    assert regs[0][("iotml_watermark_event_time_ms", key)] == \
        1_700_000_050_000
    with pytest.raises(ValueError, match="closed set"):
        watermark.observe("decode", "t", 0, 0, 1)


def test_watermark_env_toggle_equals_jax():
    for wm in (watermark, j_watermark):
        wm.configure_from_env({"IOTML_WATERMARK": "0"})
        assert wm.ENABLED is False
        wm.configure_from_env({"IOTML_WATERMARK": "on"})
        assert wm.ENABLED is True


def test_consumer_watermark_take_and_lag_equal_jax():
    tb, jb = _seed(1000)
    specs = [f"{TOPIC}:{p}:0" for p in range(2)]
    out = []
    for mod, cons in ((t_metrics, StreamConsumer(tb, specs, group="wm")),
                      (j_metrics, JStreamConsumer(jb, specs, group="wm"))):
        before = _snapshot(mod)
        n = len(cons.poll(300))
        taken = cons.take_event_time()
        cons.commit()
        assert cons.take_event_time() == {}
        out.append((n, taken, {k: v for k, v in _changes(mod, before).items()
                               if k[0] != "iotml_watermark_lag_seconds"}))
    assert out[0] == out[1]


def test_consumer_with_watermarks_off_publishes_as_jax():
    """``IOTML_WATERMARK=0``: neither package publishes a watermark
    family and the other counters move alike; the port also skips the
    per-poll event-time bounds, so it has nothing to take (JAX folds
    them and hands them to a no-op)."""
    tb, jb = _seed(1000)
    specs = [f"{TOPIC}:{p}:0" for p in range(2)]
    out, taken = [], []
    for mod, wm, cons in (
            (t_metrics, watermark, StreamConsumer(tb, specs, group="off")),
            (j_metrics, j_watermark, JStreamConsumer(jb, specs,
                                                     group="off"))):
        wm.configure(enabled=False)
        before = _snapshot(mod)
        n = len(cons.poll(300))
        taken.append(cons.take_event_time())
        cons.commit()
        out.append((n, _changes(mod, before)))
    assert out[0] == out[1]
    assert not any(k[0].startswith("iotml_watermark") for k in out[0][1])
    assert taken[0] == {} and taken[1]
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_metrics_and_healthz_over_http():
    tb, _ = _seed(500)
    cons = StreamConsumer(tb, [f"{TOPIC}:0:0"], group="http")
    cons.poll(100)
    cons.commit()
    t_metrics.model_version.set(3, component="http-test")
    srv = t_metrics.start_http_server(0)
    try:
        port = srv.server_address[1]
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        text = body.decode()
        assert "# TYPE iotml_records_consumed_total counter" in text
        assert 'iotml_watermark_event_time_ms{group="http"' in text
        status, ctype, body = _get(port, "/healthz")
        doc = json.loads(body)
        assert status == 200 and ctype == "application/json"
        assert doc["status"] == "ok" and doc["tracing"] is False
        assert doc["model"]["http-test"]["version"] == 3
        assert any(k.startswith(f"consume:{TOPIC}:0:http")
                   for k in doc["watermarks"])
        assert f"http:{TOPIC}:0" in doc["consumer_lag_records"]
        with pytest.raises(urllib.error.HTTPError):
            _get(port, "/nope")
        from iotml_torch.obs import federate

        assert {"name": t_tracing.proc_name(),
                "address": f"127.0.0.1:{port}"} in federate.local_endpoints()
    finally:
        srv.shutdown()
        srv.server_close()
        with t_metrics.model_version._lock:
            t_metrics.model_version._vals.pop(
                (("component", "http-test"),), None)


def test_a_port_that_cannot_be_bound_raises():
    srv = t_metrics.start_http_server(0)
    try:
        with pytest.raises(OSError):
            t_metrics.start_http_server(srv.server_address[1])
    finally:
        srv.shutdown()
        srv.server_close()


# ------------------------------------------------------------- profiler
def test_profile_trace_writes_a_file_on_the_cpu(tmp_path):
    import torch

    with profile.trace(str(tmp_path)) as cap:
        with profile.annotate("obs-test-matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert cap.path and os.path.getsize(cap.path) > 0
    assert profile.trace_files(str(tmp_path)) == [cap.path]
    doc = json.load(open(cap.path))
    assert any(e.get("name") == "obs-test-matmul"
               for e in doc["traceEvents"])
    s = cap.summary()
    assert s["device_ops"] == 0 and s["busy_share"] == 0.0
    assert s["window_ms"] > 0


def test_maybe_trace_takes_its_logdir(tmp_path, monkeypatch):
    """A directory captures; None or "" is a no-op, as JAX's, whatever
    the environment holds."""
    monkeypatch.setenv("IOTML_PROFILE", str(tmp_path / "env"))
    for off in (None, ""):
        with profile.maybe_trace(off) as cap:
            assert cap is None
    with profile.maybe_trace(str(tmp_path / "p")) as cap:
        pass
    assert cap is not None and profile.trace_files(str(tmp_path / "p"))
    assert not (tmp_path / "env").exists()


def test_device_summary_takes_the_union_of_overlapping_intervals(tmp_path):
    path = str(tmp_path / "t.pt.trace.json")
    ev = [{"ph": "X", "cat": "kernel", "name": "a", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 50, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 400,
           "dur": 100},
          {"ph": "X", "cat": "cpu_op", "name": "host", "ts": 0,
           "dur": 900}]
    json.dump({"traceEvents": ev}, open(path, "w"))
    s = profile.device_summary(path, window_s=0.001, top=2)
    assert s["device_ms"] == pytest.approx(0.25)
    assert s["device_sum_ms"] == pytest.approx(0.3)
    assert s["busy_share"] == pytest.approx(0.25)
    assert [t["name"] for t in s["top"]] == ["a", "b"]
    assert profile.union_us([]) == 0.0
