"""The port's online-learning pieces (``iotml_torch.online.detectors``,
``gen.scenarios``, the injectable-rate Adam, the window groups, the
23-leaf ``state.npz`` and the learner's split refit) held against the
JAX package's on the CPU, on the same seeded inputs.

Tolerances:
- detectors: exactly equal return values, statistics, states and
  ``describe()`` at every step (both are plain Python ``math`` in the
  same order);
- scenarios: ``step_columns`` exactly equal (values and dtypes) and
  ``publish_stream`` byte-identical (keys, framed values, timestamps,
  partitions); ``publish_mqtt`` deliveries, counts and ``describe()``
  equal, with link flaps and under backpressure;
- the injectable Adam: params atol 1e-6 after each of ten steps (the
  Adam bounds), hyperparameters and counts equal;
- window groups and the refit: per-window losses rtol 2e-4 / atol 1e-6,
  params rtol 5e-3 / atol 2e-5 (the fused-vs-scanned bounds of
  tests/test_fused_train.py);
- ``state.npz`` across packages: bit for bit.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iotml.config import load_config as j_load_config
from iotml.gen.scenarios import AdversarialFleet as JAdversarialFleet
from iotml.gen.scenarios import condition as j_condition
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.mlops import AsyncCheckpointer as JAsyncCheckpointer
from iotml.mqtt.broker import MqttBroker as JMqttBroker
from iotml.mqtt.broker import QueueClient as JQueueClient
from iotml.mlops import ModelRegistry as JModelRegistry
from iotml.mlops import restore_trainer as j_restore_trainer
from iotml.models.autoencoder import CAR_AUTOENCODER as J_AE
from iotml.online import detectors as jd
from iotml.online.learner import AdaptationPolicy as JAdaptationPolicy
from iotml.online.learner import OnlineLearner as JOnlineLearner
from iotml.stream.broker import Broker as JBroker
from iotml.train.loop import Trainer as JTrainer
from iotml.train.loop import adam_injectable_cached
from iotml.train.loop import make_raw_train_step as j_make_raw_train_step
from iotml.train.loop import make_scanned_window_steps as j_window_steps
from iotml_torch.config import load_config
from iotml_torch.gen.scenarios import (FLEET_CONDITIONS, AdversarialFleet,
                                       condition)
from iotml_torch.gen.simulator import FleetScenario
from iotml_torch.mqtt.broker import MqttBroker as TMqttBroker
from iotml_torch.mqtt.broker import QueueClient as TQueueClient
from iotml_torch.mlops import AsyncCheckpointer, ModelRegistry, restore_trainer
from iotml_torch.mlops.checkpoint import (host_state, state_from_npz_bytes,
                                          state_to_npz_bytes)
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.models.convert import (inject_adam_from_optax,
                                        inject_adam_to_optax,
                                        params_from_jax)
from iotml_torch.online import detectors as td
from iotml_torch.online.learner import AdaptationPolicy, OnlineLearner
from iotml_torch.ops import fused_train
from iotml_torch.stream.broker import Broker
from iotml_torch.train.loop import (Trainer, TrainState,
                                    make_raw_train_step,
                                    make_scanned_window_steps,
                                    scanned_window_steps_cached)
from iotml_torch.train.optim import (HYPERPARAMS, InjectableAdam,
                                     InjectableAdamState, set_learning_rate)

SEED = 7
TOPIC = "SENSOR_DATA_S_AVRO"
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


# ---------------------------------------------------------------- series
def _series(kind: str, n: int = 900) -> np.ndarray:
    """Seeded error-like signals: a stationary stream, a step drift that
    heals back, a ramp, and a training model's decline."""
    rng = np.random.default_rng(SEED)
    if kind == "stationary":
        return rng.normal(0.02, 0.004, n)
    if kind == "step":
        return np.concatenate([rng.normal(0.02, 0.004, 300),
                               rng.normal(0.08, 0.008, 60),
                               rng.normal(0.025, 0.004, n - 360)])
    if kind == "ramp":
        return np.concatenate([
            rng.normal(0.02, 0.004, 300),
            0.02 + np.linspace(0, 0.06, 400) + rng.normal(0, 0.004, 400),
            rng.normal(0.08, 0.004, n - 700)])
    if kind == "declining":
        return 0.4 * np.exp(-np.arange(n) / 400.0) \
            + rng.normal(0, 0.01, n) + 0.1
    raise ValueError(kind)


SERIES = ("stationary", "step", "ramp", "declining")


def _ph_state(ph):
    return (ph.n, ph.mean, ph._cum, ph._cum_min, ph.stat)


def _aw_state(aw):
    return (aw._rows, aw.total, aw.total_sq, aw.width, aw._since_check,
            aw.last_cut, aw.mean, aw.variance)


# ------------------------------------------------------------- detectors
@pytest.mark.parametrize("kind", SERIES)
@pytest.mark.parametrize("kw", [{}, dict(delta=0.005, threshold=0.1,
                                         burn_in=3)])
def test_page_hinkley_equals_jax_step_by_step(kind, kw):
    t, j = td.PageHinkley(**kw), jd.PageHinkley(**kw)
    fired = 0
    for x in _series(kind):
        got, want = t.update(x), j.update(x)
        assert got == want
        assert _ph_state(t) == _ph_state(j)
        fired += got
    if kw and kind == "step":
        assert fired  # the series really exercise the firing branch
    t.reset(), j.reset()
    assert _ph_state(t) == _ph_state(j)


@pytest.mark.parametrize("kind", SERIES)
@pytest.mark.parametrize("kw", [{}, dict(delta=0.05, max_buckets=3,
                                         min_window=8, check_every=1)])
def test_adaptive_window_equals_jax_step_by_step(kind, kw):
    t, j = td.AdaptiveWindow(**kw), jd.AdaptiveWindow(**kw)
    cuts = 0
    for x in _series(kind, 1200):
        got, want = t.update(x), j.update(x)
        assert got == want
        assert _aw_state(t) == _aw_state(j)
        cuts += got
    if kind in ("ramp", "declining"):
        assert cuts and t.last_cut  # the cut branch is exercised


@pytest.mark.parametrize("kind", SERIES)
@pytest.mark.parametrize("detector", ["ph", "adwin", "both"])
@pytest.mark.parametrize("level_ratio", [1.25, 0.0])
def test_drift_monitor_equals_jax_step_by_step(kind, detector, level_ratio):
    kw = dict(detector=detector, level_ratio=level_ratio,
              max_adapting_updates=150)
    t, j = td.DriftMonitor(**kw), jd.DriftMonitor(**kw)
    for i, x in enumerate(_series(kind)):
        got, want = t.update(x), j.update(x)
        assert got == want, i
        assert t.describe() == j.describe(), i
        assert t.severity() == j.severity()
        assert (t._level_run, t._adapting_for, t._episode_peak) == \
            (j._level_run, j._adapting_for, j._episode_peak)
        assert _ph_state(t.ph) == _ph_state(j.ph)
        assert _aw_state(t.adwin) == _aw_state(j.adwin)
        if got is not None:
            t.reset_windows(), j.reset_windows()
    if kind == "step":
        assert t.drifts >= 1 and t.converged >= 1
    t.begin_episode("chip0-ph"), j.begin_episode("chip0-ph")
    assert t.describe() == j.describe()
    assert (t.state, td.STABLE, td.ADAPTING) == (j.state, jd.STABLE,
                                                 jd.ADAPTING)


def test_drift_monitor_rejects_an_unknown_detector():
    with pytest.raises(ValueError, match="ph|adwin|both"):
        td.DriftMonitor(detector="cusum")


# ------------------------------------------------------------ scenarios
_CONDITIONS = {"baseline": {}, "rush-hour": {},
               "regional-drift": dict(drift_tick=6),
               "schema-mix": {},
               "drift-storm": dict(drift_tick=5, drift_ramp_ticks=4)}


def _fleets(name, cars=25, seed=SEED):
    kw = _CONDITIONS[name]
    return (AdversarialFleet(FleetScenario(num_cars=cars, failure_rate=0.1,
                                           seed=seed), condition(name, **kw)),
            JAdversarialFleet(JFleetScenario(num_cars=cars, failure_rate=0.1,
                                             seed=seed),
                              j_condition(name, **kw)))


@pytest.mark.parametrize("name", sorted(_CONDITIONS))
def test_step_columns_equal_jax(name):
    t, j = _fleets(name)
    for _ in range(12):
        got, want = t.step_columns(), j.step_columns()
        assert sorted(got) == sorted(want)
        for col in want:
            assert got[col].dtype == want[col].dtype, col
            np.testing.assert_array_equal(got[col], want[col], err_msg=col)
    assert (t.gen.tick, t.gen.t) == (j.gen.tick, j.gen.t)
    assert list(t.region) == list(j.region)


@pytest.mark.parametrize("name", sorted(_CONDITIONS))
@pytest.mark.parametrize("partitions", [1, 3])
def test_publish_stream_is_byte_identical_to_jax(name, partitions):
    t, j = _fleets(name)
    tb, jb = Broker(), JBroker()
    n = t.publish_stream(tb, "T", n_ticks=10, partitions=partitions)
    assert n == j.publish_stream(jb, "T", n_ticks=10, partitions=partitions)
    assert t.published == j.published == n
    assert tb.topic("T").partitions == partitions
    total = 0
    for p in range(partitions):
        got = tb.fetch("T", p, 0, 10**6)
        want = jb.fetch("T", p, 0, 10**6)
        assert [(m.key, m.value, m.timestamp_ms) for m in got] == \
            [(m.key, m.value, m.timestamp_ms) for m in want]
        total += len(got)
    assert total == n
    assert t.describe() == j.describe()


def test_conditions_lookup_override_and_the_mqtt_leg():
    from iotml.gen.scenarios import FLEET_CONDITIONS as J_CONDITIONS

    assert {k: dataclasses.asdict(c) for k, c in FLEET_CONDITIONS.items()} \
        == {k: dataclasses.asdict(c) for k, c in J_CONDITIONS.items()}
    c = condition("regional-drift", drift_tick=40)
    assert c.drift_tick == 40 and c.regions == 4
    assert FLEET_CONDITIONS["regional-drift"].drift_tick is None
    with pytest.raises(KeyError):
        condition("nope")
    # the MQTT leg is ported: a baseline tick publishes the same JSON
    t, j = _fleets("baseline", cars=5)
    tm, jm = TMqttBroker(), JMqttBroker()
    tq, jq = TQueueClient(tm, "tap"), JQueueClient(jm, "tap")
    tq.subscribe("#", qos=1)
    jq.subscribe("#", qos=1)
    assert t.publish_mqtt(tm) == j.publish_mqtt(jm) == 5
    assert tq.messages == jq.messages


def _mqtt_leg(fleet, mqtt, saturate: bool):
    """Drive ``publish_mqtt`` for 12 ticks into ``mqtt`` with a tap; with
    ``saturate`` a persistent subscriber goes offline so its QoS 1 queue
    crosses the backpressure mark, and it drains between ticks."""
    tap = []
    s = mqtt.connect("tap", lambda *a: tap.append(a))
    mqtt.deliver_pending(s)
    mqtt.subscribe("tap", "vehicles/#", qos=1)
    slow = None
    if saturate:
        slow = mqtt.connect("slow", lambda *a: None, clean_start=False)
        mqtt.deliver_pending(slow)
        mqtt.subscribe("slow", "vehicles/#", qos=1)
        mqtt.disconnect("slow", slow)
    out = []
    for tick in range(12):
        out.append(fleet.publish_mqtt(mqtt, qos=1))
        out.append((mqtt.saturated(), fleet.describe()))
        if saturate and tick % 3 == 2:  # the slow consumer catches up
            slow = mqtt.connect("slow", lambda *a: None, clean_start=False)
            mqtt.deliver_pending(slow)
            mqtt.disconnect("slow", slow)
    return out, tap


@pytest.mark.parametrize("saturate", [False, True],
                         ids=["free", "backpressure"])
@pytest.mark.parametrize("name", sorted(_CONDITIONS) + ["flapping-links"])
def test_publish_mqtt_equal_jax(name, saturate):
    """The MQTT leg: per-car JSON, link flaps with store-and-forward,
    deferral while the broker is saturated and drop-oldest past the
    deferral bound; deliveries, counts and describe() equal JAX's."""
    kw = _CONDITIONS.get(name, {})
    fleets = (AdversarialFleet(FleetScenario(num_cars=12, failure_rate=0.1,
                                             seed=SEED),
                               condition(name, **kw), defer_limit=40),
              JAdversarialFleet(JFleetScenario(num_cars=12,
                                               failure_rate=0.1, seed=SEED),
                                j_condition(name, **kw), defer_limit=40))
    got = _mqtt_leg(fleets[0], TMqttBroker(offline_queue_limit=50,
                                           backpressure_hwm=30), saturate)
    want = _mqtt_leg(fleets[1], JMqttBroker(offline_queue_limit=50,
                                            backpressure_hwm=30), saturate)
    assert got == want
    last = got[0][-1][1]
    assert last["published"] == len(got[1])
    if saturate:
        assert last["deferred_total"] > 0
    if name == "flapping-links":
        assert last["flap_buffered"] > 0


# ------------------------------------------------------- injectable Adam
def _j_state(tx, seed=0):
    tr = JTrainer(J_AE, rng=jax.random.PRNGKey(seed), tx=tx)
    tr._ensure_state(np.zeros((4, 18), np.float32))
    return tr.state


def _t_state(jstate):
    """The port's TrainState holding a JAX injectable-Adam TrainState's
    numbers."""
    opt = jstate.opt_state
    inner = opt.inner_state[0]
    host = jax.tree.map(np.asarray, (opt.count, opt.hyperparams,
                                     inner.count, inner.mu, inner.nu))
    return TrainState(
        step=int(jstate.step),
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        opt_state=inject_adam_from_optax(host[0], host[1], host[2:]))


def _j_set_lr(jstate, lr):
    hp = dict(jstate.opt_state.hyperparams)
    hp["learning_rate"] = jnp.asarray(lr, jnp.float32)
    return jstate.replace(opt_state=jstate.opt_state._replace(
        hyperparams=hp))


def _assert_params_close(tparams, jparams, **tol):
    want = params_from_jax(jax.tree.map(np.asarray, jparams))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(tparams[k].numpy(), want[k].numpy(),
                                   err_msg=k, **tol)


def _windows(k, b=50, seed=SEED):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (k, b, 18)).astype(np.float32)
    masks = (rng.random((k, b)) < 0.9).astype(np.float32)
    return xs, masks


def test_injectable_adam_matches_inject_hyperparams_with_rate_edits():
    jtx = adam_injectable_cached(1e-3)
    jstate = _j_state(jtx)
    assert len(jax.tree_util.tree_leaves(jstate.opt_state)) == 23
    tx = InjectableAdam(1e-3)
    tstate = _t_state(jstate)
    assert tstate.opt_state.hyperparams["learning_rate"].dtype == \
        torch.float32
    jstep = jax.jit(j_make_raw_train_step(J_AE, jtx))
    tstep = make_raw_train_step(Trainer(CAR_AUTOENCODER, tx=tx,
                                        device="cpu").model, tx)
    xs, masks = _windows(10)
    for i, lr in enumerate([1e-3] * 3 + [5e-3] * 4 + [2e-4, 1e-3, 1e-3]):
        jstate = _j_set_lr(jstate, lr)
        tstate = TrainState(tstate.step, tstate.params,
                            set_learning_rate(tstate.opt_state, lr))
        jstate, jm = jstep(jstate, xs[i], xs[i], masks[i])
        tstate, tm = tstep(tstate, torch.from_numpy(xs[i]),
                           torch.from_numpy(xs[i]), torch.from_numpy(masks[i]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   **LOSS_TOL)
        _assert_params_close(tstate.params, jstate.params, rtol=0, atol=1e-6)
    count, hp, (inner_count, mu, nu) = inject_adam_to_optax(tstate.opt_state)
    assert int(count) == int(jstate.opt_state.count) == 10
    assert int(inner_count) == int(jstate.opt_state.inner_state[0].count)
    for k in HYPERPARAMS:
        assert hp[k].dtype == np.float32
        assert hp[k] == np.asarray(jstate.opt_state.hyperparams[k])
    want_mu = jax.tree.map(np.asarray, jstate.opt_state.inner_state[0].mu)
    for layer in mu:
        for leaf in mu[layer]:
            np.testing.assert_allclose(mu[layer][leaf],
                                       want_mu[layer][leaf], rtol=1e-5,
                                       atol=1e-8)


def test_injectable_adam_state_converts_both_ways_exactly():
    jstate = _j_state(adam_injectable_cached(1e-3))
    jstate = _j_set_lr(jstate, 3.3e-3)
    t = _t_state(jstate)
    count, hp, inner = inject_adam_to_optax(t.opt_state)
    again = inject_adam_from_optax(count, hp, inner)
    assert again.count == t.opt_state.count
    for k in HYPERPARAMS:
        assert again.hyperparams[k].item() == t.opt_state.hyperparams[k].item()
    assert float(t.opt_state.hyperparams["learning_rate"]) == \
        float(np.float32(3.3e-3))
    # the converted pieces rebuild the JAX state whole
    rebuilt = jstate.opt_state._replace(
        count=jnp.asarray(count), hyperparams={k: jnp.asarray(v)
                                               for k, v in hp.items()},
        inner_state=(optax.ScaleByAdamState(
            jnp.asarray(inner[0]), jax.tree.map(jnp.asarray, inner[1]),
            jax.tree.map(jnp.asarray, inner[2])), optax.EmptyState()))
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(jstate.opt_state)
    for a, b in zip(jax.tree_util.tree_leaves(rebuilt),
                    jax.tree_util.tree_leaves(jstate.opt_state)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert np.asarray(a).dtype == np.asarray(b).dtype


# --------------------------------------------------------- window groups
@pytest.mark.parametrize("k", [1, 2, 8])
def test_window_groups_match_jax_scan(k):
    jtx = adam_injectable_cached(1e-3)
    jstate = _j_state(jtx)
    tx = InjectableAdam(1e-3)
    tstate = _t_state(jstate)
    model = Trainer(CAR_AUTOENCODER, tx=tx, device="cpu").model
    run = scanned_window_steps_cached(model, tx)
    assert run is scanned_window_steps_cached(model, tx)
    xs, masks = _windows(k, b=100)
    jstate, jlosses = jax.jit(j_window_steps(J_AE, jtx))(jstate, xs, masks)
    tstate, tlosses = run(tstate, torch.from_numpy(xs),
                          torch.from_numpy(masks))
    assert tlosses.shape == (k,)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               **LOSS_TOL)
    _assert_params_close(tstate.params, jstate.params, **PARAM_TOL)
    assert tstate.step == int(jstate.step) == k
    assert tstate.opt_state.count == tstate.opt_state.inner.count == k
    # the same steps as K single calls
    single = make_raw_train_step(model, tx)
    one = _t_state(_j_state(jtx))
    for x, m in zip(xs, masks):
        one, _ = single(one, torch.from_numpy(x), torch.from_numpy(x),
                        torch.from_numpy(m))
    for key in PARAM_NAMES:
        assert torch.equal(one.params[key], tstate.params[key])
    assert make_scanned_window_steps(model, tx) is not run


# ------------------------------------------------- state.npz, 23 leaves
def test_23_leaf_state_npz_resumes_in_each_direction(tmp_path):
    jtx = adam_injectable_cached(1e-3)
    jstate = _j_set_lr(_j_state(jtx, seed=3), 4e-3)
    xs, masks = _windows(3)
    jstep = jax.jit(j_make_raw_train_step(J_AE, jtx))
    for x, m in zip(xs, masks):
        jstate, _ = jstep(jstate, x, x, m)
    # JAX writes, the port resumes
    jreg = JModelRegistry(str(tmp_path / "j"))
    jck = JAsyncCheckpointer(jreg)
    jck.snapshot(jstate, [(TOPIC, 0, 150)])
    jck.write_once()
    tr = Trainer(CAR_AUTOENCODER, tx=InjectableAdam(1e-3), device="cpu")
    assert restore_trainer(tr, ModelRegistry(jreg.root)).version == 1
    want = _t_state(jstate)
    _assert_states_bit_equal(tr.state, want)
    assert tr.state.step == 3
    # the port writes it back, and JAX resumes it bit for bit
    treg = ModelRegistry(str(tmp_path / "t"))
    tck = AsyncCheckpointer(treg)
    tck.snapshot(tr.state, [(TOPIC, 0, 150)],
                 end_offsets={(TOPIC, 0): 170})
    tck.write_once()
    assert tck.offsets_lag == 20
    blob = treg.load_bytes(1, "state.npz")
    assert sorted(np.load(io.BytesIO(blob)).files) == sorted(
        [f"p_{i}" for i in range(8)] + [f"o_{i}" for i in range(23)]
        + ["step"])
    jtr = JTrainer(J_AE, tx=jtx)
    assert j_restore_trainer(jtr, JModelRegistry(treg.root)).version == 1
    for a, b in zip(jax.tree_util.tree_leaves(jtr.state.opt_state),
                    jax.tree_util.tree_leaves(jstate.opt_state)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(jtr.state.step) == 3
    _assert_states_bit_equal(_t_state(jtr.state), want)


def _assert_states_bit_equal(got: TrainState, want: TrainState):
    assert got.step == want.step
    for k in PARAM_NAMES:
        assert got.params[k].numpy().tobytes() == \
            want.params[k].numpy().tobytes(), k
    go, wo = got.opt_state, want.opt_state
    assert isinstance(go, InjectableAdamState)
    assert (go.count, go.inner.count) == (wo.count, wo.inner.count)
    for k in HYPERPARAMS:
        assert go.hyperparams[k].numpy().tobytes() == \
            wo.hyperparams[k].numpy().tobytes()
    for tree in ("mu", "nu"):
        for k in PARAM_NAMES:
            assert getattr(go.inner, tree)[k].numpy().tobytes() == \
                getattr(wo.inner, tree)[k].numpy().tobytes()


def test_17_and_23_leaf_blobs_fall_back_to_weights_in_both(tmp_path):
    """A plain-Adam blob into an injectable template (and the reverse)
    fails the leaf check; both packages' restore then loads the weights
    and the step alone and keeps the template's fresh optimizer."""
    plain = _j_state(optax.adam(1e-3), seed=4).replace(
        step=np.asarray(9, np.int32))
    jreg = JModelRegistry(str(tmp_path / "plain"))
    ck = JAsyncCheckpointer(jreg)
    ck.snapshot(plain, [(TOPIC, 0, 5)])
    ck.write_once()
    tr = Trainer(CAR_AUTOENCODER, tx=InjectableAdam(2e-3), device="cpu")
    with pytest.raises(ValueError, match="leaf shape"):
        tr._ensure_state()
        state_from_npz_bytes(jreg.load_bytes(1, "state.npz"), tr.state)
    jtr = JTrainer(J_AE, tx=adam_injectable_cached(2e-3))
    assert restore_trainer(tr, ModelRegistry(jreg.root)).version == 1
    assert j_restore_trainer(jtr, jreg).version == 1
    assert tr.state.step == int(jtr.state.step) == 9
    assert tr.state.opt_state.inner.count == 0 == \
        int(jtr.state.opt_state.inner_state[0].count)
    assert float(tr.state.opt_state.hyperparams["learning_rate"]) == \
        float(jtr.state.opt_state.hyperparams["learning_rate"])
    _assert_params_close(tr.state.params, plain.params, rtol=0, atol=0)
    # the reverse: the port's 23-leaf blob into plain-Adam templates
    tr.state = TrainState(step=11, params=tr.state.params,
                          opt_state=tr.state.opt_state)
    treg = ModelRegistry(str(tmp_path / "inject"))
    tck = AsyncCheckpointer(treg)
    tck.snapshot(tr.state, [(TOPIC, 0, 5)])
    tck.write_once()
    tplain = Trainer(CAR_AUTOENCODER, device="cpu")
    jplain = JTrainer(J_AE)
    assert restore_trainer(tplain, treg).version == 1
    assert j_restore_trainer(jplain, JModelRegistry(treg.root)).version == 1
    assert tplain.state.step == int(jplain.state.step) == 11
    assert tplain.state.opt_state.count == 0 == \
        int(jplain.state.opt_state[0].count)


def test_host_state_copies_the_injectable_state_once():
    tr = Trainer(CAR_AUTOENCODER, tx=InjectableAdam(1e-3), device="cpu")
    tr._ensure_state()
    tr.state = TrainState(2, tr.state.params, set_learning_rate(
        tr.state.opt_state, 7e-3))
    params, opt = host_state(tr.state)
    assert isinstance(opt, InjectableAdamState)
    assert float(opt.hyperparams["learning_rate"]) == float(np.float32(7e-3))
    assert opt.hyperparams["learning_rate"] is not \
        tr.state.opt_state.hyperparams["learning_rate"]
    base = params[PARAM_NAMES[0]].untyped_storage().data_ptr()
    assert opt.inner.nu[PARAM_NAMES[-1]].untyped_storage().data_ptr() == base
    blob = state_to_npz_bytes(params, opt, 2)
    back = state_from_npz_bytes(blob, tr.state)
    _assert_states_bit_equal(back, tr.state)


# ----------------------------------------------------------- the refit
def _learners(epochs, windows, lr, b=50):
    """A port and a JAX learner (detect-only, empty streams) at the same
    state, with the same replay buffer."""
    jl = JOnlineLearner(JBroker(), "T", window=b, policy=JAdaptationPolicy(
        action="refit", refit_epochs=epochs))
    tl = OnlineLearner(Broker(), "T", window=b, policy=AdaptationPolicy(
        action="refit", refit_epochs=epochs), device="cpu")
    jl.trainer._ensure_state(np.zeros((b, 18), np.float32))
    tl.trainer._ensure_state()
    tl.trainer.state = _t_state(jl.trainer.state)
    jl.set_lr(lr), tl.set_lr(lr)
    xs, masks = _windows(windows, b=b)
    masks[-1, -3:] = 0.0  # a ragged last window
    for x, m in zip(xs, masks):
        jl.buffer.append((x, m))
        tl.buffer.append((torch.from_numpy(x), torch.from_numpy(m),
                          int(m.sum())))
    return tl, jl


@pytest.mark.parametrize("epochs,windows", [(2, 32), (2, 31), (1, 32),
                                            (3, 2), (2, 1), (1, 1)])
def test_split_refit_matches_jax_step_by_step_refit(monkeypatch, epochs,
                                                    windows):
    tl, jl = _learners(epochs, windows, lr=5e-3)
    calls = []
    real = fused_train.fused_fit

    def counting(state, xs, masks, ep, **kw):
        calls.append((xs.shape[0], ep, kw["lr"]))
        return real(state, xs, masks, ep, **kw)

    monkeypatch.setattr(fused_train, "fused_fit", counting)
    start = tl.trainer.state
    jl._refit()
    tl._refit()
    assert len(calls) == tl.refit_launches(windows)
    assert all(lr == float(np.float32(5e-3)) for *_x, lr in calls)
    assert sum(s * ep for s, ep, _lr in calls) + 1 == epochs * windows
    np.testing.assert_allclose(tl.last_loss, jl.last_loss, **LOSS_TOL)
    _assert_params_close(tl.trainer.state.params, jl.trainer.state.params,
                         **PARAM_TOL)
    assert tl.records_trained == jl.records_trained
    assert tl.trainer.state.step == int(jl.trainer.state.step)
    opt, jopt = tl.trainer.state.opt_state, jl.trainer.state.opt_state
    assert opt.count == int(jopt.count) == epochs * windows
    assert opt.inner.count == int(jopt.inner_state[0].count)
    assert tl.current_lr == jl.current_lr
    # last_loss is the very last step's pre-update loss: a plain
    # step-loop refit of the port from the same start gives it
    tr = tl.trainer
    st = start
    for _ in range(epochs):
        for x, m, _n in tl.buffer:
            st, metrics = tr._step(st, x, x, m)
    np.testing.assert_allclose(tl.last_loss, float(metrics["loss"]),
                               **LOSS_TOL)
    for k in PARAM_NAMES:
        np.testing.assert_allclose(tr.state.params[k].numpy(),
                                   st.params[k].numpy(), **PARAM_TOL)


def test_refit_with_no_epochs_or_no_buffer_changes_nothing():
    for epochs, windows in ((0, 4), (2, 0)):
        tl, _jl = _learners(epochs, max(windows, 1), lr=1e-3)
        if not windows:
            tl.buffer.clear()
        before = tl.trainer.state
        tl._refit()
        assert tl.trainer.state is before and tl.last_loss is None
        assert tl.refit_launches(windows) == 0 and tl.refits == 0


# --------------------------------------------------------------- config
def test_online_config_env_round_trip_equals_jax():
    env = {"IOTML_ONLINE_WINDOW": "200", "IOTML_ONLINE_PH_DELTA": "0.2",
           "IOTML_ONLINE_DETECTOR": "adwin", "IOTML_ONLINE_ADAPT": "refit",
           "IOTML_ONLINE_BUFFER_BATCHES": "16"}
    cfg, _ = load_config([], env=env)
    jcfg, _ = j_load_config([], env=env)
    assert cfg.online.window == 200
    assert cfg.online.ph_delta == pytest.approx(0.2)
    assert cfg.online.detector == "adwin"
    assert vars(cfg.online) == vars(jcfg.online)
    assert vars(load_config([])[0].online) == vars(j_load_config([])[0].online)
    cfg, rest = load_config(["--online.lr_boost=3", "x"], env={})
    assert cfg.online.lr_boost == 3.0 and rest == ["x"]
    with pytest.raises(ValueError):
        load_config([], env={"IOTML_ONLINE_WIDNOW": "1"})  # typo fails
    with pytest.raises(ValueError):
        load_config([], env={"IOTML_ONLINE_WINDOW": "wide"})
