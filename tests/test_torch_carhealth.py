"""The port's ``CarHealthDetector`` (``iotml_torch.serve.carhealth``) held
against the JAX package's on seeded key and error streams, on the CPU.

Each scenario drives both detectors with the same batches and compares,
after every update, the transitions it returned, and at the end the
per-car EMAs, counts, feature and value EMAs, alerted sets and sources,
the threshold, every recorded transition and the ``summary``; the
records ``publish_transitions`` writes are compared too.  A transition's
wall-clock ``t`` is left out: each detector stamps its own.

Tolerance: none.  The two run the same numpy arithmetic.
"""

import json

import numpy as np
import pytest

from iotml.serve.carhealth import CarHealthDetector as JDetector
from iotml.stream.broker import Broker as JBroker
from iotml_torch.serve.carhealth import CarHealthDetector
from iotml_torch.stream.broker import Broker

F = 18
NAMES = [f"f{j}" for j in range(F)]


def _no_t(transitions):
    return [tuple(tr[1:]) for tr in transitions]


def _stream(seed, n_updates, cars=40, rows=120, bad=(), bad_feature=None,
            drift_feature=None, keyless=False, scale_at=None):
    """Seeded batches: (keys [rows] S32, errs [rows], ferrs [rows, F],
    fvals [rows, F]).  ``bad`` cars get a raised mean error, or one raised
    feature error (``bad_feature``) or feature value (``drift_feature``);
    from update ``scale_at`` every error is 4x (a model swap)."""
    rng = np.random.default_rng(seed)
    names = [f"electric-vehicle-{i:05d}".encode() for i in range(cars)]
    for u in range(n_updates):
        keys = np.array([names[i] for i in rng.integers(0, cars, rows)],
                        "S32")
        if keyless:
            keys[rng.random(rows) < 0.1] = b""
        ferrs = rng.gamma(2.0, 0.1, (rows, F))
        fvals = rng.normal(0.0, 0.3, (rows, F))
        for b in bad:
            sel = keys == names[b]
            if bad_feature is not None:
                ferrs[sel, bad_feature] += 0.9
            elif drift_feature is not None:
                fvals[sel, drift_feature] += 2.5
            else:
                ferrs[sel] *= 3.0
        if scale_at is not None and u >= scale_at:
            ferrs *= 4.0
        yield keys, ferrs.mean(axis=1), ferrs, fvals


def _drive(kw, stream, heads=False, swap_at=None):
    port, jax_ = CarHealthDetector(**kw), JDetector(**kw)
    for u, (keys, errs, ferrs, fvals) in enumerate(stream):
        if swap_at is not None and u == swap_at:
            port.notify_model_swap()
            jax_.notify_model_swap()
        extra = dict(ferrs=ferrs, fvals=fvals) if heads else {}
        got = port.update(keys, errs, **extra)
        want = jax_.update(keys, errs, **extra)
        assert _no_t(got) == _no_t(want), u
    return port, jax_


def _assert_same_state(port, jax_):
    assert port.ema == jax_.ema
    assert port.count == jax_.count
    assert set(port.alerted) == set(jax_.alerted)
    assert port.alert_source == jax_.alert_source
    assert _no_t(port.transitions) == _no_t(jax_.transitions)
    assert port.threshold == jax_.threshold
    assert port.summary() == jax_.summary()
    for mine, theirs in ((port.fema, jax_.fema), (port.vema, jax_.vema)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            np.testing.assert_array_equal(mine[k], theirs[k])
    for name in ("_fmed", "_fsig", "_ftail", "_vmed", "_vsig", "_vtail",
                 "_vlive"):
        a, b = getattr(port, name), getattr(jax_, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)


SCENARIOS = {
    # the mean-error path: three cars alert, then the stream goes on
    "mse": (dict(threshold=0.5, min_records=10),
            dict(seed=0, n_updates=30, bad=(3, 7, 11)), False, None),
    "mse_keyless": (dict(threshold=0.5, alpha=0.2, min_records=5),
                    dict(seed=1, n_updates=25, bad=(2,), keyless=True),
                    False, None),
    "auto": (dict(threshold="auto", auto_floor=0.1, min_records=8),
             dict(seed=2, n_updates=120, bad=(5, 6)), False, None),
    "feature_head": (dict(threshold=5.0, feature_heads=True,
                          feature_names=NAMES, min_records=10),
                     dict(seed=3, n_updates=40, bad=(9,), bad_feature=4),
                     True, None),
    "drift_head": (dict(threshold=5.0, feature_heads=True,
                        feature_names=NAMES, min_records=10),
                   dict(seed=4, n_updates=40, bad=(12,), drift_feature=7),
                   True, None),
    "swap": (dict(threshold=99.0, alpha=0.3, feature_heads=True,
                  feature_names=NAMES, min_records=5, feature_z=8.0,
                  feature_floor=0.01),
             dict(seed=5, n_updates=40, bad=(1,), bad_feature=2,
                  scale_at=14), True, 14),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_detector_matches_jax(name):
    kw, stream_kw, heads, swap_at = SCENARIOS[name]
    port, jax_ = _drive(kw, _stream(**stream_kw), heads, swap_at)
    _assert_same_state(port, jax_)
    if name in ("mse", "feature_head", "drift_head"):
        assert port.alerted  # the scenario did raise alerts
    if name == "auto":
        assert port._calibrated and port.threshold != port.auto_floor
    if name == "drift_head":
        assert any(s.startswith("drift:") for s in port.alert_source.values())


@pytest.mark.parametrize("name", ["mse", "feature_head"])
def test_published_records_match_jax(name):
    kw, stream_kw, heads, swap_at = SCENARIOS[name]
    port, jax_ = _drive(kw, _stream(**stream_kw), heads, swap_at)
    records = {}
    for det, br in ((port, Broker()), (jax_, JBroker())):
        br.create_topic("car-health")
        n = det.publish_transitions(br, "car-health")
        assert n == len(det.transitions) > 0
        msgs = br.fetch("car-health", 0, 0, n + 1)
        recs = []
        for m in msgs:
            rec = json.loads(m.value)
            assert isinstance(rec.pop("t"), float)
            recs.append((m.key, rec))
        records[det is port] = recs
    assert records[True] == records[False]
    assert {r["state"] for _, r in records[True]} <= {"ALERT", "CLEAR"}


def test_publish_one_batch_of_transitions():
    """update()'s return is what the scorer publishes: one
    ``produce_many`` for a batch's transitions, its own timestamps."""
    det = CarHealthDetector(threshold=0.5, alpha=0.5, min_records=2)
    trans = det.update(np.array([b"a", b"a", b"b"], "S8"),
                       np.array([1.0, 1.0, 0.1]))
    calls = []

    class Recorder:
        def produce_many(self, topic, entries):
            calls.append((topic, entries))

    assert det.publish_transitions(Recorder(), "car-health", trans) == 1
    (topic, entries), = calls
    rec = json.loads(entries[0][1])
    assert topic == "car-health" and entries[0][0] == b"a"
    assert rec["t"] == trans[0][0] and rec["state"] == "ALERT"
