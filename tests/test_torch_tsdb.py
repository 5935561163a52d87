"""The port's log-native TSDB and burn-rate SLO engine
(``iotml_torch.obs.tsdb`` / ``slo``) against the JAX package's on the
same seeded inputs, on the CPU.

The same sample stream (counters with resets, gauges, histogram buckets,
duplicate and out-of-order stamps, the ``process=`` relabel) appended by
both packages gives ``_IOTML_TSDB`` records byte-equal in key and value;
``read_series``, ``TsdbTail``, ``instant``, ``range_query``, ``rate``,
``increase``, ``histogram_quantile`` and ``query`` give equal answers;
``parse_selector`` / ``parse_duration_ms`` equal results and error
messages; ``parse_prom_text`` equal to JAX's on hypothesis texts.  The
SLO engines over the same rules and series at the same ``now_ms`` give
equal transitions, ``_IOTML_ALERTS`` records and burn gauges, over the
JAX tests' cases (fire/resolve, a short spike, no traffic, latency
buckets) and the rule validation messages.  The alert-burn drill runs
once at its defaults on the CPU (marked slow: ~20 s of wall time).

Tolerance: none; every comparison is exact.
"""

import json
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from iotml.obs import federate as j_federate
from iotml.obs import slo as j_slo
from iotml.obs import tsdb as j_tsdb
from iotml.stream import Broker as JBroker
from iotml_torch.obs import canary, federate, slo, tsdb
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.stream.broker import Broker
from iotml_torch.supervise.supervisor import Supervisor

BASE_TS = 1_700_000_000_000
BUCKETS = ("0.05", "0.1", "0.5", "1.0", "+Inf")


@pytest.fixture(autouse=True)
def _no_firing_left():
    """Each package keeps its firing alerts process-wide (``/healthz``
    reads them): no test leaves one behind for the next."""
    yield
    slo._publish_firing({})
    j_slo._publish_firing({})


def _scrapes(seed: int, n: int = 60):
    """``n`` scrapes ``(ts_ms, samples, process)`` of a seeded fleet: two
    processes, a counter that resets now and then, a gauge, a latency
    histogram; some stamps repeat or go backwards."""
    rng = np.random.default_rng(seed)
    counts = {"a": 0.0, "b": 0.0}
    hist = {"a": [0.0] * len(BUCKETS), "b": [0.0] * len(BUCKETS)}
    ts = BASE_TS
    out = []
    for i in range(n):
        r = rng.random()
        if r < 0.05:
            pass                       # same stamp as the last scrape
        elif r < 0.1:
            ts -= int(rng.integers(1, 200))  # out of order
        else:
            ts += int(rng.integers(200, 1_500))
        proc = "a" if i % 3 else "b"
        if rng.random() < 0.08:
            counts[proc] = float(rng.integers(0, 10))  # a restart
            hist[proc] = [0.0] * len(BUCKETS)
        counts[proc] += float(rng.integers(0, 100))
        k = int(rng.integers(0, 20))
        slow = int(rng.integers(0, k + 1))
        edge = int(rng.integers(0, len(BUCKETS) - 1))
        for j in range(len(BUCKETS)):
            hist[proc][j] += (k - slow) + (slow if j >= edge + 1 else 0)
        samples = [("iotml_records_scored_total", {"stage": "score"},
                    counts[proc]),
                   ("iotml_consumer_lag_records",
                    {"group": "g", "topic": "t", "partition": "0"},
                    float(rng.normal(100.0, 30.0)))]
        samples += [("iotml_train_step_seconds_bucket", {"le": le},
                     hist[proc][j]) for j, le in enumerate(BUCKETS)]
        samples += [("iotml_train_step_seconds_count", {}, hist[proc][-1])]
        out.append((ts, samples, proc))
    return out


def _records(broker, topic):
    return [(m.offset, m.key, m.value)
            for m in broker.fetch(topic, 0, 0, broker.end_offset(topic, 0))]


def _filled(seed: int, chunk_ms: int = 5_000):
    t, j = Broker(), JBroker()
    ta = tsdb.TsdbAppender(t, chunk_ms=chunk_ms)
    ja = j_tsdb.TsdbAppender(j, chunk_ms=chunk_ms)
    for ts, samples, proc in _scrapes(seed):
        assert ta.append(samples, ts_ms=ts, process=proc) == \
            ja.append(samples, ts_ms=ts, process=proc)
    return t, j


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tsdb_records_are_byte_equal(seed):
    t, j = _filled(seed)
    got, want = _records(t, tsdb.TSDB_TOPIC), _records(j, j_tsdb.TSDB_TOPIC)
    assert got == want and len(got) > 60
    assert tsdb.TSDB_TOPIC == j_tsdb.TSDB_TOPIC == "_IOTML_TSDB"
    assert t.topic(tsdb.TSDB_TOPIC).cleanup_policy == "compact"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_series_and_tail_equal(seed):
    t, j = _filled(seed)
    got, want = tsdb.read_series(t), j_tsdb.read_series(j)
    assert got == want
    mid = BASE_TS + 20_000
    assert tsdb.read_series(t, start_ms=mid, end_ms=mid + 15_000) == \
        j_tsdb.read_series(j, start_ms=mid, end_ms=mid + 15_000)
    now = max(s[-1][0] for s in (v["samples"] for v in got.values()))
    for kw in ({}, {"lookback_ms": 10_000},
               {"names": {"iotml_records_scored_total"}}):
        assert tsdb.TsdbTail(t, **kw).collect(now) == \
            j_tsdb.TsdbTail(j, **kw).collect(now)


def _queries():
    sel = 'iotml_records_scored_total{process="a"}'
    return [sel, "iotml_records_scored_total",
            'iotml_records_scored_total{process=~"a|b"}',
            'iotml_consumer_lag_records{process!="a"}',
            "rate(iotml_records_scored_total[20s])",
            "increase(iotml_records_scored_total[1m])",
            f"rate({sel}[90s])",
            "histogram_quantile(0.99, iotml_train_step_seconds)",
            "histogram_quantile(0.5, iotml_train_step_seconds[30s])",
            'histogram_quantile(0.9, iotml_train_step_seconds_bucket'
            '{process="b"}[1m])']


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queries_equal(seed):
    t, j = _filled(seed)
    ts_, js = tsdb.read_series(t), j_tsdb.read_series(j)
    end = max(s["samples"][-1][0] for s in ts_.values())
    resets = tsdb.tsdb_resets.value()
    j_resets = j_tsdb.tsdb_resets.value()
    for expr in _queries():
        for kw in ({}, {"at_ms": end - 7_000},
                   {"start_ms": BASE_TS, "end_ms": end, "step_ms": 4_000}):
            assert tsdb.query(ts_, expr, **kw) == \
                j_tsdb.query(js, expr, **kw), (expr, kw)
    assert tsdb.tsdb_resets.value() - resets == \
        j_tsdb.tsdb_resets.value() - j_resets > 0
    m = [tsdb.Matcher("process", "=~", "a|b")]
    jm = [j_tsdb.Matcher("process", "=~", "a|b")]
    name = "iotml_records_scored_total"
    assert tsdb.instant(ts_, name, m, at_ms=end) == \
        j_tsdb.instant(js, name, jm, at_ms=end)
    assert tsdb.range_query(ts_, name, m, BASE_TS, end, 3_000) == \
        j_tsdb.range_query(js, name, jm, BASE_TS, end, 3_000)
    for fn, jfn in ((tsdb.rate, j_tsdb.rate),
                    (tsdb.increase, j_tsdb.increase)):
        for w in (5_000, 60_000, 10**9):
            assert fn(ts_, name, m, window_ms=w, at_ms=end) == \
                jfn(js, name, jm, window_ms=w, at_ms=end)
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        for w in (None, 30_000):
            assert tsdb.histogram_quantile(
                ts_, q, "iotml_train_step_seconds", window_ms=w,
                at_ms=end) == j_tsdb.histogram_quantile(
                js, q, "iotml_train_step_seconds", window_ms=w, at_ms=end)


def _outcome(fn, *a):
    try:
        out = fn(*a)
    except ValueError as e:
        return "ValueError", str(e)
    if isinstance(out, tuple):
        name, matchers, window = out
        return name, [repr(m) for m in matchers], window
    return out


@pytest.mark.parametrize("text", [
    'iotml_x_total{job="a",mode=~"b.*"}[5m]', "m", "m[30s]", "m[1.5h]",
    'm{a!="x", b!~"y|z"}', 'm{a="q\\"uote\\\\d\\n"}', "{nometric}",
    "m{a=b}", 'm{a="1",}', "m[5x]", "rate(m[5m])", "  m  ", "m{}[2d]"])
def test_parse_selector_equal(text):
    assert _outcome(tsdb.parse_selector, text) == \
        _outcome(j_tsdb.parse_selector, text)


@pytest.mark.parametrize("text", ["30s", "5m", "1h", "2d", "1.5m", " 7s ",
                                  "5x", "", "m", "-1s", "1e3s"])
def test_parse_duration_equal(text):
    assert _outcome(tsdb.parse_duration_ms, text) == \
        _outcome(j_tsdb.parse_duration_ms, text)


def test_bad_expressions_raise_as_jax():
    series = tsdb.read_series(_filled(0)[0])
    for expr in ("rate(m)", "m[5m]", "histogram_quantile(2, m)", "{x}"):
        with pytest.raises(ValueError) as t_err:
            tsdb.query(series, expr)
        with pytest.raises(ValueError) as j_err:
            j_tsdb.query(series, expr)
        assert str(t_err.value) == str(j_err.value)


_label_text = st.text(alphabet=st.sampled_from('ab{}=,"\\\n x1'),
                      max_size=8)


@settings(max_examples=200, deadline=None)
@given(lines=st.lists(st.one_of(
    st.tuples(st.sampled_from(["m", "m_total", "a:b"]),
              st.dictionaries(st.sampled_from(["le", "k", "process"]),
                              _label_text, max_size=3),
              st.one_of(st.floats(allow_nan=False), st.just(float("inf")))),
    st.text(alphabet=st.sampled_from('#TYPE m{}="\\ 1.5\n'), max_size=20)),
    max_size=12))
def test_parse_prom_text_equal_to_jax(lines):
    out = []
    for line in lines:
        if isinstance(line, tuple):
            name, labels, value = line
            out.append(f"{name}{t_metrics._fmt_labels(labels)} {value}")
        else:
            out.append(line)
    text = "\n".join(out)
    assert federate.parse_prom_text(text) == j_federate.parse_prom_text(text)


def test_bounded_under_forced_compaction_as_jax(tmp_path):
    t = Broker(store_dir=str(tmp_path / "t"))
    j = JBroker(store_dir=str(tmp_path / "j"))
    for b, mod in ((t, tsdb), (j, j_tsdb)):
        app = mod.TsdbAppender(b, chunk_ms=1_000)
        for i in range(200):
            app.append([("iotml_b_total", {}, float(i)),
                        ("iotml_b_gauge", {"k": "v"}, float(i % 7))],
                       ts_ms=BASE_TS + i * 100)
        b.store.log_for(mod.TSDB_TOPIC, 0).roll()
        b.run_compaction(force=True)
    assert _records(t, tsdb.TSDB_TOPIC) == _records(j, j_tsdb.TSDB_TOPIC)
    assert len(_records(t, tsdb.TSDB_TOPIC)) == 40
    assert tsdb.read_series(t) == j_tsdb.read_series(j)
    t.close()
    j.close()


def test_rate_reads_a_supervised_restart_as_a_reset():
    """A supervised unit's counter restarts from zero mid-stream: rate()
    stays non-negative and counts the reset, equal to JAX's reading of
    the same samples."""
    broker = Broker()
    app = tsdb.TsdbAppender(broker, chunk_ms=3_600_000)
    tick = {"i": 0}
    crashed, finished = threading.Event(), threading.Event()

    def scrape_loop(unit):
        count = 0.0
        while not unit.should_stop():
            count += 10.0
            i = tick["i"]
            tick["i"] += 1
            app.append([("iotml_unit_work_total", {"unit": "w"}, count)],
                       ts_ms=BASE_TS + i * 1_000)
            unit.heartbeat()
            if not crashed.is_set() and count >= 50.0:
                crashed.set()
                raise RuntimeError("simulated crash mid-scrape")
            if crashed.is_set() and count >= 30.0:
                finished.set()
                while not unit.should_stop():
                    time.sleep(0.01)
                return
            time.sleep(0.005)

    sup = Supervisor(poll_interval_s=0.02, name="torch-tsdb-reset")
    unit = sup.add_loop("scraper", scrape_loop, heartbeat_timeout_s=30.0)
    sup.start()
    try:
        assert finished.wait(10.0)
    finally:
        sup.stop()
    assert unit.restarts == 1
    series = tsdb.read_series(broker)
    r = tsdb.rate(series, "iotml_unit_work_total", window_ms=3_600_000)
    assert r == j_tsdb.rate(series, "iotml_unit_work_total",
                            window_ms=3_600_000)
    assert r[0]["value"] >= 0.0 and r[0]["resets"] == 1


# ----------------------------------------------------------- SLO engine
def _mkseries(points):
    out = {}
    for (name, labels), samples in points.items():
        labels = dict(labels)
        out[tsdb.series_id(name, labels)] = {
            "n": name, "l": labels, "samples": sorted(samples)}
    return out


def _ratio_rule(**over):
    doc = {"name": "api-availability", "objective": 0.99,
           "indicator": {"kind": "ratio", "bad": "err_total",
                         "total": "req_total"},
           "windows": (("fast", 2_000, 6_000, 10.0),
                       ("slow", 4_000, 12_000, 5.0))}
    doc.update(over)
    return doc


def _ratio_series(err_rate, n_s=60, spike_at=None):
    req, err = [], []
    total = bad = 0.0
    for i in range(n_s):
        total += 10.0
        bad += 3.0 if spike_at == i else 10.0 * err_rate
        req.append((BASE_TS + i * 1_000, total))
        err.append((BASE_TS + i * 1_000, bad))
    return _mkseries({("req_total", ()): req, ("err_total", ()): err})


def _latency_series():
    """A histogram scraped twice: nothing, then 50 slow observations."""
    reg = t_metrics.Registry()
    h = reg.histogram("lat_seconds", buckets=(0.05, 0.1, 0.5, 1.0))
    b = Broker()
    app = tsdb.TsdbAppender(b, chunk_ms=60_000)
    app.append(federate.parse_prom_text(reg.render())[1], ts_ms=BASE_TS)
    for _ in range(50):
        h.observe(1.0)
    app.append(federate.parse_prom_text(reg.render())[1],
               ts_ms=BASE_TS + 1_000)
    return tsdb.read_series(b)


LAT_RULE = {"name": "lat", "objective": 0.9,
            "indicator": {"kind": "latency", "metric": "lat_seconds",
                          "threshold_s": 0.1},
            "windows": (("fast", 2_000, 6_000, 5.0),)}
NOW = BASE_TS + 59_000
CASES = {
    "fire_resolve": ([_ratio_rule()],
                     [(_ratio_series(0.0), NOW), (_ratio_series(1.0), NOW),
                      (_ratio_series(1.0), NOW), (_ratio_series(0.0), NOW)]),
    "short_spike": ([_ratio_rule()],
                    [(_ratio_series(0.0, spike_at=59), NOW)]),
    "no_traffic": ([_ratio_rule()], [({}, BASE_TS)]),
    "latency": ([LAT_RULE], [(_latency_series(), BASE_TS + 1_000)]),
    "two_rules": ([_ratio_rule(), LAT_RULE],
                  [(_ratio_series(0.5), NOW),
                   (_latency_series(), BASE_TS + 1_000),
                   ({}, NOW + 10**7)]),
}


def _alerts(broker):
    return _records(broker, slo.ALERTS_TOPIC)


def _run_engine(mod, broker, rules, steps):
    eng = mod.SloEngine(broker, rules, interval_s=0.1)
    out = []
    for series, now in steps:
        trans = eng.evaluate(series=series, now_ms=now)
        burns = {(r.name, w[0]): mod.slo_burn_rate.value(slo=r.name,
                                                         window=w[0])
                 for r in eng.rules for w in r.windows}
        out.append((trans, burns, mod.alerts_firing.value(),
                    mod.firing_alerts(),
                    {n: (s.firing, s.window, s.burn, s.since_ms, s.message)
                     for n, s in eng.states.items()}))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_slo_engine_equal_to_jax(case):
    rules, steps = CASES[case]
    t, j = Broker(), JBroker()
    got = _run_engine(slo, t, rules, steps)
    want = _run_engine(j_slo, j, rules, steps)
    assert got == want
    assert _alerts(t) == _records(j, j_slo.ALERTS_TOPIC)
    assert slo.read_alerts(t) == j_slo.read_alerts(j)
    assert t.topic(slo.ALERTS_TOPIC).cleanup_policy == "compact"
    actions = [x["action"] for step in got for x in step[0]]
    assert actions == {"fire_resolve": ["fire", "resolve"],
                       "short_spike": [], "no_traffic": [],
                       "latency": ["fire"],
                       "two_rules": ["fire", "resolve", "fire",
                                     "resolve"]}[case]


@pytest.mark.parametrize("doc", [
    {"objective": 0.9}, _ratio_rule(objective=1.5), _ratio_rule(objective=0),
    {"name": "x", "objective": 0.9, "indicator": {"kind": "bogus"}},
    {"name": "x", "objective": 0.9, "indicator": {"kind": "latency"}},
    {"name": "x", "objective": 0.9,
     "indicator": {"kind": "latency", "metric": "m", "threshold_s": "q"}},
    {"name": "x", "objective": 0.9, "indicator": {"kind": "ratio",
                                                  "bad": "b"}},
    _ratio_rule(windows=[["w", "1", 2, "3.5"]]), _ratio_rule()])
def test_rule_validation_equal_to_jax(doc):
    def outcome(mod):
        try:
            r = mod.SloRule.from_dict(doc)
        except ValueError as e:
            return str(e)
        return (r.name, r.objective, r.indicator, r.windows, r.window_scale,
                r.error_budget)

    assert outcome(slo) == outcome(j_slo)


def test_engine_reads_only_its_indicator_families():
    engine = slo.SloEngine(Broker(), canary.default_slo_rules(),
                           interval_s=0.1)
    assert engine._indicator_families() == {
        "iotml_canary_e2e_seconds_bucket", "iotml_canary_probes_total"}
    assert slo.DEFAULT_WINDOWS == j_slo.DEFAULT_WINDOWS


def test_engine_loop_runs_as_a_supervised_unit():
    """``SloEngine.loop`` under the supervisor: it evaluates on its
    cadence from the TSDB, heartbeats, and a firing alert reaches
    ``/healthz`` through ``firing_alerts``."""
    b = Broker()
    app = tsdb.TsdbAppender(b, chunk_ms=60_000)
    now = int(time.time() * 1000)
    for i in range(8):
        app.append([("req_total", {}, 10.0 * (i + 1)),
                    ("err_total", {}, 10.0 * (i + 1))],
                   ts_ms=now - 7_000 + i * 1_000)
    eng = slo.SloEngine(b, [_ratio_rule()], interval_s=0.05)
    sup = Supervisor(poll_interval_s=0.02, name="torch-slo-loop")
    unit = sup.add_loop("slo-engine", eng.loop, heartbeat_timeout_s=30.0)
    sup.start()
    try:
        deadline = time.monotonic() + 10
        while not eng.states["api-availability"].firing and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert eng.states["api-availability"].firing
        assert "api-availability" in t_metrics._healthz_doc()["alerts"]
        assert t_metrics._healthz_doc()["status"] == "degraded"
    finally:
        sup.stop()
    assert unit.restarts == 0
    assert json.loads(_alerts(b)[0][2])["action"] == "fire"


@pytest.mark.slow
def test_alert_burn_drill_passes_on_the_cpu():
    from iotml_torch.obs.drill import drill_alert_burn

    rep = drill_alert_burn(device="cpu")
    assert rep.ok, "\n".join(rep.lines())
    assert rep.slos["time_to_fire_s"] is not None
    assert rep.slos["time_to_resolve_s"] is not None
