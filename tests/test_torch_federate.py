"""Fleet federation and the observability CLI's ``fleet`` and ``tsdb``
subcommands (``iotml_torch.obs.federate`` / ``__main__``) against the JAX
package's, on the CPU.

Two ``/metrics`` servers (one of each package, their registries filled
alike) are scraped by both packages' ``FleetCollector``: the merged text,
the roll-ups, the merged ``/healthz`` and the ``_IOTML_METRICS``
changelog are equal; the same snapshots render byte-equal; a manifest
written by one package is read by the other and the two write the same
bytes.  ``python -m iotml_torch.obs fleet --once [--json]
[--min-processes N]`` prints and exits as JAX's over that manifest;
``tsdb query``, ``slo-status`` and ``canary-report`` over one wire server
holding a TSDB history, alert records and canary families print the same
as JAX's and exit with the same codes.  A metrics server started under
``IOTML_OBS_ENDPOINTS`` publishes itself into the manifest, and a
``FleetServer`` serves the merged view and appends to the TSDB.

Tolerance: none; every comparison is exact.
"""

import contextlib
import io
import json
import urllib.request

import pytest

from iotml.obs import __main__ as j_obs_main
from iotml.obs import federate as j_federate
from iotml.obs import metrics as j_metrics
from iotml.obs import tsdb as j_tsdb
from iotml.stream import Broker as JBroker
from iotml_torch.obs import __main__ as obs_main
from iotml_torch.obs import federate, slo, tsdb
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs import tracing
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.kafka_wire import KafkaWireServer

BASE_TS = 1_700_000_000_000


@pytest.fixture(autouse=True)
def _endpoints_restored():
    """``publish_endpoint`` also records the endpoint in its package's
    process-wide registry, which an endpoint-less collector scrapes: each
    test leaves both registries as it found them."""
    saved = [(mod, dict(mod._local_endpoints))
             for mod in (federate, j_federate)]
    yield
    for mod, was in saved:
        with mod._local_lock:
            mod._local_endpoints.clear()
            mod._local_endpoints.update(was)


def _fill(mod):
    """A registry of ``mod`` with the families the roll-ups read."""
    reg = mod.Registry()
    reg.counter("iotml_records_scored_total", "s").inc(1234)
    reg.counter("iotml_records_trained_total", "t").inc(600)
    lag = reg.gauge("iotml_consumer_lag_records", "l")
    lag.set(17, group="g", topic="t", partition="0")
    lag.set(5, group="g", topic="t", partition="1")
    reg.gauge("iotml_isr_size", "i").set(2, topic="t", partition="0")
    reg.gauge("iotml_replica_lag_records", "r").set(9, topic="t")
    h = reg.histogram("iotml_train_step_seconds", "h",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 2.0):
        h.observe(v, loop="train")
    return reg


@pytest.fixture
def servers():
    t_srv = t_metrics.start_http_server(0, registry=_fill(t_metrics))
    j_srv = j_metrics.start_http_server(0, registry=_fill(j_metrics))
    eps = [{"name": "p-jax", "address":
            f"127.0.0.1:{j_srv.server_address[1]}"},
           {"name": "p-torch", "address":
            f"127.0.0.1:{t_srv.server_address[1]}"}]
    yield eps
    for s in (t_srv, j_srv):
        s.shutdown()
        s.server_close()


def _no_ts(state):
    return {k: {f: v for f, v in d.items() if f != "ts_ms"}
            for k, d in state.items()}


def test_the_servers_render_alike(servers):
    texts = []
    for e in servers:
        with urllib.request.urlopen(f"http://{e['address']}/metrics") as r:
            texts.append(r.read())
    assert texts[0] == texts[1]


def test_merged_view_and_rollups_equal_jax(servers):
    t_col = federate.FleetCollector(endpoints=servers)
    j_col = j_federate.FleetCollector(endpoints=servers)
    t_snaps, j_snaps = t_col.collect(), j_col.collect()
    assert t_col.render() == j_col.render()
    text = t_col.render()
    assert 'iotml_cluster_up{process="p-torch"} 1' in text
    assert "iotml_cluster_processes 2" in text
    assert "iotml_cluster_records_scored_total 2468.0" in text
    assert 'iotml_cluster_consumer_lag_records{group="g",topic="t"} 44.0' \
        in text
    assert t_col.healthz() == j_col.healthz()
    assert t_col.healthz()["up_count"] == 2
    assert _no_ts(t_col.fleet_state()) == _no_ts(j_col.fleet_state())
    # the same snapshots render byte-equal in either package
    assert t_col.render(j_snaps) == j_col.render(j_snaps)
    assert t_col.render(t_snaps) == j_col.render(t_snaps)
    # the changelog: one compacted record per process, read back alike
    tb, jb = Broker(), JBroker()
    assert t_col.snapshot_changelog(tb, j_snaps) == \
        j_col.snapshot_changelog(jb, j_snaps) == 2
    assert federate.read_fleet_state(tb) == j_federate.read_fleet_state(jb)
    assert [(m.key, m.value) for m in tb.fetch(federate.METRICS_TOPIC, 0,
                                                 0, 10)] == \
        [(m.key, m.value) for m in jb.fetch(j_federate.METRICS_TOPIC, 0,
                                            0, 10)]
    # TSDB append of the scrape: the same records as JAX's appender
    ta, ja = tsdb.TsdbAppender(tb), j_tsdb.TsdbAppender(jb)
    assert t_col.append_tsdb(ta, j_snaps) == j_col.append_tsdb(ja, j_snaps)
    assert [(m.key, m.value) for m in tb.fetch(tsdb.TSDB_TOPIC, 0, 0, 999)] \
        == [(m.key, m.value) for m in jb.fetch(tsdb.TSDB_TOPIC, 0, 0, 999)]


def test_a_down_process_reads_alike():
    eps = [{"name": "gone", "address": "127.0.0.1:1"}]
    t_col = federate.FleetCollector(endpoints=eps, timeout_s=0.5)
    j_col = j_federate.FleetCollector(endpoints=eps, timeout_s=0.5)
    t_col.collect()
    j_col.collect()
    assert t_col.render() == j_col.render()
    assert t_col.healthz() == j_col.healthz() == {
        "status": "degraded", "processes": {"gone": {
            "address": "127.0.0.1:1", "status": "down"}},
        "degraded": ["gone"], "process_count": 1, "up_count": 0}


def test_manifests_cross_both_packages(tmp_path):
    tp, jp = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    for path, mod in ((tp, federate), (jp, j_federate)):
        mod.publish_endpoint(path, "trainer", "127.0.0.1:9101")
        mod.publish_endpoint(path, "scorer", "127.0.0.1:9102")
        mod.publish_endpoint(path, "trainer", "127.0.0.1:9201")  # restart
    assert open(tp).read() == open(jp).read()
    assert j_federate.load_manifest(tp) == federate.load_manifest(jp) == [
        {"name": "scorer", "address": "127.0.0.1:9102"},
        {"name": "trainer", "address": "127.0.0.1:9201"}]
    (tmp_path / "torn.json").write_text('[{"name": "x", "addr')
    assert federate.load_manifest(str(tmp_path / "torn.json")) == \
        j_federate.load_manifest(str(tmp_path / "torn.json")) == []
    assert federate.manifest_path({"IOTML_OBS_ENDPOINTS": tp}) == tp
    assert federate.manifest_path({}) is None


def test_a_metrics_server_joins_the_manifest(tmp_path, monkeypatch):
    path = str(tmp_path / "m.json")
    monkeypatch.setenv("IOTML_OBS_ENDPOINTS", path)
    srv = t_metrics.start_http_server(0)
    try:
        port = srv.server_address[1]
        entries = j_federate.load_manifest(path)
        assert {"name": tracing.proc_name(),
                "address": f"127.0.0.1:{port}"} in entries
    finally:
        srv.shutdown()
        srv.server_close()


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("extra", [["--json"], [], ["--json",
                                                    "--min-processes", "3"],
                                   ["--min-processes", "2"]])
def test_fleet_once_prints_as_jax(servers, tmp_path, extra):
    path = str(tmp_path / "eps.json")
    for e in servers:
        federate.publish_endpoint(path, e["name"], e["address"])
    argv = ["fleet", "--endpoints", path, "--once", *extra]
    got, want = _run(obs_main.main, argv), _run(j_obs_main.main, argv)
    assert got == want
    assert got[0] == (1 if "3" in extra else 0)


def test_fleet_once_on_an_empty_manifest_exits_2(tmp_path):
    path = str(tmp_path / "none.json")
    argv = ["fleet", "--endpoints", path, "--once"]
    assert _run(obs_main.main, argv) == _run(j_obs_main.main, argv)
    assert _run(obs_main.main, argv)[0] == 2


@pytest.fixture
def tsdb_server():
    """A wire server over a broker holding a TSDB history (scorer and
    canary families, a counter reset), burn gauges and an alert."""
    b = Broker()
    app = tsdb.TsdbAppender(b, chunk_ms=10_000)
    reg = t_metrics.Registry()
    probes = reg.counter("iotml_canary_probes_total", "p")
    e2e = reg.histogram("iotml_canary_e2e_seconds", "e",
                        buckets=(0.05, 0.1, 0.25, 1.0))
    scored = reg.counter("iotml_records_scored_total", "s")
    for i in range(40):
        probes.inc(2, outcome="sent")
        probes.inc(1 + (i % 2), outcome="ok")
        if i % 7 == 0:
            probes.inc(1, outcome="lost")
        for v in (0.02, 0.07, 0.3 if i > 30 else 0.04):
            e2e.observe(v)
        scored.inc(100)
        samples = federate.parse_prom_text(reg.render())[1]
        if i == 20:  # the scorer restarted: its counter re-started
            samples = [(n, l, v - 2000.0 if n ==
                        "iotml_records_scored_total" else v)
                       for n, l, v in samples]
        samples.append(("iotml_slo_burn_rate",
                        {"slo": "canary-e2e-latency", "window": "fast"},
                        float(i) / 3.0))
        app.append(samples, ts_ms=BASE_TS + i * 1_000, process="scorer")
    rules = [{"name": "canary-e2e-latency", "objective": 0.97,
              "indicator": {"kind": "latency",
                            "metric": "iotml_canary_e2e_seconds",
                            "threshold_s": 0.1},
              "windows": (("fast", 5_000, 10_000, 2.0),)}]
    eng = slo.SloEngine(b, rules)
    series = tsdb.read_series(b)
    eng.evaluate(series=series, now_ms=BASE_TS + 39_000)
    slo._publish_firing({})
    with KafkaWireServer(b) as srv:
        yield f"127.0.0.1:{srv.port}", eng


@pytest.mark.parametrize("argv", [
    ["query", "rate(iotml_records_scored_total[20s])"],
    ["query", "increase(iotml_records_scored_total[1m])", "--json"],
    ["query", "iotml_canary_probes_total{outcome=~\"ok|lost\"}"],
    ["query", "histogram_quantile(0.95, iotml_canary_e2e_seconds[15s])",
     "--json"],
    ["query", "iotml_records_scored_total", "--start-ms", str(BASE_TS),
     "--end-ms", str(BASE_TS + 39_000), "--step-ms", "5000"],
    ["query", "rate(iotml_records_scored_total[10s])", "--time-ms",
     str(BASE_TS + 25_000), "--json"],
    ["query", "rate(iotml_records_scored_total)"],
    ["query", "nothing_here"],
    ["slo-status"], ["slo-status", "--json"],
    ["canary-report"], ["canary-report", "--json", "--window", "10s"],
    ["canary-report", "--window", "1s"]])
def test_tsdb_subcommands_print_as_jax(tsdb_server, argv):
    addr, _eng = tsdb_server
    full = ["tsdb", *argv, "--bootstrap", addr]
    got, want = _run(obs_main.main, full), _run(j_obs_main.main, full)
    assert got == want
    if argv[0] == "slo-status":
        assert got[0] == 1  # the latency alert fires
    elif argv == ["query", "rate(iotml_records_scored_total)"]:
        assert got[0] == 2
    else:
        assert got[0] == 0


def test_tsdb_unreachable_broker_exits_2():
    for main in (obs_main.main, j_obs_main.main):
        rc, _out, err = _run(main, ["tsdb", "slo-status", "--bootstrap",
                                    "127.0.0.1:1"])
        assert rc == 2 and "cannot reach broker" in err


def test_fleet_server_serves_and_appends(servers):
    b = Broker()
    app = tsdb.TsdbAppender(b, chunk_ms=60_000)
    srv = federate.FleetServer(federate.FleetCollector(endpoints=servers),
                               port=0, interval_s=0.05, broker=b,
                               tsdb=app).start()
    try:
        snaps = srv.scrape_once()
        assert sorted(snaps) == ["p-jax", "p-torch"]
        base = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(base + "/metrics") as r:
            assert "iotml_cluster_processes 2" in r.read().decode()
        with urllib.request.urlopen(base + "/healthz") as r:
            assert json.loads(r.read())["up_count"] == 2
        series = tsdb.read_series(b)
        up = tsdb.instant(series, "iotml_records_scored_total")
        assert sorted(r["labels"]["process"] for r in up) == \
            ["p-jax", "p-torch"]
        assert sorted(federate.read_fleet_state(b)) == ["p-jax", "p-torch"]
    finally:
        srv.stop()
