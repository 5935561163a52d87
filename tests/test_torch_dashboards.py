"""The port's dashboards, control center and scalar logs
(``iotml_torch.obs.dashboards`` / ``control_center`` / ``tb``) against
the JAX package's, on the CPU.

Identically filled registries of the two packages give byte-equal
dashboard JSON (every family split) and ConfigMaps, and
``python -m iotml_torch.obs.dashboards`` prints what JAX's prints.  The
control center's ``snapshot()`` over the same broker content gives
JAX's topic entries; a ``Platform(cc_port=0)`` serves ``/api/status``
with the broker's offsets and ``/`` as HTML, lists it in ``endpoints()``,
and the command line serves it by default.  ``ScalarLogger`` writes
JAX's JSONL lines (but the wall time) and TensorBoard event files where
tensorboardX imports; ``TorchProfiler`` captures a window.

Tolerance: none; every comparison is exact.
"""

import json
import os
import subprocess
import sys
import time
import types
import urllib.request

import pytest

from iotml.obs import control_center as j_cc
from iotml.obs import dashboards as j_dash
from iotml.obs import metrics as j_metrics
from iotml.obs import tb as j_tb
from iotml.stream import Broker as JBroker
from iotml_torch.cli import up
from iotml_torch.cli.up import Platform
from iotml_torch.obs import ScalarLogger, TorchProfiler
from iotml_torch.obs import control_center as cc
from iotml_torch.obs import dashboards as dash
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.obs import tb as t_tb
from iotml_torch.stream.broker import Broker


def _fill(mod):
    reg = mod.Registry()
    reg.counter("iotml_records_scored_total", "records through the scorer")
    reg.gauge("iotml_reconstruction_mse", "last reconstruction error")
    reg.histogram("iotml_train_step_seconds", "train-step latency")
    reg.counter("mqtt_publish_received_total", "publishes")
    reg.counter("kafka_extension_total_forwarded", "forwarded")
    reg.gauge("agent_connected", "agents")
    reg.counter("live_train_rounds_total", "rounds")
    reg.gauge("car_health_alerts", "alerts")
    reg.counter("other_total", "outside every family")
    return reg


@pytest.mark.parametrize("family", [None, *sorted(j_dash.FAMILIES)])
def test_dashboards_are_byte_equal(family):
    t = dash.generate_dashboard("t", registry=_fill(t_metrics),
                                family=family)
    j = j_dash.generate_dashboard("t", registry=_fill(j_metrics),
                                  family=family)
    assert json.dumps(t) == json.dumps(j)
    assert t["panels"]


def test_configmaps_are_byte_equal():
    assert dash.FAMILIES == j_dash.FAMILIES
    assert dash.dashboard_configmap(registry=_fill(t_metrics)) == \
        j_dash.dashboard_configmap(registry=_fill(j_metrics))


def test_the_module_prints_jax_configmap():
    out = {}
    for pkg in ("iotml_torch", "iotml"):
        run = subprocess.run([sys.executable, "-m", f"{pkg}.obs.dashboards"],
                             capture_output=True, text=True, timeout=300,
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert run.returncode == 0, run.stderr
        out[pkg] = run.stdout
    assert out["iotml_torch"] == out["iotml"]
    doc = json.loads(out["iotml_torch"])
    assert {"iotml.json", "iotml-broker.json", "iotml-ml.json"} <= \
        set(doc["data"])


def _stub(broker, connect: bool):
    p = types.SimpleNamespace(
        broker=broker, endpoints=lambda: {"kafka": "k"},
        sql=types.SimpleNamespace(queries={}, sources={}),
        mqtt_broker=types.SimpleNamespace(session_count=lambda: 3))
    if connect:
        p.connect = types.SimpleNamespace(_configs={})
    return p


def test_snapshot_topics_equal_jax():
    t, j = Broker(), JBroker()
    for b in (t, j):
        b.create_topic("a", partitions=3)
        b.create_topic("b", retention_messages=5)
        for i in range(40):
            b.produce("a", b"v%d" % i, key=b"k%d" % (i % 7))
            b.produce("b", b"w%d" % i)
    got = cc.ControlCenter(_stub(t, False)).snapshot()
    want = j_cc.ControlCenter(_stub(j, True)).snapshot()
    assert got["topics"] == want["topics"]
    assert {x["name"]: x["messages"] for x in got["topics"]} == \
        {"a": 40, "b": 5}
    for k in ("endpoints", "ksql", "connectors", "mqtt_sessions"):
        assert got[k] == want[k]


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.headers.get("Content-Type"), r.read()


def test_platform_serves_the_control_center():
    p = Platform(partitions=2, cc_port=0, device="cpu").start(metrics_port=0)
    try:
        p.broker.produce("sensor-data", b"x", partition=1)
        url = p.endpoints()["control-center"]
        assert url == p.control_center.url

        def topics():
            return {name: sum(p.broker.end_offset(name, q) -
                              p.broker.begin_offset(name, q)
                              for q in range(p.broker.topic(name).partitions))
                    for name in p.broker.topics()}

        # the KSQL task may still route the record (and create its DLQ
        # topic) while the answer is made: hold the answer to a count
        # that did not move across the GET, asking again until one holds
        for _ in range(100):
            before = topics()
            ctype, body = _get(url + "/api/status")
            want = topics()
            if want == before:
                break
            time.sleep(0.05)
        doc = json.loads(body)
        assert ctype == "application/json"
        assert want == before, "the platform's topics never settled"
        assert {t["name"]: t["messages"] for t in doc["topics"]} == want
        assert want["sensor-data"] == 1
        assert doc["endpoints"]["control-center"] == url
        assert len(doc["ksql"]["queries"]) == 3 and doc["connectors"] == []
        ctype, body = _get(url + "/")
        assert ctype.startswith("text/html")
        assert b"iotml control center" in body and b"sensor-data" in body
    finally:
        p.stop()
    assert Platform(device="cpu").control_center is None


def test_the_command_line_serves_the_control_center(monkeypatch):
    seen = {}
    real = up.Platform

    def platform(*a, **kw):
        seen["plat"] = real(*a, **kw)
        return seen["plat"]

    def sleep(_s):
        seen["endpoints"] = seen["plat"].endpoints()
        raise KeyboardInterrupt

    monkeypatch.setattr(up, "Platform", platform)
    monkeypatch.setattr(up, "time", types.SimpleNamespace(sleep=sleep))
    assert up.main(["--quiet", "--metrics-port", "0"], device="cpu") == 0
    assert seen["endpoints"]["control-center"].startswith("http://127.0.0.1:")


def _lines(path):
    with open(path) as fh:
        return [{k: v for k, v in json.loads(line).items()
                 if k != "wall_time"} for line in fh]


def test_scalar_logger_writes_jax_lines(tmp_path):
    hist = {"loss": [0.5, 0.25, 0.125], "accuracy": [0.1, 0.2],
            "seconds": [1.5, 1.25, 1.0]}
    for mod, d in ((t_tb, "t"), (j_tb, "j")):
        log = mod.ScalarLogger(str(tmp_path / d))
        log.history(hist)
        log.scalar("serve/rows", 30000, 7)
        log.close()
    got = _lines(tmp_path / "t" / "scalars.jsonl")
    assert got == _lines(tmp_path / "j" / "scalars.jsonl")
    assert len(got) == 9
    events = [p.name for p in (tmp_path / "t").iterdir()
              if p.name.startswith("events.out.tfevents")]
    assert len(events) == 1  # tensorboardX imports here
    log = ScalarLogger(str(tmp_path / "plain"), use_tensorboard=False)
    log.scalar("x", 1.0, 0)
    log.close()
    assert sorted(p.name for p in (tmp_path / "plain").iterdir()) == \
        ["scalars.jsonl"]


def test_torch_profiler_captures_a_window(tmp_path):
    import torch

    with TorchProfiler(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.capture.path and prof.capture.path.endswith(".pt.trace.json")
    assert (tmp_path / "prof").exists()
