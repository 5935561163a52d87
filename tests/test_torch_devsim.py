"""The port's device-simulator CLI (``iotml_torch.cli.devsim``, the
reference's ``kubectl devsim`` verbs) held against the JAX package's.

- ``example`` prints the same bytes; ``run`` in-process and over
  ``--tcp`` prints the same summary (``wall_s`` aside) for the same
  scenario; ``--cap`` clamps alike.
- A detached job is a child process with its state directory: ``jobs``,
  ``show``, ``log`` and ``abort`` read and write that directory as the
  JAX CLI does, and each CLI lists the other's jobs.
- ``--metrics-port`` serves the agent families through the port's
  ``obs.metrics.start_http_server``.

Tolerance: none.  Every server binds 127.0.0.1:0 (the metrics server a
free port); each is stopped in a ``finally``.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from iotml.cli import devsim as j_devsim
from iotml.mqtt.broker import MqttBroker as JMqttBroker
from iotml.mqtt.eventserver import MqttEventServer as JMqttEventServer
from iotml_torch.cli import devsim
from iotml_torch.mqtt.broker import MqttBroker
from iotml_torch.mqtt.eventserver import MqttEventServer
from iotml_torch.obs import metrics as t_metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENARIOS = os.path.join(ROOT, "iotml_torch", "gen", "scenarios")
EVAL = os.path.join(SCENARIOS, "scenario_evaluation.xml")
FULL = os.path.join(SCENARIOS, "scenario.xml")


@pytest.fixture(autouse=True)
def state_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "devsim-state")
    monkeypatch.setenv(devsim.STATE_DIR_ENV, d)
    assert devsim.STATE_DIR_ENV == j_devsim.STATE_DIR_ENV
    return d


def _run(mod, capsys, argv):
    assert mod.main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    out.pop("wall_s")
    return out


def test_example_is_byte_identical(capsys):
    assert devsim.main(["example"]) == 0
    got = capsys.readouterr().out
    assert j_devsim.main(["example"]) == 0
    assert got == capsys.readouterr().out
    assert "<scenario>" in got


@pytest.mark.parametrize("argv", [
    ["run", "-s", EVAL],
    ["run", "--cap", "3", "-s", FULL],
    ["run", "--cap", "2", "--encoding", "avro", "-s", EVAL],
], ids=["evaluation", "full-capped", "avro-flag"])
def test_run_inproc_equal_jax(capsys, argv):
    got = _run(devsim, capsys, argv)
    assert got == _run(j_devsim, capsys, argv)
    assert got["published"] > 0
    assert sum(got["consumers"].values()) == got["published"]


def test_run_evaluation_counts(capsys):
    out = _run(devsim, capsys, ["run", "-s", EVAL])
    assert out["published"] == 1000  # 25 cars x 40 messages
    assert sum(out["consumers"].values()) == 1000


def test_run_over_tcp_equal_jax(capsys):
    """Both CLIs publish over MQTT TCP into the port's epoll front, and
    the JAX CLI into the JAX package's, with the same counts."""
    outs = []
    for server_cls, broker_cls, mod in (
            (MqttEventServer, MqttBroker, devsim),
            (MqttEventServer, MqttBroker, j_devsim),
            (JMqttEventServer, JMqttBroker, j_devsim)):
        broker = broker_cls()
        seen = []
        s = broker.connect("tap", lambda *a: seen.append(a))
        broker.deliver_pending(s)
        broker.subscribe("tap", "vehicles/#")
        srv = server_cls(broker).start()
        try:
            out = _run(mod, capsys, ["run", "--cap", "3", "--tcp",
                                     f"127.0.0.1:{srv.port}", "-s", EVAL])
        finally:
            srv.stop()
        outs.append((out, len(seen)))
    assert outs[0] == outs[1] == outs[2]
    assert outs[0][1] == outs[0][0]["published"] == 3 * 40


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_serves_the_agent_families(capsys, monkeypatch):
    servers = []
    real = t_metrics.start_http_server

    def start(port, *a, **kw):
        servers.append(real(port, *a, **kw))
        return servers[-1]

    monkeypatch.setattr(t_metrics, "start_http_server", start)
    port = _free_port()
    try:
        out = _run(devsim, capsys, ["run", "--cap", "2", "--metrics-port",
                                    str(port), "-s", EVAL])
        assert len(servers) == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            text = r.read().decode()
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
    assert out["published"] == 80
    assert "agent_publish_success_total" in text
    assert "agent_connect_success_total" in text


def _reap(pid):
    """Collect the detached child's exit status once it has ended (this
    process started it: unreaped, it would stay a zombie that answers
    kill(pid, 0) and reads as Running)."""
    try:
        os.waitpid(pid, os.WNOHANG)
    except ChildProcessError:
        pass


def _wait_state(mod, capsys, job, want, timeout=30.0):
    deadline = time.monotonic() + timeout
    state = None
    while time.monotonic() < deadline:
        mod.main(["show", job])
        meta = json.loads(capsys.readouterr().out)
        state = meta["state"]
        if state == want:
            return state
        _reap(meta["pid"])
        time.sleep(0.1)
    return state


def test_detach_jobs_show_log_abort(capsys, state_dir):
    rc = devsim.main(["run", "--detach", "--cap", "5", "--time-scale",
                      "0.5", "-s", FULL])
    assert rc == 0
    job = capsys.readouterr().out.strip()
    assert job.startswith("devsim-")
    try:
        assert devsim.main(["jobs"]) == 0
        listed = capsys.readouterr().out
        assert j_devsim.main(["jobs"]) == 0
        assert capsys.readouterr().out == listed  # one state directory
        assert job in listed
        assert devsim.main(["show", job]) == 0
        meta = json.loads(capsys.readouterr().out)
        assert meta["state"] in ("Running", "Completed")
        assert meta["scenario"] == FULL
    finally:
        assert devsim.main(["abort", job]) == 0
        assert capsys.readouterr().out.strip() == f"aborted {job}"
    assert _wait_state(devsim, capsys, job, "Aborted") == "Aborted"
    assert _wait_state(j_devsim, capsys, job, "Aborted") == "Aborted"
    meta = json.load(open(os.path.join(state_dir, job, "job.json")))
    pid = meta["pid"]
    deadline = time.monotonic() + 30
    while devsim._alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
        _reap(pid)
    assert not devsim._alive(pid)
    assert devsim.main(["log", job]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        devsim.main(["show", "devsim-nope"])


def test_detached_job_completes_and_logs_its_summary(capsys, state_dir):
    assert devsim.main(["run", "--detach", "-s", EVAL]) == 0
    job = capsys.readouterr().out.strip()
    assert _wait_state(devsim, capsys, job, "Completed", timeout=120) == \
        "Completed"
    assert devsim.main(["log", job]) == 0
    log = capsys.readouterr().out
    summary = json.loads(log.strip().splitlines()[-1])
    assert summary["published"] == 1000


def test_cli_entrypoint_runs_as_module():
    rc = subprocess.run(
        [sys.executable, "-m", "iotml_torch.cli.devsim", "example"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert rc.returncode == 0
    assert "<scenario>" in rc.stdout
