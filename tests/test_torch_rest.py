"""The port's REST scaffold (``iotml_torch.utils.rest``) and thread
registry (``iotml_torch.supervise.registry``) held against the JAX
package's on the CPU.

Tolerances: exact.  The ``iotml_rest_*`` families: the same name, help
text, type and buckets; the same routes answer the same status codes,
content types and bodies (JSON, raw bytes, 204, 400 on a malformed body,
404 unmatched, a RestError's code, 500 on a handler's bug), and count
the same ``iotml_rest_requests_total`` deltas; past
``max_concurrency`` a connection is shed with a raw 503 before a handler
thread exists; ``IOTML_REST_MAX_CONCURRENCY`` is read and refused alike;
``register_thread`` refuses what JAX's refuses.  Every server binds
127.0.0.1:0 and is stopped by the test that starts it.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from iotml.obs import metrics as j_metrics
from iotml.supervise import registry as j_supervise
from iotml.utils import rest as j_rest
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.supervise import registry as t_supervise
from iotml_torch.utils import rest as t_rest


def _describe(m):
    return (type(m).__name__, m.name, m.help, getattr(m, "buckets", None))


def test_rest_families_equal_jax():
    for name in ("rest_requests", "rest_request_seconds"):
        assert _describe(getattr(t_rest, name)) == \
            _describe(getattr(j_rest, name))
    assert t_rest.DEFAULT_MAX_CONCURRENCY == j_rest.DEFAULT_MAX_CONCURRENCY
    # registered in each package's default registry
    for mod, metrics in ((t_rest, t_metrics), (j_rest, j_metrics)):
        assert metrics.default_registry._metrics[
            "iotml_rest_requests_total"] is mod.rest_requests


def _server(mod, name):
    srv = mod.RestServer(name=name)

    def boom(m, body):
        raise RuntimeError("route bug")

    def refuse(m, body):
        raise mod.RestError(409, f"conflict on {m.group(1)}")

    srv.route("GET", r"/echo/(\w+)", lambda m, body: (
        200, {"got": m.group(1), "body": body}))
    srv.route("POST", r"/echo/(\w+)", lambda m, body: (
        201, {"got": m.group(1), "body": body}))
    srv.route("PUT", r"/raw", lambda m, body: (
        200, b"a\nb\n", "application/x-ndjson"))
    srv.route("DELETE", r"/gone/(\w+)", lambda m, body: (204, None))
    srv.route("GET", r"/conflict/(\w+)", refuse)
    srv.route("GET", r"/boom", boom)
    return srv.start()


def _ask(srv, method, path, raw=None):
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=5)
    try:
        conn.request(method, path, raw,
                     {"Content-Type": "application/json"} if raw else {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


REQUESTS = [("GET", "/echo/abc", None), ("GET", "/echo/abc?x=1&y=2", None),
            ("POST", "/echo/q?x=1", b'{"x": 5, "z": [1]}'),
            ("POST", "/echo/q", b"{bad json"), ("PUT", "/raw", None),
            ("DELETE", "/gone/a", None), ("GET", "/conflict/k", None),
            ("GET", "/boom", None), ("GET", "/nowhere", None),
            ("POST", "/raw", None)]


def _deltas(metrics_mod, rest_mod, before):
    after = dict(rest_mod.rest_requests._vals)
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_routes_answer_and_count_as_jax():
    got, want = [], []
    for mod, metrics_mod, out in ((t_rest, t_metrics, got),
                                  (j_rest, j_metrics, want)):
        srv = _server(mod, "iotml-rest-parity")
        try:
            before = dict(mod.rest_requests._vals)
            answers = [_ask(srv, m, p, raw) for m, p, raw in REQUESTS]
            out.append(answers)
            # a handler counts after its reply is sent: wait for the last
            _await(lambda: sum(_deltas(metrics_mod, mod, before).values())
                   == len(REQUESTS), "every request counted")
            out.append(_deltas(metrics_mod, mod, before))
        finally:
            srv.stop()
    assert got == want
    codes = [a[0] for a in got[0]]
    assert codes == [200, 200, 201, 400, 200, 204, 409, 500, 404, 404]
    assert json.loads(got[0][2][2]) == {"got": "q",
                                        "body": {"x": 5, "z": [1]}}


def _await(pred, what, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


@pytest.mark.parametrize("mod", [t_rest, j_rest], ids=["port", "jax"])
def test_concurrency_guard_sheds_with_503(mod):
    """Both packages: two keep-alive connections hold both slots, the
    third is shed with a raw 503 (Connection: close) and counted under
    route "(guard)"; a freed slot readmits."""
    srv = mod.RestServer(name="iotml-rest-shed", max_concurrency=2)
    srv.route("GET", r"/ping", lambda m, body: (200, {"pong": True}))
    srv.start()
    held = []
    try:
        base = mod.rest_requests.value(route="(guard)", code=503)
        for _ in range(2):
            c = http.client.HTTPConnection(srv.host, srv.port, timeout=5)
            c.request("GET", "/ping")
            assert c.getresponse().read() == b'{"pong": true}'
            held.append(c)
        _await(lambda: srv.active_connections() == 2, "both slots held")
        names = [t.name for t in threading.enumerate()
                 if t.name.startswith("iotml-rest-shed-h")]
        assert len(names) == 2
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{srv.url}/ping", timeout=5)
        assert ei.value.code == 503
        assert ei.value.headers["Connection"] == "close"
        assert json.loads(ei.value.read()) == {
            "error_code": 503, "message": "connection limit reached, retry"}
        # the shed connection is counted after its 503 is sent
        _await(lambda: mod.rest_requests.value(route="(guard)", code=503)
               == base + 1, "the shed counted")
        held.pop().close()
        _await(lambda: srv.active_connections() == 1, "slot released")
        assert json.loads(urllib.request.urlopen(
            f"{srv.url}/ping", timeout=5).read()) == {"pong": True}
    finally:
        for c in held:
            c.close()
        srv.stop()


def test_port_handler_threads_are_registered():
    srv = t_rest.RestServer(name="iotml-rest-reg")
    srv.route("GET", r"/ping", lambda m, body: (200, {"pong": True}))
    srv.start()
    conn = http.client.HTTPConnection(srv.host, srv.port, timeout=5)
    try:
        conn.request("GET", "/ping")
        assert conn.getresponse().read() == b'{"pong": true}'
        names = {t.name for t in t_supervise.threads()}
        assert f"iotml-rest-{srv.port}" in names
        assert any(n.startswith("iotml-rest-reg-h") for n in names)
    finally:
        conn.close()
        srv.stop()


@pytest.mark.parametrize("raw", [None, "7", "zero", "0", "-3"])
def test_max_concurrency_env_equals_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("IOTML_REST_MAX_CONCURRENCY", raising=False)
    else:
        monkeypatch.setenv("IOTML_REST_MAX_CONCURRENCY", raw)
    outs = []
    for mod in (t_rest, j_rest):
        try:
            srv = mod.RestServer(name="iotml-rest-env")
        except ValueError as e:
            outs.append(("raise", str(e)))
            continue
        outs.append(srv.max_concurrency)
        srv.httpd.server_close()
    assert outs[0] == outs[1]


def _thread_outcome(mod, **kw):
    t = threading.Thread(target=lambda: None, **kw)
    try:
        mod.register_thread(t)
    except ValueError as e:
        return ("raise", str(e).replace(t.name, "<name>"))
    return ("ok", t.name)


@pytest.mark.parametrize("kw", [dict(daemon=True, name="iotml-x"),
                                dict(daemon=False, name="iotml-x"),
                                dict(daemon=True)],
                         ids=["named-daemon", "non-daemon", "unnamed"])
def test_register_thread_equals_jax(kw):
    got = _thread_outcome(t_supervise, **kw)
    want = _thread_outcome(j_supervise, **kw)
    # an unnamed thread's default name carries a process-wide counter
    assert got[0] == want[0] and (got[0] == "ok" or got == want)


def test_threads_and_supervisor_snapshot_equal_jax():
    class Sup:
        def __init__(self, units):
            self.units = units

        def snapshot(self):
            if self.units is None:
                raise RuntimeError("dying")
            return dict(self.units)

    outs = []
    for mod in (t_supervise, j_supervise):
        ev = threading.Event()
        t = mod.register_thread(threading.Thread(
            target=ev.wait, daemon=True, name="iotml-snap-worker"))
        t.start()
        live = [x.name for x in mod.threads()
                if x.name == "iotml-snap-worker"]
        sups = [Sup({"a": {"state": "up"}}), Sup(None),
                Sup({"b": {"state": "down"}})]
        for s in sups:
            mod.register_supervisor(s)
        snap = mod.snapshot()
        mod.unregister_supervisor(sups[0])
        snap2 = mod.snapshot()
        for s in sups[1:]:
            mod.unregister_supervisor(s)
        ev.set()
        t.join(timeout=5)
        outs.append((live, snap, snap2, mod.snapshot()))
    assert outs[0] == outs[1]
    assert outs[0][1] == {"a": {"state": "up"}, "b": {"state": "down"}}
