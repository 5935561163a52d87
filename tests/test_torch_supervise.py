"""The port's supervisor (``iotml_torch.supervise.supervisor``) against the
JAX package's, on the CPU.

The scripts of the JAX tests (``tests/test_supervise.py``: a crash and
its restart, a restart storm given up as degraded, a wedged unit replaced,
``on_death`` fired once, a probed unit restarted, a clean stop, a loop
returning normally) run on both packages without the monitor thread: the
test drives ``_tick_unit`` itself on a scripted clock, waits for each
spawned incarnation to crash or to reach its steady loop before the next
tick, and draws the backoff's jitter from a seeded generator.  The unit
states, restart counts, errors and backoff deadlines after every tick and
the ``iotml_supervisor_*`` counter deltas are equal.  Then the live
supervisor (its monitor thread on) fills ``supervise.registry.snapshot``
and ``/healthz``, as JAX's does.

Tolerance: none; every comparison is exact.
"""

import random
import threading
import time

import pytest

from iotml.obs import metrics as j_metrics
from iotml.supervise import supervisor as j_sup
from iotml.utils.backoff import ExpBackoff as JBackoff
from iotml_torch.obs import metrics as t_metrics
from iotml_torch.supervise import registry
from iotml_torch.supervise import supervisor as t_sup
from iotml_torch.utils.backoff import ExpBackoff as TBackoff

PACKAGES = {"torch": (t_sup, t_metrics, TBackoff),
            "jax": (j_sup, j_metrics, JBackoff)}


def _settle(unit, steady: threading.Event, timeout_s: float = 10.0):
    """Wait until the unit's newest incarnation has died or reached its
    steady loop (so the next tick sees a decided state)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        th = unit._thread
        if th is None or not th.is_alive() or steady.is_set():
            return
        time.sleep(0.001)
    raise AssertionError(f"unit {unit.name} never settled")


def _counters(metrics, name):
    return {"restarts": metrics.supervisor_restarts.value(unit=name),
            "wedged": metrics.supervisor_wedged.value(unit=name),
            "failovers": metrics.supervisor_failovers.value(unit=name),
            "degraded": metrics.supervisor_degraded.value(unit=name),
            "up": metrics.supervisor_unit_up.value(unit=name)}


def _run(pkg: str, script: str):
    mod, metrics, Backoff = PACKAGES[pkg]
    name = f"script-{script}"
    sup = mod.Supervisor(poll_interval_s=1.0, name=f"sup-{script}")
    steady, wedge = threading.Event(), threading.Event()
    runs, fired = [], []
    alive = {"ok": True}
    backoff = Backoff(base_s=0.05, cap_s=2.0, rng=random.Random(7))
    kw = {"backoff": backoff}

    def steady_loop(unit):
        steady.set()
        while not unit.should_stop():
            unit.heartbeat()
            unit._stop.wait(0.01)

    if script == "crash":
        def loop(unit):
            runs.append(1)
            if len(runs) <= 2:
                raise RuntimeError(f"incarnation {len(runs)} dies")
            steady_loop(unit)
        u = sup.add_loop(name, loop, **kw)
    elif script == "storm":
        def loop(unit):
            runs.append(1)
            raise RuntimeError("always dies")
        u = sup.add_loop(name, loop, max_restarts=3, restart_window_s=300.0,
                         **kw)
    elif script == "wedge":
        def loop(unit):
            runs.append(1)
            unit.heartbeat()
            if len(runs) == 1:
                steady.set()
                while not unit.should_stop():  # alive and silent
                    wedge.wait(0.01)
                return
            steady_loop(unit)
        u = sup.add_loop(name, loop, heartbeat_timeout_s=5.0, **kw)
    elif script == "finite":
        u = sup.add_loop(name, lambda unit: unit.heartbeat(), **kw)
    elif script == "on_death":
        u = sup.add_probed(name, lambda: alive["ok"], on_death=fired.append,
                           probe_failures=2, **kw)
    elif script == "probe_restart":
        def restart():
            runs.append(1)
            alive["ok"] = True
        u = sup.add_probed(name, lambda: alive["ok"], restart=restart,
                           probe_failures=2, **kw)
    else:
        raise AssertionError(script)

    before = _counters(metrics, name)
    trace = []
    # a probed unit's restart is stamped on the real clock: the scripted
    # clock starts there, and only a loop unit's deadline is compared
    base = time.monotonic()

    def tick(now):
        sup._tick_unit(u, now)
        _settle(u, steady)
        trace.append((u.state, u.restarts, u.last_error,
                      round(u._next_start_at - base, 9)
                      if u.state == mod.WAITING and u.loop is not None
                      else None,
                      u.backoff.attempt))

    try:
        if u.loop is not None:
            u._spawn()  # what start() does, without the monitor
            _settle(u, steady)
        else:
            u.state = mod.RUNNING
        if script == "wedge":
            now = base
            tick(now)                  # fresh heartbeat: running
            steady.clear()
            tick(now + 100.0)          # silent past its timeout: wedged
            tick(now + 200.0)          # the backoff passed: replaced
            tick(time.monotonic())     # the new incarnation beats
        elif script in ("on_death", "probe_restart"):
            for k in range(7):
                if k == 2:
                    alive["ok"] = False
                tick(base + 10.0 * k)
        else:
            for k in range(8):
                tick(base + 10.0 * k)
    finally:
        wedge.set()
        sup.stop(join_timeout_s=5.0)
    after = _counters(metrics, name)
    delta = {k: after[k] - before[k] for k in after}
    return {"trace": trace, "final": u.state, "runs": len(runs),
            "fired": [f.name for f in fired], "delta": delta}


@pytest.mark.parametrize("script", ["crash", "storm", "wedge", "finite",
                                    "on_death", "probe_restart"])
def test_scripted_sequences_equal_jax(script):
    got, want = _run("torch", script), _run("jax", script)
    assert got == want
    expect = {"crash": ("running", 2), "storm": ("degraded", 3),
              "wedge": ("running", 1), "finite": ("stopped", 0),
              "on_death": ("failed_over", 0),
              "probe_restart": ("running", 1)}[script]
    last = got["trace"][-1]
    assert (last[0], last[1]) == expect
    if script == "on_death":
        assert got["fired"] == [f"script-{script}"]
        assert got["delta"]["failovers"] == 1
    if script == "storm":
        assert got["delta"]["degraded"] == 1 and got["runs"] == 4
    if script == "wedge":
        assert got["delta"]["wedged"] == 1


def test_unit_states_and_constructor_checks_equal_jax():
    for name in ("IDLE", "RUNNING", "CRASHED", "WAITING", "DEGRADED",
                 "FAILED_OVER", "STOPPED"):
        assert getattr(t_sup, name) == getattr(j_sup, name)
    for mod in (t_sup, j_sup):
        with pytest.raises(ValueError, match="exactly one of"):
            mod.SupervisedUnit("x")
        sup = mod.Supervisor(poll_interval_s=1.0)
        sup.add_loop("dup", lambda u: None)
        with pytest.raises(ValueError, match="duplicate unit"):
            sup.add_loop("dup", lambda u: None)


def test_env_knobs_read_at_construction(monkeypatch):
    monkeypatch.setenv("IOTML_SUPERVISE_MAX_RESTARTS", "9")
    monkeypatch.setenv("IOTML_SUPERVISE_POLL_S", "0.25")
    for mod in (t_sup, j_sup):
        assert mod.SupervisedUnit("u", lambda u: None).max_restarts == 9
        assert mod.Supervisor().poll_interval_s == 0.25


def test_live_supervisor_fills_the_registry_and_healthz():
    """With its monitor on, a degraded unit reaches
    ``registry.snapshot()`` and turns ``/healthz`` degraded; stop()
    unregisters the supervisor."""
    def loop(unit):
        raise RuntimeError("always dies")

    sup = t_sup.Supervisor(poll_interval_s=0.01, name="torch-live-sup")
    u = sup.add_loop("torch-doomed", loop, max_restarts=2,
                     restart_window_s=30.0,
                     backoff=TBackoff(base_s=0.01, cap_s=0.02))
    sup.start()
    try:
        deadline = time.monotonic() + 10
        while u.state != t_sup.DEGRADED and time.monotonic() < deadline:
            time.sleep(0.01)
        assert u.state == t_sup.DEGRADED and u.restarts == 2
        snap = registry.snapshot()
        assert snap["torch-doomed"]["state"] == "degraded"
        doc = t_metrics._healthz_doc()
        assert doc["status"] == "degraded"
        assert doc["supervisor"]["torch-doomed"]["restarts"] == 2
        assert sup.degraded() == ["torch-doomed"]
        assert any(t.name == "iotml-torch-live-sup"
                   for t in registry.threads())
    finally:
        sup.stop()
    assert "torch-doomed" not in registry.snapshot()
