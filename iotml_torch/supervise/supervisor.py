"""Supervisor — owned lifecycles for the platform's moving parts
(``iotml.supervise.supervisor``'s copy).

The reference gets self-healing for free from Kubernetes: every
component is a Deployment whose pods are probed, restarted, and backed
off by the kubelet (SURVEY §2.6/§2.7).  The rebuild's ``Platform``
brought the *services* in-process but launched them fire-and-forget —
a crashed scorer thread or a wedged bridge simply went dark.  This
module is the kubelet-equivalent for in-process components:

- a ``SupervisedUnit`` wraps either a *loop* (a callable driven on an
  owned, named, daemon thread — restarted when it crashes or wedges) or
  a *probed external* (a server whose liveness is a probe callable —
  its death triggers an ``on_death`` hook, e.g. leader failover);
- liveness is three signals, cheapest first: thread aliveness,
  per-unit heartbeats (``unit.heartbeat()`` from inside the loop), and
  the trace collector's stage-liveness ages (``obs.tracing.liveness()``)
  for units that declare the trace stage they keep fresh;
- restarts run under the stream stack's ``ExpBackoff`` with a
  restart-storm budget: more than ``max_restarts`` within
  ``restart_window_s`` and the supervisor GIVES UP — the unit enters
  ``degraded`` (surfaced via ``iotml_supervisor_*`` metrics and
  ``/healthz``) instead of burning a core on a crash loop.

The supervisor never force-kills a thread (Python cannot); a wedged
loop is asked to stop via its stop event, and a replacement is started
regardless — the old daemon thread stays visible in the registry until
it exits.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Deque, Dict, List, Optional

from ..obs import metrics as obs_metrics
from ..utils.backoff import ExpBackoff
from . import registry

# unit states (strings, not an enum: they land in JSON snapshots)
IDLE = "idle"
RUNNING = "running"
CRASHED = "crashed"
WAITING = "waiting_backoff"
DEGRADED = "degraded"
FAILED_OVER = "failed_over"
STOPPED = "stopped"


class SupervisedUnit:
    """One supervised component.

    Exactly one of ``loop`` / ``probe`` must be given:

    loop(unit):
        The unit's body, run on an owned daemon thread.  It should call
        ``unit.heartbeat()`` each round and exit when
        ``unit.should_stop()`` — returning normally is a clean stop, an
        escaping exception is a crash (recorded, restarted under
        backoff).
    probe():
        Liveness check for an EXTERNAL component (a wire server, a
        peer process).  ``probe_failures`` consecutive False/raising
        probes mark the unit dead; then ``on_death(unit)`` fires once
        (leader failover lives here) or, if ``restart`` was given,
        the component is restarted under the same backoff/budget.
    """

    def __init__(self, name: str, loop: Optional[Callable] = None, *,
                 probe: Optional[Callable[[], bool]] = None,
                 restart: Optional[Callable[[], None]] = None,
                 on_death: Optional[Callable[["SupervisedUnit"], None]] = None,
                 heartbeat_timeout_s: Optional[float] = None,
                 stage: Optional[str] = None, stage_timeout_s: float = 5.0,
                 probe_failures: int = 3,
                 max_restarts: Optional[int] = None,
                 restart_window_s: float = 30.0,
                 backoff: Optional[ExpBackoff] = None):
        if max_restarts is None:
            # IOTML_SUPERVISE_MAX_RESTARTS: fleet-wide restart-storm
            # budget override (in config.py's non_config set — a harness
            # knob, not pipeline config); read at construction so tests
            # can monkeypatch the environment
            max_restarts = int(os.environ.get(
                "IOTML_SUPERVISE_MAX_RESTARTS", "5"))
        if (loop is None) == (probe is None):
            raise ValueError(
                f"unit {name!r}: exactly one of loop= (owned thread) or "
                f"probe= (external liveness) is required")
        self.name = name
        self.loop = loop
        self.probe = probe
        self.restart_fn = restart
        self.on_death = on_death
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.stage = stage
        self.stage_timeout_s = stage_timeout_s
        self.probe_failures = probe_failures
        self.max_restarts = max_restarts
        self.restart_window_s = restart_window_s
        self.backoff = backoff or ExpBackoff(base_s=0.05, cap_s=2.0)

        self.state = IDLE
        self.restarts = 0
        self.last_error: Optional[str] = None
        self._stop = threading.Event()
        self._clean_exit = False
        self._thread: Optional[threading.Thread] = None
        self._beat = time.monotonic()
        self._probe_misses = 0
        self._restart_times: Deque[float] = collections.deque()
        self._next_start_at = 0.0  # monotonic deadline while WAITING

    # ----------------------------------------------------- loop-side API
    def heartbeat(self) -> None:
        """Called by the unit's own loop each healthy round."""
        self._beat = time.monotonic()

    def should_stop(self) -> bool:
        if self._stop.is_set():
            return True
        # incarnation fencing: a wedged thread that was already REPLACED
        # must see stop=True forever, even though _spawn cleared the
        # shared event for the new incarnation — otherwise an unwedged
        # zombie would resume its loop beside its replacement and
        # double-drive the unit's work
        cur = threading.current_thread()
        return cur.name.startswith("iotml-unit-") and cur is not self._thread

    # ------------------------------------------------------- introspect
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def to_dict(self) -> dict:
        return {"state": self.state, "restarts": self.restarts,
                "last_error": self.last_error,
                "beat_age_s": round(time.monotonic() - self._beat, 3)}

    # ---------------------------------------------------------- internal
    def _spawn(self) -> None:
        unit = self

        def body():
            try:
                unit.loop(unit)
                unit._clean_exit = True  # returning normally is a clean
                # stop per the class contract, stop event or not
            except Exception as e:  # noqa: BLE001 - ANY escaping
                # exception is a crash by definition; the monitor (not
                # this dying thread) decides restart vs give-up
                unit.last_error = f"{type(e).__name__}: {e}"

        self._clean_exit = False
        self._stop.clear()
        self._beat = time.monotonic()
        self._thread = registry.register_thread(
            threading.Thread(target=body, daemon=True,
                             name=f"iotml-unit-{self.name}"))
        # state flips BEFORE the thread starts: an observer that sees
        # alive() true must never read a stale IDLE (a /healthz scrape
        # landing between start() and a later assignment did exactly
        # that under load).  If the body crashes instantly, the monitor
        # sees RUNNING + dead thread — the normal restart path.
        self.state = RUNNING
        self._thread.start()

    def _budget_exhausted(self, now: float) -> bool:
        while self._restart_times and \
                now - self._restart_times[0] > self.restart_window_s:
            self._restart_times.popleft()
        return len(self._restart_times) >= self.max_restarts


class Supervisor:
    """Monitor thread over registered units.

    ``start()`` runs the monitor; each tick walks every unit and applies
    the decision table (dead → backoff-restart or give-up; wedged →
    stop + replace; probe-dead external → on_death/restart).  The
    supervisor registers itself so ``/healthz`` picks up ``snapshot()``
    from any process with a metrics server."""

    def __init__(self, poll_interval_s: Optional[float] = None,
                 name: str = "supervisor"):
        self.name = name
        if poll_interval_s is None:
            # IOTML_SUPERVISE_POLL_S: monitor cadence override (see
            # max_restarts note above)
            poll_interval_s = float(os.environ.get(
                "IOTML_SUPERVISE_POLL_S", "0.05"))
        self.poll_interval_s = poll_interval_s
        self._units: Dict[str, SupervisedUnit] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------ registration
    def add(self, unit: SupervisedUnit) -> SupervisedUnit:
        with self._lock:
            if unit.name in self._units:
                raise ValueError(f"duplicate unit {unit.name!r}")
            self._units[unit.name] = unit
        obs_metrics.supervisor_unit_up.set(0, unit=unit.name)
        return unit

    def add_loop(self, name: str, loop: Callable, **kw) -> SupervisedUnit:
        return self.add(SupervisedUnit(name, loop, **kw))

    def add_probed(self, name: str, probe: Callable[[], bool],
                   **kw) -> SupervisedUnit:
        return self.add(SupervisedUnit(name, probe=probe, **kw))

    def unit(self, name: str) -> SupervisedUnit:
        with self._lock:
            return self._units[name]

    def units(self) -> List[SupervisedUnit]:
        with self._lock:
            return list(self._units.values())

    # -------------------------------------------------------- lifecycle
    def start(self) -> "Supervisor":
        for u in self.units():
            if u.loop is not None and u.state == IDLE:
                u._spawn()
            elif u.probe is not None and u.state == IDLE:
                u.state = RUNNING
        self._stop.clear()
        self._thread = registry.register_thread(
            threading.Thread(target=self._monitor, daemon=True,
                             name=f"iotml-{self.name}"))
        self._thread.start()
        registry.register_supervisor(self)
        return self

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=join_timeout_s)
        for u in self.units():
            u._stop.set()
        for u in self.units():
            if u._thread is not None:
                u._thread.join(timeout=join_timeout_s)
            if u.state in (RUNNING, WAITING, CRASHED):
                u.state = STOPPED
            obs_metrics.supervisor_unit_up.set(0, unit=u.name)
        registry.unregister_supervisor(self)

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------- monitoring
    def snapshot(self) -> Dict[str, dict]:
        return {u.name: u.to_dict() for u in self.units()}

    def degraded(self) -> List[str]:
        return [u.name for u in self.units() if u.state == DEGRADED]

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            now = time.monotonic()
            for u in self.units():
                try:
                    self._tick_unit(u, now)
                except Exception as e:  # noqa: BLE001 - one unit's
                    # broken probe must not stop supervision of the rest
                    u.last_error = f"monitor: {type(e).__name__}: {e}"

    def _tick_unit(self, u: SupervisedUnit, now: float) -> None:
        if u.state in (DEGRADED, FAILED_OVER, STOPPED):
            return
        if u.state == IDLE:
            # registered after start(): bring it up on the next tick
            if u.loop is not None:
                u._spawn()
            else:
                u.state = RUNNING
            return
        if u.state == WAITING:
            if now >= u._next_start_at:
                if u.loop is not None:
                    u._spawn()
                    obs_metrics.supervisor_unit_up.set(1, unit=u.name)
                else:
                    # deferred EXTERNAL restart: optimistic RUNNING —
                    # if the component is still down, the probe path
                    # re-detects and the budget/backoff still bound it
                    try:
                        u.restart_fn()
                        u._probe_misses = 0
                        u.state = RUNNING
                    except Exception as e:  # noqa: BLE001 - failed
                        # restart is just the next probe miss
                        u.last_error = f"restart: {type(e).__name__}: {e}"
                        u.state = RUNNING
            return
        if u.loop is not None:
            self._tick_loop_unit(u, now)
        else:
            self._tick_probed_unit(u)

    # --------------------------------------------------- loop unit rules
    def _tick_loop_unit(self, u: SupervisedUnit, now: float) -> None:
        dead = not u.alive()
        wedged = (not dead and u.heartbeat_timeout_s is not None
                  and now - u._beat > u.heartbeat_timeout_s)
        if not dead and not wedged and u.stage is not None:
            wedged = self._stage_stalled(u)
        if not dead and not wedged:
            obs_metrics.supervisor_unit_up.set(1, unit=u.name)
            if u.backoff.attempt and (
                    not u._restart_times
                    or now - u._restart_times[-1] > u.restart_window_s):
                u.backoff.reset()  # stable since the last restart
            return
        if dead and (u._stop.is_set() or u._clean_exit):
            u.state = STOPPED  # clean shutdown OR the loop returning
            return             # normally (finite work done) — not a crash
        if wedged:
            # cannot kill a Python thread: ask it to stop and replace it;
            # the old thread stays visible in the registry until it exits
            u.last_error = u.last_error or \
                f"wedged: no heartbeat for {u.heartbeat_timeout_s}s"
            u._stop.set()
            obs_metrics.supervisor_wedged.inc(unit=u.name)
        self._restart_or_give_up(u, now)

    def _stage_stalled(self, u: SupervisedUnit) -> bool:
        """Trace stage liveness as a probe: the unit's trace stage going
        stale while the unit claims to run means the pipeline behind it
        stopped moving.  Only meaningful when tracing is on AND the
        stage has reported at least once."""
        from ..obs import tracing

        if not tracing.ENABLED:
            return False
        age = tracing.liveness().get(u.stage)
        return age is not None and age > u.stage_timeout_s

    # ------------------------------------------------- probed unit rules
    def _tick_probed_unit(self, u: SupervisedUnit) -> None:
        try:
            ok = bool(u.probe())
        except Exception as e:  # noqa: BLE001 - an unreachable server
            # raises; that IS the negative probe result
            ok = False
            u.last_error = f"probe: {type(e).__name__}: {e}"
        if ok:
            u._probe_misses = 0
            obs_metrics.supervisor_unit_up.set(1, unit=u.name)
            return
        u._probe_misses += 1
        if u._probe_misses < u.probe_failures:
            return
        obs_metrics.supervisor_unit_up.set(0, unit=u.name)
        if u.on_death is not None:
            # the failover hook fires ONCE; re-admission of a recovered
            # peer is an operator action, not a supervisor guess
            u.state = FAILED_OVER
            hook, u.on_death = u.on_death, None
            obs_metrics.supervisor_failovers.inc(unit=u.name)
            hook(u)
            return
        if u.restart_fn is not None:
            self._restart_or_give_up(u, time.monotonic())
        else:
            u.state = CRASHED

    # ----------------------------------------------------------- restart
    def _restart_or_give_up(self, u: SupervisedUnit, now: float) -> None:
        """Both unit kinds restart through the same WAITING/backoff
        state — an immediate external retry would burn the whole storm
        budget in probe_failures × poll_interval (sub-second) and park
        a transiently-down service in DEGRADED forever."""
        obs_metrics.supervisor_unit_up.set(0, unit=u.name)
        if u._budget_exhausted(now):
            u.state = DEGRADED
            obs_metrics.supervisor_degraded.set(1, unit=u.name)
            return
        u._restart_times.append(now)
        u.restarts += 1
        obs_metrics.supervisor_restarts.inc(unit=u.name)
        u.state = WAITING
        u._next_start_at = now + u.backoff.next_delay()
