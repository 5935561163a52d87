"""Runtime lock-order & race detector — instrumented ``threading`` locks.

The port's copy of the JAX package's ``analysis/lockcheck.py``, watching
the port's stream layer.  It patches ``threading.Lock`` as the JAX one
does, so a process installs one of the two, never both: ``install()``
raises when the JAX package's detector is live in the process.

``install()`` monkeypatches ``threading.Lock``/``threading.RLock`` with a
checking wrapper (no ``sys.setprofile`` — zero per-bytecode overhead, the
cost rides only on lock operations) and instruments the stream layer's
shared state.  While installed it records:

- the **lock-acquisition graph**: lock identity is the *allocation site*
  (file:line of the ``threading.Lock()`` call — lockdep's lock-class
  idea), nodes are sites, and an edge A→B means some thread acquired B
  while holding A.  A path B→…→A at edge-insert time is a lock-order
  **cycle** — deadlock potential, reported as a violation (the pytest
  plugin fails the run on these).
- **blocking I/O under a lock**: ``time.sleep`` and ``socket`` recv/
  accept while any checked lock is held (warning: a stalled peer parks
  every contender).
- **unguarded shared-state mutation**: dicts registered via ``watch()``
  (the ``Broker``'s ``_topics``/``_parts``/``_group_offsets``, the
  ``GroupCoordinator``'s ``_heartbeats``/``_subscriptions``/
  ``_assignments`` that every ``GroupConsumer`` joins through, the
  ``FollowerReplica``'s ``_parts`` cursors) flag mutations made without
  their guarding lock held — or, for owner-thread state, from a thread
  other than the first mutator.

Scope: only locks *created after* ``install()`` are checked (the stream
stack creates its locks per-object in ``__init__``, so installing before
the system under test is constructed — the pytest plugin's timing —
covers everything).  ``uninstall()`` restores the patched names and
returns the final ``State`` for inspection.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_SLEEP = time.sleep
_ALLOC = __import__("_thread").allocate_lock

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))


class Violation:
    """One detected problem.  ``kind`` is 'cycle' | 'io-under-lock' |
    'unguarded-mutation'; only cycles fail a checked run."""

    __slots__ = ("kind", "message", "thread")

    def __init__(self, kind: str, message: str):
        self.kind = kind
        self.message = message
        self.thread = threading.current_thread().name

    def __repr__(self) -> str:
        return f"[{self.kind}] ({self.thread}) {self.message}"


class State:
    """Collected graph + findings; internal mutation guarded by a RAW
    lock (never a checked one — the checker must not check itself)."""

    def __init__(self):
        self._mu = _ALLOC()
        self.edges: Dict[Tuple[str, str], str] = {}   # (a, b) -> example site
        self.graph: Dict[str, Set[str]] = {}
        self.violations: List[Violation] = []
        self._seen: Set[str] = set()  # dedup key per violation

    # ------------------------------------------------------------ record
    def record_edge(self, held_site: str, new_site: str,
                    acquire_at: str) -> None:
        if held_site == new_site:
            return  # two instances of one lock class: no order info
        with self._mu:
            known = (held_site, new_site) in self.edges
            if not known:
                self.edges[(held_site, new_site)] = acquire_at
                self.graph.setdefault(held_site, set()).add(new_site)
            if known:
                return
            path = self._path(new_site, held_site)
        if path is not None:
            cycle = " -> ".join([held_site, new_site] + path[1:])
            self.add("cycle",
                     f"lock-order cycle: {cycle} (edge added at "
                     f"{acquire_at}); opposite-order acquisition can "
                     f"deadlock", key=f"cycle:{held_site}|{new_site}")

    def preseed_static(self, edges) -> int:
        """Insert statically-derived acquire-order edges (analysis
        .lockorder) so runtime acquisitions are checked against orders
        the code can express even when this run never executes them.
        A cycle already present among the seeded edges is reported as
        kind 'static-cycle' (a warning unless strict mode promotes it);
        a RUNTIME edge that later closes a cycle through seeded edges
        fails via the ordinary ``record_edge`` detection."""
        n = 0
        for a, b, where in edges:
            if a == b:
                continue
            with self._mu:
                if (a, b) in self.edges:
                    continue
                path = self._path(b, a)
                self.edges[(a, b)] = f"static:{where}"
                self.graph.setdefault(a, set()).add(b)
            n += 1
            if path is not None:
                cycle = " -> ".join([a, b] + path[1:])
                self.add("static-cycle",
                         f"statically-derived lock-order cycle: {cycle} "
                         f"(edge from source at {where}); opposite-order "
                         f"acquisition paths both exist in the code",
                         key=f"static-cycle:{a}|{b}")
        return n

    def _path(self, src: str, dst: str) -> Optional[List[str]]:
        """DFS path src→dst in the order graph (caller holds _mu)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self.graph.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def add(self, kind: str, message: str,
            key: Optional[str] = None) -> None:
        key = key or f"{kind}:{message}"
        with self._mu:
            if key in self._seen:
                return
            self._seen.add(key)
            self.violations.append(Violation(kind, message))

    # ----------------------------------------------------------- inspect
    def cycles(self) -> List[Violation]:
        return [v for v in self.violations if v.kind == "cycle"]

    def warnings(self) -> List[Violation]:
        return [v for v in self.violations if v.kind != "cycle"]

    def report(self) -> str:
        lines = [f"lockcheck: {len(self.edges)} lock-order edges, "
                 f"{len(self.cycles())} cycles, "
                 f"{len(self.warnings())} warnings"]
        lines += [f"  {v!r}" for v in self.violations]
        return "\n".join(lines)


_state: Optional[State] = None
_held = threading.local()  # .stack: List[CheckedLockBase] per thread


def _held_stack() -> list:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _caller_site(depth: int = 2) -> str:
    """file:line of the first frame outside this module."""
    f = sys._getframe(depth)
    while f is not None and \
            os.path.dirname(f.f_code.co_filename) == _THIS_DIR:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _site_of_creation() -> str:
    f = sys._getframe(2)
    while f is not None and \
            os.path.dirname(f.f_code.co_filename) == _THIS_DIR:
        f = f.f_back
    if f is None:
        return "<unknown>"
    rel = f.f_code.co_filename
    parts = rel.replace(os.sep, "/").split("/")
    short = "/".join(parts[-2:])
    return f"{short}:{f.f_lineno}"


class CheckedLockBase:
    """Common acquire/release bookkeeping over a real lock."""

    _reentrant = False

    def __init__(self, real, site: str):
        self._real = real
        self._site = site

    # ----------------------------------------------------------- acquire
    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = _state
        stack = _held_stack()
        if st is not None and blocking:
            already = any(h is self for h in stack)
            if not already:
                at = _caller_site()
                for h in stack:
                    st.record_edge(h._site, self._site, at)
        got = self._real.acquire(blocking, timeout)  # lint-ok: R3 the wrapper IS the context manager; this is the delegated primitive
        if got:
            stack.append(self)
        return got

    def release(self):
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._real.release()

    def __enter__(self):
        self.acquire()  # lint-ok: R3 context-manager protocol itself
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._real.locked()

    def _at_fork_reinit(self):
        # concurrent.futures/threading call this in fork children; the
        # child is single-threaded so the held stack needs no repair
        self._real._at_fork_reinit()

    def held_by_current_thread(self) -> bool:
        return any(h is self for h in _held_stack())

    def __repr__(self):
        return f"<{type(self).__name__} site={self._site}>"


class CheckedLock(CheckedLockBase):
    pass


class CheckedRLock(CheckedLockBase):
    _reentrant = True

    # threading.Condition integration: these three let a Condition built
    # on a checked RLock fully release/restore it around wait(), keeping
    # the held-stack truthful while the thread is parked.
    def _is_owned(self):
        return self._real._is_owned()

    def _release_save(self):
        stack = _held_stack()
        count = 0
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                count += 1
        return (self._real._release_save(), count)

    def _acquire_restore(self, saved):
        real_state, count = saved
        self._real._acquire_restore(real_state)
        _held_stack().extend([self] * count)


def _make_lock():
    if _state is None:
        return _REAL_LOCK()
    return CheckedLock(_REAL_LOCK(), _site_of_creation())


def _make_rlock():
    if _state is None:
        return _REAL_RLOCK()
    return CheckedRLock(_REAL_RLOCK(), _site_of_creation())


# ----------------------------------------------------------- I/O probes
def _flag_io(what: str) -> None:
    st = _state
    if st is None:
        return
    stack = _held_stack()
    if not stack:
        return
    sites = ", ".join(h._site for h in stack)
    at = _caller_site()
    st.add("io-under-lock",
           f"{what} at {at} while holding [{sites}]: a stalled peer parks "
           f"every thread contending these locks",
           key=f"io:{what}:{at}:{sites}")


def _checked_sleep(seconds):
    _flag_io("time.sleep")
    return _REAL_SLEEP(seconds)


def _patch_socket_probes(install: bool) -> None:
    # socket.socket is the pure-Python subclass of _socket.socket, so a
    # shadowing class attribute is enough — and removable.
    if install:
        real_recv = socket.socket.recv
        real_accept = socket.socket.accept

        def recv(self, *a, **k):
            _flag_io("socket.recv")
            return real_recv(self, *a, **k)

        def accept(self):
            _flag_io("socket.accept")
            return real_accept(self)

        recv._lockcheck = accept._lockcheck = True  # type: ignore
        socket.socket.recv = recv      # type: ignore[method-assign]
        socket.socket.accept = accept  # type: ignore[method-assign]
    else:
        for name in ("recv", "accept"):
            fn = socket.socket.__dict__.get(name)
            if fn is not None and getattr(fn, "_lockcheck", False):
                if name == "recv":
                    del socket.socket.recv    # fall back to C method
                else:
                    socket.socket.accept = _PY_SOCKET_ACCEPT


_PY_SOCKET_ACCEPT = socket.socket.accept  # the stdlib Python-level accept


# ------------------------------------------------- shared-state watching
class WatchedDict(dict):
    """dict that flags mutations made without the guard.

    guard = a checked lock  → mutation requires it held by this thread;
    guard = None (owner mode) → first mutating thread becomes the owner,
    mutations from any other thread are flagged.  Reads are never
    checked (torn reads are the reader's lock discipline, flagged where
    the mutation happens)."""

    def __init__(self, data, label: str, lock=None):
        super().__init__(data)
        self._lc_label = label
        self._lc_lock = lock if isinstance(lock, CheckedLockBase) else None
        self._lc_owner: Optional[int] = None

    def _lc_check(self):
        st = _state
        if st is None:
            return
        if self._lc_lock is not None:
            if not self._lc_lock.held_by_current_thread():
                st.add("unguarded-mutation",
                       f"{self._lc_label} mutated at {_caller_site()} "
                       f"without holding {self._lc_lock._site}",
                       key=f"mut:{self._lc_label}:{_caller_site()}")
        else:
            me = threading.get_ident()
            if self._lc_owner is None:
                self._lc_owner = me
            elif self._lc_owner != me:
                st.add("unguarded-mutation",
                       f"{self._lc_label} mutated at {_caller_site()} from "
                       f"non-owner thread "
                       f"{threading.current_thread().name}",
                       key=f"mut:{self._lc_label}:{_caller_site()}")

    def __setitem__(self, k, v):
        self._lc_check()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._lc_check()
        super().__delitem__(k)

    def pop(self, *a):
        self._lc_check()
        return super().pop(*a)

    def popitem(self):
        self._lc_check()
        return super().popitem()

    def clear(self):
        self._lc_check()
        super().clear()

    def update(self, *a, **k):
        self._lc_check()
        super().update(*a, **k)

    def setdefault(self, k, default=None):
        if k not in self:
            self._lc_check()
        return super().setdefault(k, default)


def watch(obj, attr: str, lock=None, label: Optional[str] = None) -> None:
    """Replace ``obj.attr`` (a dict) with a mutation-checking wrapper.
    No-op when lockcheck is not installed or the attr is already
    watched."""
    if _state is None:
        return
    cur = getattr(obj, attr)
    if isinstance(cur, WatchedDict) or not isinstance(cur, dict):
        return
    setattr(obj, attr, WatchedDict(
        cur, label or f"{type(obj).__name__}.{attr}", lock=lock))


_instrumented = False


def _instrument_stream_layer() -> None:
    """Wrap the stream layer's constructors so every instance created
    under lockcheck gets its shared tables watched.  Idempotent; the
    wrappers are no-ops when lockcheck is not installed."""
    global _instrumented
    if _instrumented:
        return
    _instrumented = True

    def after_init(cls, register):
        orig = cls.__init__

        def __init__(self, *a, **k):
            orig(self, *a, **k)
            if _state is not None:
                register(self)

        __init__.__wrapped__ = orig  # type: ignore[attr-defined]
        cls.__init__ = __init__

    try:
        from ..stream.broker import Broker

        after_init(Broker, lambda b: (
            watch(b, "_topics", lock=b._lock, label="Broker._topics"),
            watch(b, "_parts", lock=b._lock, label="Broker._parts"),
            watch(b, "_group_offsets", lock=b._lock,
                  label="Broker._group_offsets")))
    except Exception:  # pragma: no cover - import cycles in exotic setups
        pass
    try:
        from ..stream.group import GroupCoordinator

        after_init(GroupCoordinator, lambda g: (
            watch(g, "_heartbeats", lock=g._lock,
                  label="GroupCoordinator._heartbeats"),
            watch(g, "_subscriptions", lock=g._lock,
                  label="GroupCoordinator._subscriptions"),
            watch(g, "_assignments", lock=g._lock,
                  label="GroupCoordinator._assignments")))
    except Exception:  # pragma: no cover
        pass
    try:
        from ..stream.replica import FollowerReplica

        after_init(FollowerReplica, lambda r: watch(
            r, "_parts", label="FollowerReplica._parts"))
    except Exception:  # pragma: no cover
        pass


# ------------------------------------------------------------ lifecycle
def _foreign_detector_live() -> bool:
    """True when the JAX package's lockcheck is installed in this
    process (looked up by module name: the port never imports it)."""
    other = sys.modules.get("iotml.analysis.lockcheck")
    return other is not None and getattr(other, "_state", None) is not None


def install() -> State:
    """Patch the lock factories and I/O probes; returns the live State.
    Idempotent: a second install returns the existing State.  Raises
    RuntimeError when the JAX package's detector is installed in this
    process (both patch ``threading.Lock``)."""
    global _state
    if _state is not None:
        return _state
    if _foreign_detector_live():
        raise RuntimeError("the JAX package's lockcheck is installed in "
                           "this process; both patch threading.Lock, so "
                           "install one of them, never both")
    _state = State()
    threading.Lock = _make_lock          # type: ignore[assignment]
    threading.RLock = _make_rlock        # type: ignore[assignment]
    time.sleep = _checked_sleep          # type: ignore[assignment]
    _patch_socket_probes(True)
    _instrument_stream_layer()
    return _state


def uninstall() -> Optional[State]:
    """Restore the patched names; returns the final State (or None if
    lockcheck was not installed).  Checked locks already handed out keep
    working — they wrap real locks."""
    global _state
    st = _state
    if st is None:
        return None
    _state = None
    threading.Lock = _REAL_LOCK          # type: ignore[assignment]
    threading.RLock = _REAL_RLOCK        # type: ignore[assignment]
    time.sleep = _REAL_SLEEP             # type: ignore[assignment]
    _patch_socket_probes(False)
    return st


def state() -> Optional[State]:
    return _state


def enabled_by_env() -> bool:
    return os.environ.get("IOTML_LOCKCHECK", "") not in ("", "0")
