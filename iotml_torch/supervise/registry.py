"""Process-wide registries of background threads and supervisors
(``iotml.supervise.registry``'s copy).

Every background thread the port starts for a server (the REST handlers,
their accept loop, the KSQL pump) is daemon, named and registered here,
so the threads are an enumerable surface and a wedged process's stack
dump names each one.  Registration holds one weak reference per thread
and never extends a lifetime.  Supervisors (``supervisor.Supervisor``)
register themselves on start, so ``snapshot()`` reports their units'
states to ``/healthz``.
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional

_lock = threading.Lock()
_threads: "List[weakref.ref]" = []
_supervisors: "List[weakref.ref]" = []


def register_thread(thread: threading.Thread,
                    name: Optional[str] = None) -> threading.Thread:
    """Register a background thread and return it (the idiom is
    ``register_thread(threading.Thread(...))``).  The thread must be a
    daemon and carry a name of its own (not ``Thread-N``): ValueError
    otherwise."""
    if name is not None:
        thread.name = name
    if not thread.daemon:
        raise ValueError(
            f"background thread {thread.name!r} must be daemon=True: "
            f"orderly shutdown belongs to the supervisor, not to a "
            f"non-daemon thread pinning process exit")
    if thread.name.startswith("Thread-"):
        raise ValueError(
            "background thread needs an explicit name (got default "
            f"{thread.name!r}): unnamed threads make wedged-process "
            "stack dumps unreadable")
    with _lock:
        # compact before appending, keeping threads not yet started
        # (ident None): registration happens at construction
        if len(_threads) > 64:
            _threads[:] = [r for r in _threads
                           if (t := r()) is not None
                           and (t.ident is None or t.is_alive())]
        _threads.append(weakref.ref(thread))
    return thread


def threads() -> List[threading.Thread]:
    """The registered threads that are alive (a snapshot)."""
    with _lock:
        refs = list(_threads)
    return [t for r in refs if (t := r()) is not None and t.is_alive()]


def register_supervisor(sup) -> None:
    with _lock:
        _supervisors[:] = [r for r in _supervisors if r() is not None]
        _supervisors.append(weakref.ref(sup))


def unregister_supervisor(sup) -> None:
    with _lock:
        _supervisors[:] = [r for r in _supervisors
                           if r() is not None and r() is not sup]


def supervisors() -> list:
    with _lock:
        refs = list(_supervisors)
    return [s for r in refs if (s := r()) is not None]


def snapshot() -> Dict[str, dict]:
    """Unit states across every live supervisor (an empty dict when
    nothing is supervised).  A supervisor whose ``snapshot()`` raises is
    left out."""
    out: Dict[str, dict] = {}
    for sup in supervisors():
        try:
            out.update(sup.snapshot())
        except Exception:  # noqa: BLE001 - a dying supervisor must not
            continue       # take the health report down with it
    return out
