"""pytest plugin: runtime halves of the port's analysis passes.

The port's copy of the JAX package's ``analysis/pytest_plugin.py``.  On
the card's machine the port's tests run with ``--noconftest`` (the
repo's ``tests/conftest.py`` imports JAX), so this plugin, named with
``-p iotml_torch.analysis.pytest_plugin``, is how the guards are armed
there.  Two independently-gated detectors:

- **lockcheck** (``IOTML_LOCKCHECK=1`` or
  ``-p iotml_torch.analysis.pytest_plugin``): the suite runs under the
  runtime lock-order & race detector, installed at configure time —
  before any test constructs a broker/server — so every lock the
  stream stack creates is checked.  The acquisition graph is
  PRE-SEEDED with the statically-extracted acquire-order edges
  (analysis.lockorder), so a runtime acquisition that inverts an order
  the code merely *can* express still closes a cycle and fails the
  run, even when this session never executed the opposite path.  At
  session end the collected report is printed; **lock-order cycles
  fail the run** (exit status 3).  I/O-under-lock, unguarded-mutation
  and static-only-cycle findings are warnings unless
  ``IOTML_LOCKCHECK_STRICT=1`` promotes them to failures too.

- **trace guard** (``IOTML_TRACECHECK=1``): the port's hot loops
  (``Trainer.fit_compiled``, ``OnlineLearner._update``) are wrapped with
  the build guard (analysis.tracecheck): after a loop's warm-up call,
  any call with an identical shape/dtype signature that builds a kernel
  or loads a library raises ``RecompileError`` and fails that test.
  Warm state resets per test so one test's warm-up cannot mask
  another's per-call build.
"""

from __future__ import annotations

import os

from . import lockcheck


def _env_on(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def pytest_configure(config):
    trace_on = _env_on("IOTML_TRACECHECK")
    # a bare `-p iotml_torch.analysis.pytest_plugin` means lockcheck;
    # only a tracecheck-only session skips installing it
    if lockcheck.enabled_by_env() or not trace_on:
        st = lockcheck.install()
        from . import lockorder

        lockorder.preseed(st)
    if trace_on:
        from . import tracecheck

        config._iotml_traceguard = tracecheck.install_runtime_guard()


def pytest_runtest_setup(item):
    if _env_on("IOTML_TRACECHECK"):
        from . import tracecheck

        tracecheck.reset_warm()


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    tw = terminalreporter
    st = lockcheck.state()
    if st is not None:
        tw.section("iotml_torch lockcheck")
        tw.write_line(st.report())
    patched = getattr(config, "_iotml_traceguard", None)
    if patched is not None:
        tw.section("iotml_torch tracecheck")
        tw.write_line(
            f"build guard armed on: {', '.join(patched) or 'nothing'}")


def pytest_sessionfinish(session, exitstatus):
    st = lockcheck.state()
    if st is None:
        return
    strict = os.environ.get("IOTML_LOCKCHECK_STRICT", "") not in ("", "0")
    failures = st.violations if strict else st.cycles()
    if failures:
        session.exitstatus = 3
