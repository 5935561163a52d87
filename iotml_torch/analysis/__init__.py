"""iotml_torch.analysis — the port's concurrency & protocol-invariant checker.

The port's counterpart of the JAX package's ``iotml/analysis/``, with
the same module names, verbs, rule ids and ``path:line: RULE message``
findings, reading the port's own shapes:

- ``lint``       AST lint pass over the tree: rules R1-R16, run via
                 ``python -m iotml_torch.analysis lint`` (exit 1 on
                 findings).
- ``protocol``   whole-program wire-protocol conformance (P1-P7):
                 api-id ↔ handler ↔ encoder ↔ error-code ↔ idempotency
                 tables extracted from the Python server (its dict
                 dispatch as well as an ``if/elif`` chain) and client,
                 the cluster router, the C++ client and its message-set
                 engine, the lint allowlist and the chaos registry,
                 checked for N-way symmetry.
- ``tracecheck`` hot-loop discipline for PyTorch on CUDA (T1-T4): a
                 Python branch on a device value, a host sync, a
                 per-call kernel build or library load, a tensor in a
                 shape position, over a declared table of hot-loop
                 functions; plus a runtime build guard the pytest
                 plugin arms with ``IOTML_TRACECHECK=1`` (a warmed hot
                 loop that builds or loads a kernel library fails its
                 test).
- ``drift``      registry drift (D1-D4): IOTML_* env knobs vs config,
                 metric label sets vs declarations, faultpoint strings
                 vs the chaos registry, rule ids vs the README's rule
                 table.
- ``lockorder``  static acquire-order extraction from nested ``with``
                 blocks (per-class call-graph fixpoint) — pre-seeds the
                 runtime cycle detector below.
- ``lockcheck``  runtime lock-order & race detector: an instrumented
                 ``threading.Lock``/``RLock`` wrapper that records the
                 per-thread lock-acquisition graph, fails on cycles,
                 flags locks held across blocking I/O, and tags
                 unguarded mutations of registered shared state.  It
                 patches ``threading.Lock`` as the JAX package's does,
                 so a process installs one of the two, never both.
- the C++ edge is covered by TSan/ASan build targets instead
  (``make -C iotml_torch/cpp sanitize``) — and statically by the
  protocol pass's P4 textual parse of ``cpp/kafka_client.cc`` and
  ``cpp/msgset_engine.cc``.

All passes share one parse per file (``analysis.program.Program``); the
CLI summary reports wall time and files parsed.  A finding of any
family is suppressed with justification by ``# lint-ok: <rule>
<reason>`` on its line or the comment block above it.
"""

from .lint import Finding, RULES, lint_paths  # noqa: F401
from .program import FileUnit, Program  # noqa: F401
