"""Static lock-order extraction: acquire-order edges from the source.

The port's copy of the JAX package's ``analysis/lockorder.py``.  The
runtime detector (lockcheck) only sees orders the test run actually
executes.  This pass derives the same ``site → site`` acquire-order
edges statically — ``with self.a: … with self.b:`` nesting, including
acquisitions buried in methods the outer ``with`` body calls (per-class
call-graph fixpoint) — so the runtime cycle detector can be PRE-SEEDED
with every order the code can express.  A runtime acquisition that
completes a cycle through a statically-derived edge then fails the run
even though the opposite order was never executed in this session.

Lock identity matches lockcheck's runtime keying exactly: the
*allocation site* of the ``threading.Lock()``/``RLock()`` call as
``{parent-dir}/{file}.py:{lineno}`` (see ``_site_of_creation``), so
static and runtime edges land in one graph.

Scope and honesty: resolution is per class within one module —
``self.X`` locks and ``self.method()`` calls.  Locks passed across
objects or modules are out of reach; what this buys is the dominant
idiom (every broker/coordinator/replica lock is a ``self`` attribute
acquired by its own methods).  Edges are facts about nesting in the
source, not findings — cycles among them are reported by the CLI verb
and by lockcheck after pre-seeding.
"""

from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .program import FileUnit, Program

#: one extracted acquire-order edge: (outer site, inner site, where) —
#: `where` is "file.py:line" of the inner acquisition or the call that
#: reaches it
Edge = Tuple[str, str, str]


def _short_rel(path: str) -> str:
    parts = path.replace(os.sep, "/").split("/")
    return "/".join(parts[-2:])


def _is_lock_ctor(call: ast.AST) -> bool:
    if not isinstance(call, ast.Call):
        return False
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in ("Lock", "RLock") \
            and isinstance(f.value, ast.Name) \
            and f.value.id == "threading":
        return True
    return isinstance(f, ast.Name) and f.id in ("Lock", "RLock")


def _lock_ref(expr: ast.AST) -> Optional[str]:
    """The ``self.X`` attribute a with-item acquires, or None."""
    if isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name) \
            and expr.value.id == "self":
        return expr.attr
    return None


class _ClassLocks:
    """One class's lock attributes (attr → allocation site) and the
    per-method transitive acquire sets."""

    def __init__(self, node: ast.ClassDef, short: str):
        self.name = node.name
        self.locks: Dict[str, str] = {}
        self.methods: Dict[str, ast.AST] = {}
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                for t in sub.targets:
                    attr = _lock_ref(t)
                    if attr is not None:
                        # runtime keys on the frame line executing the
                        # threading.Lock() call
                        self.locks[attr] = f"{short}:{sub.value.lineno}"
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        self._acquires: Optional[Dict[str, Set[str]]] = None

    # ------------------------------------------------------- fixpoint
    def acquires(self) -> Dict[str, Set[str]]:
        """method name → every lock attr it may acquire, transitively
        through ``self.method()`` calls (cycle-safe fixpoint)."""
        if self._acquires is not None:
            return self._acquires
        direct: Dict[str, Set[str]] = {}
        calls: Dict[str, Set[str]] = {}
        for name, fn in self.methods.items():
            d: Set[str] = set()
            c: Set[str] = set()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.With):
                    for item in sub.items:
                        attr = _lock_ref(item.context_expr)
                        if attr in self.locks:
                            d.add(attr)
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "self" \
                        and sub.func.attr in self.methods:
                    c.add(sub.func.attr)
            direct[name] = d
            calls[name] = c
        acq = {name: set(d) for name, d in direct.items()}
        changed = True
        while changed:
            changed = False
            for name in acq:
                for callee in calls[name]:
                    before = len(acq[name])
                    acq[name] |= acq.get(callee, set())
                    changed = changed or len(acq[name]) > before
        self._acquires = acq
        return acq

    # ---------------------------------------------------------- edges
    def edges(self, short: str) -> List[Edge]:
        out: List[Edge] = []
        acq = self.acquires()

        def inner_acquires(body: List[ast.stmt]):
            """(lock attr, line) acquired anywhere under these
            statements: direct nested withs plus self.method() calls'
            transitive sets."""
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.With):
                        for item in sub.items:
                            attr = _lock_ref(item.context_expr)
                            if attr in self.locks:
                                yield attr, sub.lineno
                    elif isinstance(sub, ast.Call) \
                            and isinstance(sub.func, ast.Attribute) \
                            and isinstance(sub.func.value, ast.Name) \
                            and sub.func.value.id == "self" \
                            and sub.func.attr in self.methods:
                        for attr in acq.get(sub.func.attr, ()):
                            yield attr, sub.lineno

        for fn in self.methods.values():
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.With):
                    continue
                held: List[str] = []
                for item in sub.items:
                    attr = _lock_ref(item.context_expr)
                    if attr not in self.locks:
                        continue
                    # `with a, b:` acquires in item order
                    for h in held:
                        out.append((self.locks[h], self.locks[attr],
                                    f"{short}:{sub.lineno}"))
                    held.append(attr)
                if not held:
                    continue
                for attr, line in inner_acquires(sub.body):
                    for h in held:
                        if attr != h:
                            out.append((self.locks[h], self.locks[attr],
                                        f"{short}:{line}"))
        return out


def extract_edges(unit: FileUnit) -> List[Edge]:
    """All statically-derivable acquire-order edges in one module."""
    if unit.tree is None:
        return []

    def build(u: FileUnit) -> List[Edge]:
        short = _short_rel(u.path)
        out: List[Edge] = []
        seen: Set[Tuple[str, str]] = set()
        for node in ast.walk(u.tree):
            if isinstance(node, ast.ClassDef):
                for a, b, where in _ClassLocks(node, short).edges(short):
                    if (a, b) not in seen:
                        seen.add((a, b))
                        out.append((a, b, where))
        return out

    return unit.cached("lockedges", build)  # type: ignore[return-value]


def analyze(root: Optional[str] = None, *,
            paths: Optional[Iterable[str]] = None,
            program: Optional[Program] = None) -> List[Edge]:
    """Extract acquire-order edges across the tree (or ``paths``)."""
    from .lint import default_root
    program = program if program is not None else Program()
    base = [root if root is not None else default_root()]
    edges: List[Edge] = []
    seen: Set[Tuple[str, str]] = set()
    for unit in program.units(paths if paths is not None else base):
        for a, b, where in extract_edges(unit):
            if (a, b) not in seen:
                seen.add((a, b))
                edges.append((a, b, where))
    return edges


def cycles_among(edges: Iterable[Edge]) -> List[List[str]]:
    """Cycles in the static edge set alone (each reported once)."""
    graph: Dict[str, Set[str]] = {}
    for a, b, _ in edges:
        if a != b:
            graph.setdefault(a, set()).add(b)
    out: List[List[str]] = []
    seen_cycles: Set[frozenset] = set()
    for start in sorted(graph):
        stack = [(start, [start])]
        visited = set()
        while stack:
            node, path = stack.pop()
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(path + [start])
                elif nxt not in visited and nxt not in path:
                    visited.add(nxt)
                    stack.append((nxt, path + [nxt]))
    return out


def preseed(state=None, edges: Optional[Iterable[Edge]] = None,
            root: Optional[str] = None) -> int:
    """Feed static edges into the runtime detector's graph (the pytest
    plugin's hook).  Returns the number of edges seeded; no-op (0) when
    lockcheck is not installed."""
    from . import lockcheck
    st = state if state is not None else lockcheck.state()
    if st is None:
        return 0
    if edges is None:
        edges = analyze(root)
    return st.preseed_static(edges)
