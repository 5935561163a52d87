"""Wire-protocol conformance pass (whole-program, five surfaces).

The port's copy of the JAX package's ``analysis/protocol.py``.  The
wire contract lives in five places: the Python server's dispatch and
the Python client's encoders (``stream/kafka_wire.py``), the cluster
router's delegations (``cluster/client.py``), the native client's
constants and request sites (``cpp/kafka_client.cc`` plus the message
set engine it calls, ``cpp/msgset_engine.cc``, parsed textually — no
clang), the R2 lint's idempotency mirror, and the chaos faultpoint
registry (``chaos/faults.py``).  This pass extracts an
api-id↔handler↔encoder↔error-code↔idempotency table from each surface
and checks N-way symmetry.  Findings carry the finding id plus both
file:line anchors (the drifted site and the authority it drifted from).

The server table is read from either dispatch shape: the JAX package's
``if api_key == X: ... elif ...`` chain (what its seeded fixture uses)
and the port's dict literal ``{X: self._x, ...}[api_key](...)``, whose
handler methods are walked, through the ``self.<method>(...)`` helpers
of their class, for the codes each can answer.

Finding ids (suppressible with ``# lint-ok: Pn <reason>``):

  P1  server table integrity: an api in _SUPPORTED with no dispatch
      branch, a dispatch branch for an api _SUPPORTED disowns, or a
      handler emitting a bare numeric error code no ERR_* constant
      names.
  P2  encoder/claim drift: a client encoder naming an api constant
      the table doesn't know, a supported api no Python encoder can
      reach, a cluster delegation (attribute or getattr-string) naming
      a wire method that doesn't exist, or a cluster-expected api the
      router never claims.
  P3  missing typed error mapping: the server can answer a code on an
      api whose Python encoder never compares against it (the generic
      RuntimeError fallback is not a mapping).
  P4  native-surface drift: a C++ API_*/ERR_* constant whose value
      disagrees with Python's, a request() claim with no constant, or
      a claim for an api _SUPPORTED disowns.
  P5  idempotency drift: wire IDEMPOTENT_APIS vs the lint's name
      mirror disagree, or a classification names an unsupported api.
  P6  chaos coverage: an encoder whose request path reaches no
      registered faultpoint (every wire exchange must be injectable),
      or a faultpoint name the chaos registry doesn't know.
  P7  cluster routing: a claim on a NOT_LEADER-capable api outside a
      _routed(...) delegation, or on a NOT_COORDINATOR-capable api
      outside _coordinated(...) — the retry/refresh invariants live in
      those two wrappers only.
"""

from __future__ import annotations

import ast
import os
import re
import types
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .lint import (Finding, _ModuleCallGraph, _Suppressions, _call_name,
                   _str_arg0, call_graph_for, default_root,
                   suppressions_for)
from .program import FileUnit, Program

PASS_RULES: Dict[str, str] = {
    "P1": "server dispatch table drift (supported api without a "
          "handler, handler without a _SUPPORTED row, or a bare "
          "numeric error code)",
    "P2": "encoder/claim drift (unknown api constant, supported api "
          "with no encoder, or a cluster delegation naming a missing "
          "wire method)",
    "P3": "server-emittable error code with no typed client mapping",
    "P4": "C++ surface drift (constant value mismatch or claim "
          "without a table row)",
    "P5": "idempotency classification drift (wire allowlist vs lint "
          "mirror)",
    "P6": "wire exchange unreachable by any chaos faultpoint, or an "
          "unregistered faultpoint name",
    "P7": "cluster claim outside the required _routed/_coordinated "
          "delegation",
}

# Apis the cluster router deliberately does NOT claim: SASL and
# version negotiation are per-connection bootstrap (KafkaWireBroker
# does both inside _connect_any), and CLUSTER_ADMIN is the admin CLI's
# direct verb against a chosen node — routing it through the partition
# map would defeat drain/add of the very node being addressed.
CLUSTER_EXEMPT_APIS = frozenset({
    "SASL_HANDSHAKE", "API_VERSIONS", "CLUSTER_ADMIN"})

# default surface locations (relative to the iotml_torch package root)
WIRE_REL = os.path.join("stream", "kafka_wire.py")
CLUSTER_REL = os.path.join("cluster", "client.py")
CPP_REL = os.path.join("cpp", "kafka_client.cc")
#: the native client's message-set codec, split out of kafka_client.cc
#: in the port: parsed with it as one C++ surface
CPP_MSGSET_REL = os.path.join("cpp", "msgset_engine.cc")
FAULTS_REL = os.path.join("chaos", "faults.py")

_CPP_API_RE = re.compile(r"\b(API_[A-Z_]+)\s*=\s*(-?\d+)")
_CPP_ERR_RE = re.compile(r"\b(ERR_[A-Z_]+)\s*=\s*(-?\d+)")
_CPP_CLAIM_RE = re.compile(r"\brequest\(\s*\w+\s*,\s*(API_[A-Z_]+)")


def _line_node(line: int) -> ast.AST:
    """Anchor shim so table-level findings reuse the lint's
    suppression machinery (which expects an AST node span)."""
    return types.SimpleNamespace(lineno=line, end_lineno=line)


# ------------------------------------------------------------ wire table
class Encoder:
    __slots__ = ("method", "api", "line", "typed")

    def __init__(self, method: str, api: str, line: int):
        self.method = method
        self.api = api
        self.line = line
        self.typed: Dict[str, int] = {}       # ERR name -> compare line


class Handler:
    __slots__ = ("api", "line", "codes", "bare")

    def __init__(self, api: str, line: int):
        self.api = api
        self.line = line
        self.codes: Dict[str, int] = {}       # ERR name -> emit line
        self.bare: List[Tuple[int, int]] = [] # (numeric code, line)


class WireTable:
    """Everything the conformance checks need from kafka_wire.py."""

    def __init__(self) -> None:
        self.consts: Dict[str, Tuple[int, int]] = {}   # name -> (value, line)
        self.supported: Dict[str, int] = {}            # api name -> line
        self.supported_line = 0
        self.idempotent: Dict[str, int] = {}           # api name -> line
        self.handlers: Dict[str, Handler] = {}         # api name -> Handler
        self.encoders: Dict[str, Encoder] = {}         # method -> Encoder
        self.method_points: Dict[str, Set[str]] = {}   # fn -> chaos points
        self.graph: Optional[_ModuleCallGraph] = None

    # ---- derived
    def err_values(self) -> Set[int]:
        return {v for n, (v, _) in self.consts.items()
                if n.startswith("ERR_")}

    def _local_callees(self, method: str) -> Set[str]:
        """Callees resolvable within the module: ``self.x(...)`` and
        bare ``x(...)`` only — an attribute call on a foreign receiver
        (``"".join(...)``, ``r.array(...)``) must NOT resolve to a
        same-named module function, or every method that joins a
        string 'reaches' the group-join encoder."""
        body = self.graph.bodies.get(method) if self.graph else None
        out: Set[str] = set()
        if body is None:
            return out
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                if not (isinstance(f.value, ast.Name)
                        and f.value.id == "self"):
                    continue
                callee = f.attr
            elif isinstance(f, ast.Name):
                callee = f.id
            else:
                continue
            if callee != method and self.graph \
                    and callee in self.graph.bodies:
                out.add(callee)
        return out

    def apis_of_method(self, method: str,
                       _seen: Optional[Set[str]] = None) -> Set[str]:
        """Apis a wire method reaches, transitively (end_offset →
        _list_offset → LIST_OFFSETS)."""
        _seen = _seen if _seen is not None else set()
        if method in _seen:
            return set()
        _seen.add(method)
        out: Set[str] = set()
        if method in self.encoders:
            out.add(self.encoders[method].api)
        for callee in self._local_callees(method):
            out |= self.apis_of_method(callee, _seen)
        return out

    def points_of_method(self, method: str,
                         _seen: Optional[Set[str]] = None) -> Set[str]:
        """Chaos faultpoints a wire method's call tree reaches."""
        _seen = _seen if _seen is not None else set()
        if method in _seen:
            return set()
        _seen.add(method)
        out = set(self.method_points.get(method, ()))
        for callee in self._local_callees(method):
            out |= self.points_of_method(callee, _seen)
        return out


def _collect_consts(tree: ast.Module, table: WireTable) -> None:
    for node in tree.body:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for tgt in targets:
            if isinstance(tgt, ast.Name) and tgt.id.isupper() \
                    and isinstance(value, ast.Constant) \
                    and isinstance(value.value, int):
                table.consts[tgt.id] = (value.value, node.lineno)
            elif isinstance(tgt, ast.Tuple) \
                    and isinstance(value, ast.Tuple) \
                    and len(tgt.elts) == len(value.elts):
                for name, val in zip(tgt.elts, value.elts):
                    if isinstance(name, ast.Name) and name.id.isupper() \
                            and isinstance(val, ast.Constant) \
                            and isinstance(val.value, int):
                        table.consts[name.id] = (val.value, node.lineno)


def _collect_tables(tree: ast.Module, table: WireTable) -> None:
    for node in tree.body:
        tgt = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tgt = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            tgt = node.target.id
        value = getattr(node, "value", None)
        if tgt == "_SUPPORTED" and isinstance(value, ast.Dict):
            table.supported_line = node.lineno
            for k in value.keys:
                if isinstance(k, ast.Name):
                    table.supported[k.id] = k.lineno
        elif tgt == "IDEMPOTENT_APIS" and value is not None:
            for sub in ast.walk(value):
                # api constants only — not the frozenset builtin itself
                if isinstance(sub, ast.Name) and sub.id.isupper():
                    table.idempotent[sub.id] = sub.lineno


def _int_literal(node: ast.expr) -> Optional[int]:
    """Integer literal value, covering the ``-1`` UnaryOp shape."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub) \
            and isinstance(node.operand, ast.Constant) \
            and isinstance(node.operand.value, int):
        return -node.operand.value
    return None


def _api_names_in_test(test: ast.expr) -> List[Tuple[str, int]]:
    """Api constant names an If test compares ``api_key`` against."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        left = node.left
        if not (isinstance(left, ast.Name) and left.id == "api_key"):
            continue
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq) and isinstance(comp, ast.Name):
                out.append((comp.id, node.lineno))
            elif isinstance(op, ast.In) \
                    and isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                out.extend((e.id, node.lineno) for e in comp.elts
                           if isinstance(e, ast.Name))
    return out


def _emitted_codes(stmts: Iterable[ast.AST], codes: Dict[str, int],
                   bare: List[Tuple[int, int]]) -> None:
    """ERR_* loads (and bare i16 integer writes) under ``stmts``."""
    for stmt in stmts:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Name) and sub.id.startswith("ERR_"):
                codes.setdefault(sub.id, sub.lineno)
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "i16" and sub.args:
                val = _int_literal(sub.args[0])
                if val is not None:
                    bare.append((val, sub.lineno))


def _add_handler(table: WireTable, api: str, line: int,
                 codes: Dict[str, int],
                 bare: List[Tuple[int, int]]) -> None:
    h = table.handlers.get(api)
    if h is None:
        h = table.handlers[api] = Handler(api, line)
    for name, ln in codes.items():
        h.codes.setdefault(name, ln)
    h.bare.extend(bare)


def _self_callees(fn: ast.AST, methods: Dict[str, ast.AST]) -> Set[str]:
    return {node.func.attr for node in ast.walk(fn)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "self"
            and node.func.attr in methods}


def _method_codes(name: str, methods: Dict[str, ast.AST]
                  ) -> Tuple[Dict[str, int], List[Tuple[int, int]]]:
    """Codes a dict-dispatched handler method can answer: its body and,
    transitively, the ``self.<method>(...)`` helpers of its class."""
    codes: Dict[str, int] = {}
    bare: List[Tuple[int, int]] = []
    seen: Set[str] = set()
    todo = [name]
    while todo:
        cur = todo.pop()
        if cur in seen:
            continue
        seen.add(cur)
        _emitted_codes([methods[cur]], codes, bare)
        todo.extend(_self_callees(methods[cur], methods) - seen)
    return codes, bare


def _dispatch_dicts(fn: ast.AST) -> Iterable[ast.Dict]:
    """Dict literals mapping api constants to ``self.<method>``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict) and node.keys and all(
                isinstance(k, ast.Name) and k.id.isupper()
                and isinstance(v, ast.Attribute)
                and isinstance(v.value, ast.Name) and v.value.id == "self"
                for k, v in zip(node.keys, node.values)):
            yield node


def _collect_handlers(tree: ast.Module, table: WireTable) -> None:
    """Dispatch branches inside a ``handle`` / ``_dispatch`` method.
    Either every If whose test names api constants, its body's ERR_*
    loads (and bare i16 integer writes) being the codes that branch can
    answer; or every dict literal ``{API: self._handler, ...}``, each
    handler method's codes (``_method_codes``) being its api's."""
    for cls in [tree] + [n for n in ast.walk(tree)
                         if isinstance(n, ast.ClassDef)]:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        for fn in methods.values():
            if fn.name not in ("handle", "_dispatch"):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.If):
                    continue
                apis = _api_names_in_test(node.test)
                if not apis:
                    continue
                codes: Dict[str, int] = {}
                bare: List[Tuple[int, int]] = []
                _emitted_codes(node.body, codes, bare)
                for api, line in apis:
                    _add_handler(table, api, line, codes, bare)
            for d in _dispatch_dicts(fn):
                for k, v in zip(d.keys, d.values):
                    if v.attr in methods:
                        codes, bare = _method_codes(v.attr, methods)
                    else:
                        codes, bare = {}, []
                    _add_handler(table, k.id, k.lineno, codes, bare)


def _collect_encoders(tree: ast.Module, table: WireTable) -> None:
    """Client encoders: methods sending ``self._request(API, ...)`` or
    ``self._exchange(API, ...)``; their typed error mappings are the
    ERR_* names the method (or a local helper it calls) compares the
    response code against."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("_request", "_exchange") \
                    and isinstance(node.func.value, ast.Name) \
                    and node.func.value.id == "self" \
                    and node.args and isinstance(node.args[0], ast.Name) \
                    and node.args[0].id.isupper():
                enc = table.encoders.setdefault(
                    fn.name, Encoder(fn.name, node.args[0].id,
                                     node.lineno))
                enc.typed.update(_typed_codes(fn))
    # fold in ERR compares from local helpers the encoder calls (one
    # transitive hop covers the response-shape helper idiom)
    bodies = table.graph.bodies if table.graph else {}
    for enc in table.encoders.values():
        body = bodies.get(enc.method)
        if body is None:
            continue
        for node in ast.walk(body):
            if isinstance(node, ast.Call):
                callee = _call_name(node)
                if callee and callee != enc.method and callee in bodies:
                    for name, ln in _typed_codes(bodies[callee]).items():
                        enc.typed.setdefault(name, ln)


def _typed_codes(fn: ast.AST) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name) and sub.id.startswith("ERR_"):
                    out.setdefault(sub.id, node.lineno)
    return out


def _collect_points(tree: ast.Module, table: WireTable) -> None:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "point" \
                    and _str_arg0(node) is not None:
                table.method_points.setdefault(fn.name, set()).add(
                    _str_arg0(node))


def build_wire_table(unit: FileUnit) -> WireTable:
    def _build(u: FileUnit) -> WireTable:
        table = WireTable()
        if u.tree is None:
            return table
        table.graph = call_graph_for(u)
        _collect_consts(u.tree, table)
        _collect_tables(u.tree, table)
        _collect_handlers(u.tree, table)
        _collect_points(u.tree, table)
        _collect_encoders(u.tree, table)
        return table
    return unit.cached("wiretable", _build)


# ------------------------------------------------------- cluster surface
class ClusterClaim:
    __slots__ = ("method", "kind", "line")

    def __init__(self, method: str, kind: str, line: int):
        self.method = method   # wire-client method name claimed
        self.kind = kind       # routed | coordinated | any | direct
        self.line = line


_DELEGATES = {"_routed": "routed", "_coordinated": "coordinated",
              "_any_conn_call": "any"}


def _scan_op(body: Iterable[ast.AST], param: Optional[str], kind: str,
             out: List[ClusterClaim]) -> None:
    """Claims inside a delegation op: calls/getattr on its conn param."""
    for stmt in body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Name) \
                    and (param is None or f.value.id == param):
                out.append(ClusterClaim(f.attr, kind, node.lineno))
            elif isinstance(f, ast.Name) and f.id == "getattr" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[0], ast.Name) \
                    and (param is None or node.args[0].id == param) \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                out.append(ClusterClaim(node.args[1].value, kind,
                                        node.lineno))


def extract_cluster_claims(unit: FileUnit) -> List[ClusterClaim]:
    def _build(u: FileUnit) -> List[ClusterClaim]:
        claims: List[ClusterClaim] = []
        if u.tree is None:
            return claims
        for method in ast.walk(u.tree):
            if not isinstance(method, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                continue
            local_defs = {n.name: n for n in method.body
                          if isinstance(n, ast.FunctionDef)}
            for node in ast.walk(method):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute) \
                        or node.func.attr not in _DELEGATES:
                    continue
                kind = _DELEGATES[node.func.attr]
                for arg in node.args:
                    if isinstance(arg, ast.Lambda):
                        param = arg.args.args[0].arg \
                            if arg.args.args else None
                        _scan_op([arg.body], param, kind, claims)
                    elif isinstance(arg, ast.Name) \
                            and arg.id in local_defs:
                        op = local_defs[arg.id]
                        param = op.args.args[0].arg \
                            if op.args.args else None
                        _scan_op(op.body, param, kind, claims)
            # direct per-shard calls: self._conn(shard).method(...)
            for node in ast.walk(method):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Call) \
                        and isinstance(node.func.value.func,
                                       ast.Attribute) \
                        and node.func.value.func.attr == "_conn":
                    claims.append(ClusterClaim(node.func.attr, "direct",
                                               node.lineno))
        return claims
    return unit.cached("clusterclaims", _build)


# --------------------------------------------------------- chaos registry
def chaos_registry(unit: FileUnit) -> Dict[str, Dict[str, int]]:
    """{table_name: {point_name: line}} for KNOWN_POINTS /
    RUNNER_POINTS / POINT_ACTIONS, parsed from chaos/faults.py (shared
    with the drift pass)."""
    def _build(u: FileUnit) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        if u.tree is None:
            return out
        for node in u.tree.body:
            tgt = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                tgt = node.targets[0].id
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                tgt = node.target.id
            value = getattr(node, "value", None)
            if tgt in ("KNOWN_POINTS", "RUNNER_POINTS",
                       "POINT_ACTIONS") and isinstance(value, ast.Dict):
                out[tgt] = {k.value: k.lineno for k in value.keys
                            if isinstance(k, ast.Constant)
                            and isinstance(k.value, str)}
        return out
    return unit.cached("chaosregistry", _build)


# ------------------------------------------------------------- C++ parse
class CppTable:
    __slots__ = ("apis", "errs", "claims")

    def __init__(self) -> None:
        self.apis: Dict[str, Tuple[int, int]] = {}   # name -> (value, line)
        self.errs: Dict[str, Tuple[int, int]] = {}
        self.claims: List[Tuple[str, int]] = []      # (API_ name, line)


def parse_cpp(path: str) -> CppTable:
    table = CppTable()
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for i, line in enumerate(f, start=1):
            for m in _CPP_API_RE.finditer(line):
                table.apis.setdefault(m.group(1), (int(m.group(2)), i))
            for m in _CPP_ERR_RE.finditer(line):
                table.errs.setdefault(m.group(1), (int(m.group(2)), i))
            for m in _CPP_CLAIM_RE.finditer(line):
                table.claims.append((m.group(1), i))
    return table


# --------------------------------------------------------------- checks
class _Pass:
    def __init__(self, wire_unit: FileUnit):
        self.wire = wire_unit
        self.table = build_wire_table(wire_unit)
        self.sup = suppressions_for(wire_unit)
        self.findings: List[Finding] = []
        self.wire_name = os.path.basename(wire_unit.path)

    def emit(self, sup: _Suppressions, path: str, rule: str, line: int,
             message: str) -> None:
        if not sup.suppressed(rule, _line_node(line)):
            self.findings.append(Finding(path, line, rule, message))

    # ---- intra-wire checks (also run standalone on fixtures)
    def check_wire(self) -> None:
        t, sup, path = self.table, self.sup, self.wire.path
        # P1: _SUPPORTED rows vs dispatch branches, both directions
        for api, line in t.supported.items():
            if api not in t.handlers:
                self.emit(sup, path, "P1", line,
                          f"api {api} is in _SUPPORTED but no "
                          "handle()/_dispatch() branch handles it — "
                          "clients negotiating it will hit an "
                          "unanswered request")
        for api, h in t.handlers.items():
            if api not in t.supported:
                self.emit(sup, path, "P1", h.line,
                          f"dispatch branch for {api} but _SUPPORTED "
                          f"(line {t.supported_line}) disowns it — the "
                          "version preamble answers UNSUPPORTED_VERSION "
                          "before this branch can run")
            errvals = t.err_values()
            for val, line in h.bare:
                if val not in errvals:
                    self.emit(sup, path, "P1", line,
                              f"handler for {h.api} emits bare error "
                              f"code {val} that no ERR_* constant "
                              "names — clients cannot write a typed "
                              "mapping for an unnamed code")
        # P2: encoders must name known, supported apis...
        for enc in t.encoders.values():
            if enc.api not in t.consts:
                self.emit(sup, path, "P2", enc.line,
                          f"{enc.method}() requests unknown api "
                          f"constant {enc.api}")
            elif enc.api not in t.supported:
                self.emit(sup, path, "P2", enc.line,
                          f"{enc.method}() requests {enc.api} which "
                          f"_SUPPORTED (line {t.supported_line}) "
                          "disowns")
        # ...and every supported api must have an encoder path
        encoded = {e.api for e in t.encoders.values()}
        for api, line in t.supported.items():
            if api not in encoded:
                self.emit(sup, path, "P2", line,
                          f"api {api} is in _SUPPORTED but no client "
                          "encoder method requests it — the Python "
                          "surface cannot exercise its own contract")
        # P3: typed mapping for every code the server can emit
        for enc in t.encoders.values():
            h = t.handlers.get(enc.api)
            if h is None:
                continue
            for code, src_line in sorted(h.codes.items()):
                if code == "ERR_NONE":
                    continue
                if code not in enc.typed:
                    self.emit(sup, path, "P3", enc.line,
                              f"server can answer {code} on {enc.api} "
                              f"({self.wire_name}:{src_line}) but "
                              f"{enc.method}() never compares against "
                              "it — it would surface as the generic "
                              "RuntimeError fallback, untyped")
        # P5: idempotency classifications name supported apis
        for api, line in t.idempotent.items():
            if api not in t.supported:
                self.emit(sup, path, "P5", line,
                          f"IDEMPOTENT_APIS classifies {api} which "
                          "_SUPPORTED disowns — a retry allowlist for "
                          "an api that cannot be requested")

    def check_idempotency_mirror(self, lint_names: Iterable[str],
                                 lint_path: str) -> None:
        wire_names = set(self.table.idempotent)
        mirror = set(lint_names)
        line = min(self.table.idempotent.values(), default=1)
        for api in sorted(wire_names - mirror):
            self.emit(self.sup, self.wire.path, "P5",
                      self.table.idempotent[api],
                      f"{api} is idempotent on the wire but the lint "
                      f"mirror ({lint_path}) does not list it — R2 "
                      "would flag call sites the client auto-retries")
        for api in sorted(mirror - wire_names):
            self.emit(self.sup, self.wire.path, "P5", line,
                      f"the lint mirror ({lint_path}) classifies {api} "
                      "idempotent but wire IDEMPOTENT_APIS does not — "
                      "R2 would pass a call site the client refuses to "
                      "retry")

    def check_chaos(self, registry: Optional[Dict[str, int]]) -> None:
        t, sup, path = self.table, self.sup, self.wire.path
        for enc in sorted(t.encoders.values(), key=lambda e: e.line):
            points = t.points_of_method(enc.method)
            if not points:
                self.emit(sup, path, "P6", enc.line,
                          f"{enc.method}() ({enc.api}) reaches no "
                          "chaos faultpoint — its wire exchange cannot "
                          "be fault-injected")
            elif registry is not None:
                for p in sorted(points):
                    if p not in registry:
                        self.emit(sup, path, "P6", enc.line,
                                  f"{enc.method}() reaches faultpoint "
                                  f"{p!r} which the chaos registry "
                                  "(KNOWN_POINTS) does not declare")

    def check_cluster(self, cluster_unit: FileUnit) -> None:
        t = self.table
        claims = extract_cluster_claims(cluster_unit)
        sup = suppressions_for(cluster_unit)
        path = cluster_unit.path
        wire_methods = {fn.name for fn in ast.walk(self.wire.tree)
                        if isinstance(fn, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))} \
            if self.wire.tree is not None else set()
        claimed_apis: Set[str] = set()
        for c in claims:
            if c.method not in wire_methods:
                self.emit(sup, path, "P2", c.line,
                          f"cluster delegation names wire method "
                          f"{c.method!r} which {self.wire_name} does "
                          "not define — the claim dispatches to "
                          "nothing")
                continue
            apis = t.apis_of_method(c.method)
            claimed_apis |= apis
            for api in sorted(apis):
                h = t.handlers.get(api)
                if h is None:
                    continue
                if "ERR_NOT_LEADER_FOR_PARTITION" in h.codes \
                        and c.kind != "routed":
                    self.emit(sup, path, "P7", c.line,
                              f"{c.method}() claims {api}, which can "
                              "answer NOT_LEADER_FOR_PARTITION "
                              f"({self.wire_name}:"
                              f"{h.codes['ERR_NOT_LEADER_FOR_PARTITION']}"
                              f"), from a {c.kind!r} context — only "
                              "_routed(...) re-resolves the map and "
                              "redelivers")
                if "ERR_NOT_COORDINATOR" in h.codes \
                        and c.kind != "coordinated":
                    self.emit(sup, path, "P7", c.line,
                              f"{c.method}() claims {api}, which can "
                              "answer NOT_COORDINATOR "
                              f"({self.wire_name}:"
                              f"{h.codes['ERR_NOT_COORDINATOR']}), "
                              f"from a {c.kind!r} context — only "
                              "_coordinated(...) re-finds the "
                              "coordinator")
        for api in sorted(set(t.supported) - claimed_apis
                          - set(CLUSTER_EXEMPT_APIS)):
            self.emit(sup, path, "P2", 1,
                      f"cluster surface claims no path to api {api} "
                      f"(_SUPPORTED {self.wire_name}:"
                      f"{t.supported.get(api, 0)}) — every "
                      "non-bootstrap api must survive sharding")

    def check_cpp(self, cpp_path: str,
                  cpp_table: Optional[CppTable] = None) -> None:
        t, sup = self.table, self.sup
        cpp = cpp_table if cpp_table is not None else parse_cpp(cpp_path)
        for name, (value, line) in sorted(cpp.apis.items()):
            py_name = name[len("API_"):]
            if py_name not in t.consts:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ constant {name} has no Python "
                          f"counterpart {py_name} in {self.wire_name}")
            elif t.consts[py_name][0] != value:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ {name} = {value} but {self.wire_name}:"
                          f"{t.consts[py_name][1]} defines {py_name} = "
                          f"{t.consts[py_name][0]} — the native client "
                          "would speak a different api id")
        for name, (value, line) in sorted(cpp.errs.items()):
            if name not in t.consts:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ error constant {name} has no Python "
                          f"counterpart in {self.wire_name}")
            elif t.consts[name][0] != value:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ {name} = {value} but {self.wire_name}:"
                          f"{t.consts[name][1]} defines {name} = "
                          f"{t.consts[name][0]} — typed mappings "
                          "would misclassify the wire code")
        for name, line in cpp.claims:
            py_name = name[len("API_"):]
            if name not in cpp.apis:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ request() claims {name} but no "
                          "constant defines it")
            elif py_name not in t.supported:
                self.emit(sup, cpp_path, "P4", line,
                          f"C++ request() claims {name} but _SUPPORTED "
                          f"({self.wire_name}:{t.supported_line}) "
                          "disowns it — the server answers "
                          "UNSUPPORTED_VERSION")


# ------------------------------------------------------------------ API
def check_wire(wire_path: str,
               program: Optional[Program] = None) -> List[Finding]:
    """Intra-file conformance (P1/P2/P3/P5/P6 without registries) —
    the entry point the seeded fixture corpus runs through."""
    program = program if program is not None else Program()
    p = _Pass(program.unit(wire_path))
    p.check_wire()
    p.check_chaos(None)
    return sorted(p.findings, key=lambda f: (f.path, f.line, f.rule))


def analyze(root: Optional[str] = None, *,
            wire: Optional[str] = None,
            cluster: Optional[str] = None,
            cpp: Optional[str] = None,
            faults: Optional[str] = None,
            lint_idempotent: Optional[Iterable[str]] = None,
            program: Optional[Program] = None) -> List[Finding]:
    """Whole-program conformance across all five surfaces.  Each
    surface path can be overridden independently (the skewed-C++ test
    swaps in a drifted snippet for ``cpp/kafka_client.cc`` against the
    real tree; ``cpp/msgset_engine.cc`` is parsed beside it)."""
    root = root if root is not None else default_root()
    program = program if program is not None else Program()
    wire = wire or os.path.join(root, WIRE_REL)
    cluster = cluster or os.path.join(root, CLUSTER_REL)
    cpp = cpp or os.path.join(root, CPP_REL)
    cpp_msgset = os.path.join(root, CPP_MSGSET_REL)
    faults = faults or os.path.join(root, FAULTS_REL)

    p = _Pass(program.unit(wire))
    p.check_wire()
    if lint_idempotent is None:
        from .lint import IDEMPOTENT_API_NAMES
        lint_idempotent = IDEMPOTENT_API_NAMES
    p.check_idempotency_mirror(lint_idempotent, "analysis/lint.py")
    registry = None
    if os.path.exists(faults):
        registry = chaos_registry(program.unit(faults)).get(
            "KNOWN_POINTS", {})
    p.check_chaos(registry)
    if os.path.exists(cluster):
        p.check_cluster(program.unit(cluster))
    if os.path.exists(cpp):
        p.check_cpp(cpp)
    if os.path.exists(cpp_msgset):
        p.check_cpp(cpp_msgset)
    return sorted(p.findings, key=lambda f: (f.path, f.line, f.rule))
