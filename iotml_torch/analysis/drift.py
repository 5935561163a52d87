"""Registry-drift pass: knobs, metrics, faultpoints, and doc rows.

The port's copy of the JAX package's ``analysis/drift.py``, resolving
against the port's own registries.  Every cross-cutting registry is a
contract between the code that WRITES a name and the registry that
DECLARES it.  This pass closes the loop statically:

D1  every ``IOTML_*`` environment read resolves to a declared config
    field (the port's ``config.env_key_names()``) or an entry in its
    ``NON_CONFIG`` set (a ``non_config`` assignment is read too, as
    the JAX package keeps it) — an unregistered knob is a setting the
    config ladder (files, ``--section.field`` flags, precedence)
    silently cannot see.
D2  every metric usage matches its declaration: the metric attribute
    exists, every label keyword at a record site appears in the
    metric's ``DECLARED_METRIC_LABELS`` row (obs/metrics.py), and every
    declaration row names a real metric with keys drawn from
    ``ALLOWED_LABEL_KEYS``.  Labels multiply series; an undeclared
    label set is an unbudgeted cardinality dimension.
D3  every ``chaos.point("…")`` string exists in the chaos registry
    (``KNOWN_POINTS`` ∪ ``RUNNER_POINTS``), and ``POINT_ACTIONS`` keys
    that registry exactly — a typo'd faultpoint is a chaos scenario
    that silently never fires.
D4  every analysis rule (lint R*, protocol P*, trace T*, drift D*) has
    its row in the rule table of the README's port section (the
    ``## The PyTorch/CUDA port`` section, up to the next ``## ``
    heading) — the doc table is the written contract for what the
    gate enforces.

Findings honour ``# lint-ok: D<n> <reason>`` suppressions (python
surfaces; the doc check D4 anchors in README.md itself).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .lint import Finding, default_root, suppressions_for
from .program import Program

PASS_RULES: Dict[str, str] = {
    "D1": "IOTML_* env read with no declared config field or "
          "non_config entry",
    "D2": "metric usage drifts from its declaration (unknown metric, "
          "undeclared label set, or stale declaration row)",
    "D3": "chaos faultpoint drift (unregistered point string or "
          "POINT_ACTIONS mismatch)",
    "D4": "analysis rule missing its row in the README port section's "
          "rule table",
}

_ENV_HELPERS = frozenset({"getenv", "_env", "_env_int", "_env_float",
                          "_env_bool", "_env_str", "_env_on"})
_RECORD_ATTRS = frozenset({"inc", "observe", "set", "time"})
_METRIC_MODULE_ALIASES = frozenset({"obs_metrics", "metrics", "_metrics"})
#: names of the non-config IOTML_* key set: the port's module-level
#: ``NON_CONFIG`` and the JAX package's ``load_config`` local
_NON_CONFIG_NAMES = frozenset({"NON_CONFIG", "non_config"})
#: the README section that holds the port's rule table (D4)
PORT_SECTION_HEADING = "## The PyTorch/CUDA port"


def _line_node(line: int):
    import types
    return types.SimpleNamespace(lineno=line, end_lineno=line)


# --------------------------------------------------------------------------
# D1: env knobs
# --------------------------------------------------------------------------

def declared_env_keys(config_path: Optional[str] = None) -> Set[str]:
    """IOTML_* keys the config ladder understands: the generated
    section_field keys plus the ``NON_CONFIG`` set (parsed from the
    source so the analyzer and the loader can never disagree about what
    the loader would reject)."""
    from .. import config as _config

    keys = set(_config.env_key_names())
    path = config_path or os.path.join(default_root(), "config.py")
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) \
                and any(isinstance(t, ast.Name)
                        and t.id in _NON_CONFIG_NAMES
                        for t in node.targets):
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Constant) \
                        and isinstance(sub.value, str):
                    keys.add(sub.value)
    return keys


def _env_reads(tree: ast.Module) -> List[Tuple[str, int]]:
    """(key, line) for every constant IOTML_* environment read:
    ``*.get("IOTML_X", …)`` / ``environ["IOTML_X"]`` / ``os.getenv`` /
    ``_env*("IOTML_X")`` helper calls."""
    out: List[Tuple[str, int]] = []

    def const_key(node: ast.AST) -> Optional[str]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("IOTML_") \
                and len(node.value) > len("IOTML_"):
            return node.value
        return None

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and node.args:
            key = const_key(node.args[0])
            if key is None:
                continue
            f = node.func
            if isinstance(f, ast.Attribute) and f.attr in ("get",) and (
                    (isinstance(f.value, ast.Attribute)
                     and f.value.attr == "environ")
                    or (isinstance(f.value, ast.Name)
                        and f.value.id in ("env", "environ", "_env"))):
                out.append((key, node.lineno))
            elif isinstance(f, ast.Attribute) and f.attr == "getenv":
                out.append((key, node.lineno))
            elif isinstance(f, ast.Name) and f.id in _ENV_HELPERS:
                out.append((key, node.lineno))
        elif isinstance(node, ast.Subscript):
            base = node.value
            if (isinstance(base, ast.Attribute) and base.attr == "environ") \
                    or (isinstance(base, ast.Name)
                        and base.id in ("environ", "env")):
                key = const_key(node.slice)
                if key is not None:
                    out.append((key, node.lineno))
    return out


# --------------------------------------------------------------------------
# D2: metrics
# --------------------------------------------------------------------------

def _metric_decls(tree: ast.Module) -> Dict[str, Tuple[str, int]]:
    """var/attr name -> (metric_name, line) for every
    ``x = <registry>.counter|gauge|histogram("name", …)``."""
    out: Dict[str, Tuple[str, int]] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) \
                or not isinstance(node.value, ast.Call):
            continue
        call = node.value
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in ("counter", "gauge", "histogram")
                and call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name):
                out[t.id] = (call.args[0].value, node.lineno)
            elif isinstance(t, ast.Attribute):
                out[t.attr] = (call.args[0].value, node.lineno)
    return out


def _metric_uses(tree: ast.Module) -> List[Tuple[str, bool,
                                                 Tuple[str, ...], int]]:
    """(attr, via_metrics_module, label_keys, line) for every
    ``<recv>.<attr>.inc|observe|set|time(…)`` record site.  Dynamic
    ``**labels`` cannot be resolved statically and is skipped."""
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RECORD_ATTRS):
            continue
        recv = node.func.value
        if not isinstance(recv, ast.Attribute):
            continue
        base = recv.value
        via_module = isinstance(base, ast.Name) \
            and base.id in _METRIC_MODULE_ALIASES
        via_self = isinstance(base, ast.Name) and base.id == "self"
        if not (via_module or via_self):
            continue
        keys = tuple(sorted(k.arg for k in node.keywords
                            if k.arg is not None))
        out.append((recv.attr, via_module, keys, node.lineno))
    return out


# --------------------------------------------------------------------------
# D3: chaos faultpoints
# --------------------------------------------------------------------------

def _chaos_points(tree: ast.Module) -> List[Tuple[str, int]]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "point" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            out.append((node.args[0].value, node.lineno))
    return out


# --------------------------------------------------------------------------
# the pass
# --------------------------------------------------------------------------

class _Drift:
    def __init__(self) -> None:
        self.findings: List[Finding] = []

    def emit(self, sup, path: str, rule: str, line: int,
             message: str) -> None:
        if sup is not None and sup.suppressed(rule, _line_node(line)):
            return
        self.findings.append(Finding(path, line, rule, message))


def port_section(doc: str) -> str:
    """The README's port section: from its heading to the next ``## ``
    heading (the whole text when the heading is absent, so a standalone
    rule-table document is read whole)."""
    start = doc.find(PORT_SECTION_HEADING)
    if start < 0:
        return doc
    end = doc.find("\n## ", start + len(PORT_SECTION_HEADING))
    return doc[start:end if end >= 0 else len(doc)]


def analyze(root: Optional[str] = None, *,
            paths: Optional[Iterable[str]] = None,
            program: Optional[Program] = None,
            doc: Optional[str] = None) -> List[Finding]:
    """Run the registry-drift pass over the package tree (or explicit
    ``paths`` for fixture corpora — registries still come from the real
    tree, so a fixture exercises the same contracts production does)."""
    from .protocol import FAULTS_REL, chaos_registry

    base = root if root is not None else default_root()
    program = program if program is not None else Program()
    out = _Drift()

    env_declared = declared_env_keys(os.path.join(base, "config.py"))

    metrics_path = os.path.join(base, "obs", "metrics.py")
    metrics_unit = program.unit(metrics_path, rel="obs/metrics.py")
    decls: Dict[str, Tuple[str, int]] = {}
    from ..obs import metrics as _obs_metrics
    allowed_labels = frozenset(getattr(_obs_metrics, "ALLOWED_LABEL_KEYS",
                                       frozenset()))
    declared_labels: Dict[str, tuple] = dict(
        getattr(_obs_metrics, "DECLARED_METRIC_LABELS", {}))
    label_table_line = 0
    if metrics_unit.tree is not None:
        for node in ast.walk(metrics_unit.tree):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name)
                    and t.id == "DECLARED_METRIC_LABELS"
                    for t in node.targets):
                label_table_line = node.lineno

    faults_unit = program.unit(os.path.join(base, FAULTS_REL),
                               rel=FAULTS_REL)
    registry = chaos_registry(faults_unit)
    known = set(registry.get("KNOWN_POINTS", {})) \
        | set(registry.get("RUNNER_POINTS", {}))
    actions = registry.get("POINT_ACTIONS", {})

    units = program.units(paths if paths is not None else [base])
    for unit in units:
        if unit.tree is None:
            continue
        sup = suppressions_for(unit)
        for key, line in _env_reads(unit.tree):
            if key not in env_declared:
                out.emit(sup, unit.path, "D1", line,
                         f"env read of {key!r} matches no declared "
                         f"config field and no non_config entry: the "
                         f"config ladder (files, flags, precedence) "
                         f"cannot see this knob")
        decls.update(_metric_decls(unit.tree))
        for point, line in _chaos_points(unit.tree):
            if point not in known:
                out.emit(sup, unit.path, "D3", line,
                         f"faultpoint {point!r} is not in the chaos "
                         f"registry (KNOWN_POINTS/RUNNER_POINTS, "
                         f"{FAULTS_REL}): a scenario naming it would "
                         f"never fire")

    # second sweep for metric uses: declarations from ALL files must be
    # in hand first (chaos_injected lives in chaos/faults.py, the _m_*
    # family on mqtt instances)
    for unit in units:
        if unit.tree is None:
            continue
        sup = suppressions_for(unit)
        for attr, via_module, keys, line in _metric_uses(unit.tree):
            if attr not in decls:
                if via_module:
                    out.emit(sup, unit.path, "D2", line,
                             f"metric {attr!r} recorded here has no "
                             f"declaration (no <registry>.counter/"
                             f"gauge/histogram assignment found)")
                continue
            declared = declared_labels.get(attr, ())
            extra = set(keys) - set(declared)
            if extra:
                out.emit(sup, unit.path, "D2", line,
                         f"metric {attr!r} recorded with label keys "
                         f"{sorted(extra)} not in its "
                         f"DECLARED_METRIC_LABELS row "
                         f"(obs/metrics.py declares "
                         f"{sorted(declared) or 'no labels'}): an "
                         f"undeclared label is an unbudgeted "
                         f"cardinality dimension")

    # declaration-table hygiene (anchored in obs/metrics.py).  Stale-row
    # detection needs the WHOLE tree's declarations in hand, so it only
    # runs in tree scope — a fixture-scoped ``paths`` run would see
    # every real row as undeclared.
    msup = suppressions_for(metrics_unit)
    for attr, lbls in sorted(declared_labels.items()):
        if paths is None and attr not in decls:
            out.emit(msup, metrics_unit.path, "D2", label_table_line,
                     f"DECLARED_METRIC_LABELS row {attr!r} names no "
                     f"declared metric (stale row)")
        bad = set(lbls) - allowed_labels
        if bad:
            out.emit(msup, metrics_unit.path, "D2", label_table_line,
                     f"DECLARED_METRIC_LABELS row {attr!r} uses label "
                     f"keys {sorted(bad)} outside ALLOWED_LABEL_KEYS")

    # POINT_ACTIONS must mirror the point registry exactly
    fsup = suppressions_for(faults_unit)
    for point in sorted(set(actions) - known):
        out.emit(fsup, faults_unit.path, "D3",
                 actions.get(point, 0),
                 f"POINT_ACTIONS entry {point!r} is not a registered "
                 f"faultpoint")
    for point in sorted(known - set(actions)):
        line = registry.get("KNOWN_POINTS", {}).get(
            point, registry.get("RUNNER_POINTS", {}).get(point, 0))
        out.emit(fsup, faults_unit.path, "D3", line,
                 f"faultpoint {point!r} has no POINT_ACTIONS row: no "
                 f"action is legal at it, so scenarios naming it are "
                 f"rejected at parse")

    # D4: every analysis rule has its row in the README port section
    arch = doc if doc is not None \
        else os.path.join(os.path.dirname(base), "README.md")
    if os.path.exists(arch):
        with open(arch, "r", encoding="utf-8") as f:
            table = port_section(f.read())
        from .lint import RULES as _LINT_RULES
        from .protocol import PASS_RULES as _P_RULES
        from .tracecheck import PASS_RULES as _T_RULES
        all_rules = {}
        all_rules.update(_LINT_RULES)
        all_rules.update(_P_RULES)
        all_rules.update(_T_RULES)
        all_rules.update(PASS_RULES)
        for rule_id in sorted(all_rules,
                              key=lambda r: (r[0], int(r[1:]))):
            if not re.search(rf"^\|\s*{rule_id}\b", table, re.M):
                out.findings.append(Finding(
                    arch, 1, "D4",
                    f"analysis rule {rule_id} ({all_rules[rule_id]!r}) "
                    f"has no row in the README port section's rule "
                    f"table"))

    return sorted(out.findings, key=lambda f: (f.path, f.line, f.rule))
