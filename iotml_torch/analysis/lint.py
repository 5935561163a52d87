"""AST lint pass — repo-specific concurrency & protocol invariants.

The port's copy of the JAX package's ``analysis/lint.py``: the same
rule ids, suppressions and ``path:line: RULE message`` findings, with
path-scoped rules keyed on the package-relative path (``stream/``,
``store/``, ``twin/``... mean the port's directories) and messages that
name the port's paths.

Rules (the README's port section has the full table):

  R1  no non-monotonic clocks: ``time.time()`` is forbidden in the
      stream/mqtt wire, broker and replica modules — deadlines and
      timeouts there must use ``time.monotonic()`` (a wall-clock step,
      e.g. NTP, must never extend or collapse a protocol timeout).
      Legitimate wall-clock reads (record timestamps, uptime stats)
      carry ``# wallclock-ok: <reason>``.
  R2  every ``KafkaWireBroker._request`` call site must name an API
      from the IDEMPOTENT_APIS allowlist *by constant name* or carry a
      ``# retry-ok: <reason>`` justification acknowledging the
      non-idempotent delivery contract (the client auto-retries only
      allowlisted APIs after a reconnect; everything else surfaces
      ConnectionError — kafka_wire.py).
  R3  no bare ``.acquire()`` on locks: context-manager (``with``) only,
      so the runtime lockcheck sees every hold and release is
      exception-safe.
  R4  no blocking call (``recv``/``recv_into``/``recv_exact``/
      ``accept``/``sleep``/``select``) while a lock is held — checked
      by a call-graph walk within the module, so a helper that blocks
      three frames down is still caught.
  R5  engine-owned topics (``SENSOR_DATA_S_AVRO*``) may only be
      produced from ``streamproc/`` — the broker enforces this at
      runtime (Broker.restrict_topic); the lint closes it by
      construction.
  R6  metric families and trace span/stage names follow the lowercase
      snake_case convention (framework-owned names must match
      ``iotml_[a-z0-9_]+`` exactly), and span recording
      (``ctx.mark``/``ctx.close``/``tracing.start``/``tracing.flush``)
      must not happen while a lock is held — the trace collector is
      lock-free by contract (checked with R4's call-graph walk).
  R7  chaos faultpoint discipline: ``chaos.point()`` shims and
      ``iotml_torch.chaos`` imports may appear only in the allowlisted
      production modules (CHAOS_ALLOWED_MODULES), and those modules may
      import nothing from ``iotml_torch.chaos`` except the shim module
      ``faults`` — scenario/runner code (and its heavyweight deps) must
      never leak into hot paths, and new injection sites are a reviewed
      allowlist change, not a drive-by.
  R8  supervised-thread discipline: every ``threading.Thread(...)``
      constructed outside ``iotml_torch/supervise/`` must be ``daemon=True``,
      carry an explicit ``name=``, and be registered with the
      supervisor registry (wrapped in ``register_thread(...)``) — the
      self-healing runtime can only supervise what it can enumerate,
      and a fire-and-forget anonymous thread is exactly the erosion
      the supervise subsystem exists to stop.
  R9  durable-store write discipline: outside ``iotml_torch/store/``, no
      ``os.fsync`` at all, and no ``open()``/``os.open()`` whose
      arguments name a store path (identifiers like ``store_dir`` /
      ``store_path`` / segment paths) — every byte written under a
      store directory goes through ``store.segment.SegmentWriter``, so
      the durability promises (fsync accounting, torn-tail recovery
      semantics, atomic-rename publication) are made in exactly one
      place.  Extended to the REMOTE tier: segment blob uploads
      (``upload_segment``), ``.stage`` intent markers, ``tiered/``
      blob names and the tier manifest are ``store.remote.RemoteTier``'s
      alone — a foreign manifest write could commit torn blobs, which
      the stage → blobs → manifest-commit protocol exists to forbid.
  R11 model-registry write discipline (R9's story for model
      artifacts): outside ``iotml_torch/mlops/``, no ``open()``/``os.open()``
      or ``atomic_write()`` whose arguments name a registry path
      (``registry_dir`` / ``registry_root`` / ``version_dir`` /
      ``artifact_path`` / ``manifest.json``) — every byte under a
      registry goes through ``mlops.registry.ModelRegistry`` (the one
      writer), or the manifest-as-commit-marker recovery contract (a
      version is committed IFF its manifest parses) silently breaks.
  R12 compaction / twin-changelog write discipline: the ``CAR_TWIN``
      changelog has ONE writer (``iotml_torch/twin/``'s TwinService — a
      foreign producer corrupts every rebuild), and the segment
      compaction rewrite machinery (``compact_log`` / ``sweep_cleaned``
      / any write on a ``.cleaned`` rewrite path) is
      ``iotml_torch/store/``-internal — everyone else triggers compaction
      through ``Broker.run_compaction`` so the swap protocol, the
      broker lock and the crash-safety story live in exactly one place.
  R15 ISR / quorum-HWM mutation discipline (R9/R11/R12's story for
      replicated durability): the in-sync-replica set and the quorum
      high-water mark are mutated ONLY inside ``iotml_torch/replication/``
      (``register_follower`` / ``unregister_follower`` /
      ``evict_stale``), and the two wire-ingress calls —
      ``observe_fetch`` (follower positions entering the ISR) and
      ``wait_replicated`` (the acks=all quorum wait) — may additionally
      appear in ``stream/kafka_wire.py``, where the protocol lands.
      A foreign mutation would let acks=all ack records a failover can
      lose (the exact loss the quorum exists to rule out).

Suppression: append ``# lint-ok: RN <reason>`` to the flagged line (for
R4, to the ``with`` line holding the lock).  A suppression WITHOUT a
reason is itself a finding — justifications are the point.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .program import FileUnit, Program, iter_py_files

# APIs the wire client may auto-retry after a reconnect: a duplicate of
# any of these is invisible (reads) or a no-op (liveness signal).  Kept
# in sync with the port's stream/kafka_wire.IDEMPOTENT_APIS by
# tests/test_torch_analysis.py and by the protocol pass's P5.
IDEMPOTENT_API_NAMES = frozenset({
    "FETCH", "RAW_FETCH", "METADATA", "LIST_OFFSETS", "OFFSET_FETCH",
    "API_VERSIONS", "SASL_HANDSHAKE", "HEARTBEAT", "FIND_COORDINATOR",
})

# R5: topics written exclusively by the stream-proc engine (the AVRO leg
# and everything derived from it) — prefix match, like the broker's
# runtime restriction.
ENGINE_OWNED_TOPIC_PREFIXES = ("SENSOR_DATA_S_AVRO",)

# R4: calls that park the thread.  Send-side calls (sendall) are
# deliberately not listed: writing under a write-lock is the normal way
# to keep frames atomic, and the kernel buffer usually absorbs it.
BLOCKING_CALLS = frozenset({
    "recv", "recv_into", "recv_exact", "accept", "sleep", "select",
})

# R1 applies to modules under these path segments (the wire/broker/
# replica/timeout paths); the rest of the tree may use wall clocks.
R1_PATH_SEGMENTS = ("stream", "mqtt")

# R7: the only production modules that may compile in chaos faultpoints
# (matched on the trailing (package, file) of the path), and the only
# chaos module they may import.  Files under an iotml_torch/chaos/ directory
# are the subsystem itself and exempt.
CHAOS_ALLOWED_MODULES = frozenset({
    ("stream", "kafka_wire.py"), ("stream", "broker.py"),
    ("stream", "replica.py"), ("mqtt", "broker.py"),
    ("serve", "scorer.py"), ("train", "live.py"),
    ("mlops", "checkpoint.py"), ("mlops", "registry.py"),
    ("store", "compact.py"), ("online", "learner.py"),
    ("store", "remote.py"),
})
CHAOS_SHIM_MODULE = "faults"
# Drill-harness modules outside chaos/supervise: live-drill peers of
# chaos.runner (they arm engines / reuse its Invariant machinery against
# real platforms), exempt from R7 exactly like the supervise drills.
CHAOS_HARNESS_MODULES = frozenset({
    ("mlops", "drill.py"), ("mlops", "__main__.py"),
    ("twin", "drill.py"), ("twin", "__main__.py"),
    ("online", "drill.py"), ("online", "__main__.py"),
    ("replication", "drill.py"), ("replication", "__main__.py"),
    ("obs", "drill.py"), ("obs", "__main__.py"),
    ("gateway", "drill.py"), ("gateway", "__main__.py"),
})

# R6 (naming): metric families and span/stage names are lowercase
# snake_case; framework-owned names (iotml-prefixed) must follow the
# full `iotml_[a-z0-9_]+` convention.  Reference-parity families
# (mqtt_*, kafka_extension_*, agent_*, com_hivemq_* — the names the
# reference's Grafana dashboards chart) are lowercase snake too, so
# they pass; what the rule rejects is uppercase, dashes, dots and a
# malformed iotml prefix — names Prometheus relabeling and the span
# CLI's aggregation would silently fork on.
_METRIC_FACTORY_CALLS = frozenset({"counter", "gauge", "histogram"})
_SPAN_LITERAL_CALLS = frozenset({"mark", "close"})  # TraceContext methods
_TRACING_MODULE_CALLS = frozenset({"start", "flush", "liveness"})
_SNAKE_NAME_RE = re.compile(r"[a-z][a-z0-9_]*\Z")
_IOTML_NAME_RE = re.compile(r"iotml_[a-z0-9_]+\Z")
# R6 label vocabulary: metric labels at .inc/.set/.observe/
# .time call sites must come from the CLOSED key set mirrored in
# obs.metrics.ALLOWED_LABEL_KEYS.  Labels multiply series — one key
# drawn from an unbounded domain (a car id, a trace id, an offset)
# turns a fixed-cost scrape into an unbounded allocation, so a new
# label key is a reviewed vocabulary change, not a drive-by.
_METRIC_RECORD_CALLS = frozenset({"inc", "observe", "set", "time"})
_ALLOWED_METRIC_LABELS = frozenset({
    "stage", "topic", "partition", "group", "phase", "loop", "process",
    "component", "detector", "action", "fault", "source", "outcome",
    "unit", "le", "slo", "window", "shard", "route", "code",
})

RULES: Dict[str, str] = {
    "R1": "non-monotonic clock (time.time) in wire/broker/replica code; "
          "use time.monotonic() or annotate '# wallclock-ok: <reason>'",
    "R2": "_request call site must name an IDEMPOTENT_APIS constant or "
          "carry '# retry-ok: <reason>'",
    "R3": "bare Lock.acquire(); hold locks via 'with' only",
    "R4": "blocking call while a lock is held (module call-graph walk)",
    "R5": "engine-owned topic produced outside streamproc/",
    "R6": "metric/span name violates the iotml_[a-z0-9_]+ naming "
          "convention, or a span is recorded while a lock is held",
    "R7": "chaos shim (chaos.point / iotml_torch.chaos import) outside the "
          "faultpoint allowlist, or a production import of a chaos "
          "module other than the shim (iotml_torch.chaos.faults)",
    "R8": "threading.Thread outside iotml_torch/supervise/ must be daemon, "
          "named, and wrapped in register_thread(...) (supervisor "
          "registry)",
    "R9": "naked store-dir write (os.fsync, or open()/os.open() on a "
          "store path) outside iotml_torch/store/: all store-dir bytes go "
          "through SegmentWriter; remote-tier writes (upload_segment, "
          ".stage markers, tiered/ blobs, the tier manifest) go "
          "through RemoteTier",
    "R10": "direct broker-instance addressing outside iotml_torch/cluster/ "
           "(ShardBroker(...) construction, or subscripting a "
           "controller's .brokers/.servers/.serving/.replicas): clients "
           "route via PartitionMap / ClusterClient",
    "R11": "naked model-registry write (open()/os.open()/atomic_write() "
           "on a registry path) outside iotml_torch/mlops/: all registry "
           "bytes go through ModelRegistry (manifest-as-commit-marker "
           "recovery depends on the one-writer discipline)",
    "R12": "twin-changelog produce outside iotml_torch/twin/ (CAR_TWIN has "
           "one writer: TwinService), or compaction rewrite machinery "
           "(compact_log / sweep_cleaned / a write on a .cleaned path) "
           "outside iotml_torch/store/: compact via Broker.run_compaction",
    "R13": "in-place .set_params(...) on a serving scorer outside "
           "iotml_torch/mlops/ & iotml_torch/online/: model updates go "
           "THROUGH the registry (versioning, rollback gate, swap "
           "metrics) — "
           "a direct weight poke is an unversioned deploy nothing can "
           "roll back",
    "R15": "ISR-set / quorum-HWM mutation (register_follower / "
           "unregister_follower / evict_stale) outside "
           "iotml_torch/replication/, or the wire-ingress calls "
           "(observe_fetch / wait_replicated) outside "
           "iotml_torch/replication/ + stream/kafka_wire.py: a foreign "
           "mutation lets acks=all ack records a failover can lose",
    "R14": "frame parsing OR encoding (the [len|crc|attrs|offset|ts|"
           "key|value|headers] layout: scan_records / iter_frames / "
           "decode_record / encode_record, the >IBqqi head struct, or "
           "a direct iotml_frames_* native-symbol call) outside "
           "iotml_torch/store/ + iotml_torch/ops/framing.py (+ "
           "stream/native.py for the ctypes binding): the segmented "
           "log's frame is the "
           "ONE wire→disk→host contract with ONE codec — consume raw "
           "batches via Broker.fetch_raw + FrameDecoder, produce them "
           "via ops.framing helpers / RawBatchProducer",
    "R16": "direct TwinTable access outside iotml_torch/twin/ + "
           "iotml_torch/gateway/ (TwinTable(...) construction, "
           ".apply_changelog(...), or reaching through a service's "
           ".table): the materialised twin has two legal holders — "
           "TwinService and the gateway's standby/serving plane; "
           "everyone else queries via TwinService / TwinFeatureStore / "
           "GatewayClient, or a foreign mutation forks state the "
           "changelog can never rebuild",
}

# R14: the segment frame codec's entry points, and the frame-head
# struct format that marks a hand-rolled parser.  Same conservative
# name-matching as R9/R11 (a false positive justifies itself with a
# suppression).
_FRAME_PARSER_CALLS = frozenset({"scan_records", "iter_frames",
                                 "decode_record", "encode_record"})
# R14 write-path extension: the frame engine's native
# symbols may be bound/called ONLY by iotml_torch/stream/native.py (the one
# ctypes binding) and the exempt frame owners — a direct ctypes call
# elsewhere is a second frame codec in disguise.
_FRAME_NATIVE_SYMBOLS = frozenset({
    "iotml_frames_decode_columnar", "iotml_frames_encode_columnar",
    "iotml_frames_encode_values", "iotml_frames_restamp",
    "iotml_frames_validate"})
_FRAME_HEAD_RE = re.compile(r"IBqqi")
_STRUCT_CALLS = frozenset({"Struct", "pack", "unpack", "unpack_from",
                           "pack_into"})

# R12: the compacted twin-changelog topics whose produce is confined to
# iotml_torch/twin/, the store-internal compaction entry points, and the
# rewrite-tmp path marker (same conservative name-matching as R9/R11).
_TWIN_CHANGELOG_TOPICS = frozenset({"CAR_TWIN"})
# R12 extension: the telemetry plane's log topics have one
# writer family too — the obs package (FleetCollector's snapshot
# changelog, TsdbAppender's chunk stream, SloEngine's alert
# transitions).  A foreign producer forks the very history the SLO
# engine alerts FROM.
_OBS_TELEMETRY_TOPICS = frozenset({
    "_IOTML_METRICS", "_IOTML_TSDB", "_IOTML_ALERTS"})
_OBS_TOPIC_BY_NAME = {
    "METRICS_TOPIC": "_IOTML_METRICS",
    "TSDB_TOPIC": "_IOTML_TSDB",
    "ALERTS_TOPIC": "_IOTML_ALERTS"}
_COMPACT_WRITE_CALLS = frozenset({"compact_log", "sweep_cleaned"})
_CLEANED_PATH_RE = re.compile(r"\.cleaned|CLEANED_SUFFIX")

# R15: the replication state's mutating entry points.  `observe_fetch`
# is additionally allowed in stream/kafka_wire.py (the wire server is
# where follower fetch positions enter the system); everything else is
# iotml_torch/replication/-internal.  Same conservative name-matching as
# R9/R11/R12 — a false positive justifies itself with a suppression.
_ISR_MUTATION_CALLS = frozenset({
    "register_follower", "unregister_follower", "evict_stale"})
_ISR_INGRESS_CALLS = frozenset({"observe_fetch", "wait_replicated"})

# R10: the cluster-internal collections whose per-instance subscripting
# outside the package bypasses PartitionMap routing (and with it the
# NOT_LEADER + epoch-fencing invariants).  The chaos/supervise drill
# harnesses are exempt — proving failover requires touching the victim.
_R10_COLLECTIONS = frozenset({"brokers", "servers", "serving", "replicas"})

# R16: the TwinTable surface reachable through a service's `.table`
# attribute.  `apply_changelog` is caught at the call site, so the
# attribute-chain check covers the rest of the table API (same
# conservative name-matching as R9/R11/R12 — a false positive
# justifies itself with a suppression).
_TWIN_TABLE_ATTRS = frozenset({"apply", "snapshot", "resume_offsets",
                               "twins", "cars", "get"})

# R9: identifier substrings that mark an open() argument as a store
# path.  Conservative by construction (names, not data flow) — matching
# errs toward flagging, and a false positive justifies itself with a
# suppression, the lint's usual direction.
_STORE_PATH_NAME_RE = re.compile(
    r"store_dir|store_path|storedir|segment_path|\.slog\b", re.IGNORECASE)

# R9 (tier extension): remote-tier write surfaces.  Blob names under
# the remote "tiered/" prefix, ".stage" intent markers and the remote
# tier manifest are written ONLY by store.remote.RemoteTier — a foreign
# writer could commit a manifest entry for torn blobs, the exact state
# the stage -> blobs -> manifest-commit protocol exists to rule out.
# Same conservative name-matching as the store-path regex above.
_TIER_PATH_NAME_RE = re.compile(
    r"tiered/|\.stage\b|remote_tier|tier_manifest", re.IGNORECASE)
#: RemoteTier's mutating entry points — calling one outside the store
#: package is a remote-tier write regardless of argument spelling.
_TIER_WRITE_CALLS = frozenset({"upload_segment"})

# R11: identifier substrings marking an open()/atomic_write() argument
# as a model-registry path.  Same conservative name-based matching as
# R9 (flagging errs toward a justified suppression, not silence).
_REGISTRY_PATH_NAME_RE = re.compile(
    r"registry_dir|registry_root|version_dir|artifact_path"
    r"|manifest\.json|model_registry", re.IGNORECASE)

# [A-Z]\d+ not R\d: two-digit rules exist since R10, and the
# single-digit form silently failed to parse their suppressions (the
# lint-ok line then neither suppressed nor flagged-as-reasonless — it
# just lied); the letter class covers the whole-program passes' finding
# families too (P* protocol, T* tracecheck, D* drift) so one
# suppression mechanism serves every pass
_SUPPRESS_RE = re.compile(r"#\s*lint-ok:\s*([A-Z]\d+)\b[ \t]*(.*)")
_RETRY_OK_RE = re.compile(r"#\s*retry-ok:[ \t]*(.*)")
_WALLCLOCK_RE = re.compile(r"#\s*wallclock-ok:[ \t]*(.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


class _Suppressions:
    """Per-file suppression comments, and the findings malformed ones
    produce (a suppression without a reason is flagged, not honored)."""

    def __init__(self, path: str, source: str):
        self.by_rule: Dict[str, Set[int]] = {}
        self.retry_ok: Set[int] = set()
        self.wallclock_ok: Set[int] = set()
        self.findings: List[Finding] = []
        self.comment_only: Set[int] = set()
        for i, text in enumerate(source.splitlines(), start=1):
            if text.lstrip().startswith("#"):
                self.comment_only.add(i)
            m = _SUPPRESS_RE.search(text)
            if m:
                rule, reason = m.group(1), m.group(2).strip()
                if not reason:
                    self.findings.append(Finding(
                        path, i, rule,
                        "suppression without justification: write "
                        f"'# lint-ok: {rule} <why this is safe>'"))
                else:
                    self.by_rule.setdefault(rule, set()).add(i)
            m = _RETRY_OK_RE.search(text)
            if m:
                if not m.group(1).strip():
                    self.findings.append(Finding(
                        path, i, "R2",
                        "retry-ok without justification: write "
                        "'# retry-ok: <redelivery story>'"))
                else:
                    self.retry_ok.add(i)
            m = _WALLCLOCK_RE.search(text)
            if m:
                if not m.group(1).strip():
                    self.findings.append(Finding(
                        path, i, "R1",
                        "wallclock-ok without justification: write "
                        "'# wallclock-ok: <why wall time is correct>'"))
                else:
                    self.wallclock_ok.add(i)

    def _effective_lines(self, node: ast.AST) -> Iterable[int]:
        """The node's own span, plus the contiguous pure-comment block
        immediately above it — where multi-line justifications live."""
        first = node.lineno
        last = getattr(node, "end_lineno", first)
        lines = list(range(first, last + 1))
        ln = first - 1
        while ln in self.comment_only:
            lines.append(ln)
            ln -= 1
        return lines

    def suppressed(self, rule: str, node: ast.AST) -> bool:
        marked = self.by_rule.get(rule, set())
        if rule == "R1":
            marked = marked | self.wallclock_ok
        return any(ln in marked for ln in self._effective_lines(node))

    def retry_justified(self, node: ast.AST) -> bool:
        return any(ln in self.retry_ok
                   for ln in self._effective_lines(node))


def _call_name(node: ast.Call) -> Optional[str]:
    """Terminal name of the called thing: foo() → foo, a.b.foo() → foo."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return None


def _is_time_time(node: ast.Call) -> bool:
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr == "time"
            and isinstance(f.value, ast.Name) and f.value.id == "time")


def _is_thread_ctor(node: ast.Call) -> bool:
    """``<any name>.Thread(...)`` or a bare imported ``Thread(...)``.
    Matching ANY module name (not just ``threading``) closes the
    ``import threading as t; t.Thread(...)`` evasion — conservative in
    the lint's usual direction: flag, and let a false positive justify
    itself with a suppression."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr == "Thread" and isinstance(f.value, ast.Name)
    return isinstance(f, ast.Name) and f.id == "Thread"


def _lockish_name(expr: ast.expr) -> Optional[str]:
    """Terminal identifier of a with-item if it names a lock."""
    e = expr
    if isinstance(e, ast.Call):  # e.g. broker.producer_grant(tok) — not a lock
        return None
    name = None
    if isinstance(e, ast.Attribute):
        name = e.attr
    elif isinstance(e, ast.Name):
        name = e.id
    if name is not None and "lock" in name.lower():
        return name
    return None


def _str_arg0(node: ast.Call) -> Optional[str]:
    """First positional argument when it is a string literal."""
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def _is_tracing_module_call(node: ast.Call) -> bool:
    """``tracing.start(...)`` / ``tracing.flush()`` style module calls."""
    f = node.func
    return (isinstance(f, ast.Attribute) and f.attr in _TRACING_MODULE_CALLS
            and isinstance(f.value, ast.Name) and f.value.id == "tracing")


def _span_call_reason(node: ast.Call, name: Optional[str]) -> Optional[str]:
    """The R6 under-lock predicate: 'records a span (...)' or None.

    Span-recording shapes: a TraceContext method with a string-literal
    stage (``ctx.mark("decode")``, ``ctx.close("score")``) or a call on
    the tracing module (``tracing.start(...)``, ``tracing.flush()``).
    The literal-argument requirement keeps generic ``.close()`` /
    ``.mark()`` methods of unrelated objects out of the rule."""
    if name in _SPAN_LITERAL_CALLS and isinstance(node.func, ast.Attribute) \
            and _str_arg0(node) is not None:
        return f"records a span ({name}({_str_arg0(node)!r}))"
    if _is_tracing_module_call(node):
        return f"records a span (tracing.{node.func.attr}())"
    return None


# --------------------------------------------------------------- R4 engine
class _ModuleCallGraph:
    """Module-local may-block analysis.

    Functions are indexed by bare name (methods too — self-dispatch within
    a module resolves by name; cross-class collisions make the analysis
    conservative, which errs toward flagging).  A function "may block" if
    its body contains a BLOCKING_CALLS call or a call to a module function
    that (transitively) may block.
    """

    def __init__(self, tree: ast.Module):
        self.bodies: Dict[str, ast.AST] = {}
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # first definition wins; duplicates would only make the
                # result depend on dict order
                self.bodies.setdefault(node.name, node)
        # one memo per predicate kind: "block" (R4) and "span" (R6)
        self._memos: Dict[str, Dict[str, Optional[str]]] = {
            "block": {}, "span": {}}

    @staticmethod
    def _block_pred(node: ast.Call, name: Optional[str]) -> Optional[str]:
        if name in BLOCKING_CALLS:
            return f"calls blocking {name}()"
        return None

    @staticmethod
    def _span_pred(node: ast.Call, name: Optional[str]) -> Optional[str]:
        return _span_call_reason(node, name)

    def blocking_reason(self, func_name: str) -> Optional[str]:
        """None, or 'calls recv (net.py-style helper chain)' style text."""
        return self._reason(func_name, "block", self._block_pred)

    def span_reason(self, func_name: str) -> Optional[str]:
        """None, or the span-recording chain — the same transitive walk
        R4 uses, with the R6 predicate."""
        return self._reason(func_name, "span", self._span_pred)

    def _reason(self, func_name: str, kind: str, pred,
                _visiting: Optional[Set[str]] = None) -> Optional[str]:
        memo = self._memos[kind]
        if func_name in memo:
            return memo[func_name]
        body = self.bodies.get(func_name)
        if body is None:
            return None
        _visiting = _visiting or set()
        if func_name in _visiting:
            return None  # recursion: already being decided
        _visiting.add(func_name)
        memo[func_name] = None  # break cycles pessimistically-clean
        reason = None
        for node in ast.walk(body):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            direct = pred(node, name)
            if direct:
                reason = f"{func_name}() {direct}"
                break
            if name and name != func_name and name in self.bodies:
                inner = self._reason(name, kind, pred, _visiting)
                if inner:
                    reason = f"{func_name}() -> {inner}"
                    break
        memo[func_name] = reason
        return reason


# ----------------------------------------------------------------- checker
class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, tree: ast.Module,
                 sup: _Suppressions, rules: Set[str],
                 graph: Optional[_ModuleCallGraph] = None):
        self.path = path
        self.rel = rel
        self.sup = sup
        self.rules = rules
        self.findings: List[Finding] = list(sup.findings)
        if graph is None and rules & {"R4", "R6"}:
            graph = _ModuleCallGraph(tree)
        self.graph = graph
        parts = rel.replace(os.sep, "/").split("/")
        self.r1_scoped = any(seg in parts for seg in R1_PATH_SEGMENTS)
        self.in_streamproc = "streamproc" in parts
        # R7 scoping: the chaos package itself is exempt, and so is the
        # supervise package — its live drills are the threaded peer of
        # chaos.runner (harness code arming engines against real
        # platforms), not a hot path
        self.in_chaos = "chaos" in parts or "supervise" in parts or (
            len(parts) >= 2 and (parts[-2], parts[-1])
            in CHAOS_HARNESS_MODULES)
        self.chaos_allowed = self.in_chaos or (
            len(parts) >= 2 and (parts[-2], parts[-1])
            in CHAOS_ALLOWED_MODULES)
        # R8 scoping: the supervise package OWNS thread lifecycles (the
        # registry itself, the monitor) and is exempt from wrapping
        self.in_supervise = "supervise" in parts
        # R10 scoping: the cluster package owns broker instances; the
        # chaos/supervise drill harnesses may address victims directly
        self.r10_exempt = "cluster" in parts or self.in_chaos
        # R9 scoping: the store package OWNS the bytes (SegmentWriter,
        # atomic_write) and is the one place fsync may appear
        self.in_store = "store" in parts
        # R14 scoping: the store package plus ops/framing.py (the frame
        # contract's stream-layer half, whose helpers delegate to the
        # store codec) are the only frame parsers/encoders
        self.r14_exempt = self.in_store or (
            len(parts) >= 2 and (parts[-2], parts[-1])
            == ("ops", "framing.py"))
        # ...and stream/native.py additionally holds the ONE ctypes
        # binding of the frame engine's native symbols
        self.r14_native_exempt = self.r14_exempt or (
            len(parts) >= 2 and (parts[-2], parts[-1])
            == ("stream", "native.py"))
        # R11 scoping: the mlops package owns registry bytes
        self.in_mlops = "mlops" in parts
        # R15 scoping: the replication package owns the ISR set and
        # the quorum HWM; the wire server holds the ONE ingress where
        # follower fetch positions are observed
        self.in_replication = "replication" in parts
        self.r15_ingress = self.in_replication or (
            len(parts) >= 2 and (parts[-2], parts[-1])
            == ("stream", "kafka_wire.py"))
        # R12 scoping: the twin package owns the CAR_TWIN changelog;
        # the obs package owns the telemetry-plane topics
        # (_IOTML_METRICS / _IOTML_TSDB / _IOTML_ALERTS)
        self.in_twin = "twin" in parts
        self.in_obs = "obs" in parts
        # R16 scoping: the twin package owns the TwinTable, and the
        # gateway's standby/serving plane is its second legal holder
        # (a standby IS a continuously-rebuilt table); the chaos/
        # supervise drill harnesses may snapshot victims directly
        self.r16_exempt = self.in_twin or "gateway" in parts \
            or self.in_chaos
        # R13 scoping: the registry machinery (mlops watchers/rollouts)
        # and the online learner's adaptation path are the two places a
        # scorer's weights may legally be set in place — everything
        # else deploys through the registry
        self.r13_exempt = self.in_mlops or "online" in parts
        #: Thread(...) call nodes already seen as a register_thread(...)
        #: argument — outer calls visit before inner ones, so by the
        #: time visit_Call reaches the Thread node it is marked
        self._registered_threads: Set[int] = set()
        self._lock_stack: List[Tuple[str, int, bool]] = []  # (name, line, suppressed)

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule not in self.rules or self.sup.suppressed(rule, node):
            return
        self.findings.append(Finding(self.path, node.lineno, rule, message))

    # ----------------------------------------------------------- R7 imports
    def _check_chaos_import(self, node: ast.AST, dotted: str,
                            names: Optional[List[str]] = None) -> None:
        """`dotted` is the imported module path (relative dots stripped);
        `names` the from-import aliases (None for a plain import)."""
        segs = [s for s in dotted.split(".") if s]
        if "chaos" in segs and not self.in_chaos:
            if not self.chaos_allowed:
                self._emit("R7", node,
                           "iotml_torch.chaos import outside the faultpoint "
                           "allowlist (CHAOS_ALLOWED_MODULES): injection "
                           "sites are a reviewed allowlist change")
            elif not (segs[-1] == CHAOS_SHIM_MODULE
                      or (segs[-1] == "chaos" and names is not None
                          and all(n == CHAOS_SHIM_MODULE for n in names))):
                self._emit("R7", node,
                           "production code may import nothing from "
                           "iotml_torch.chaos except the shim module "
                           f"'{CHAOS_SHIM_MODULE}' — scenario/runner "
                           "code must not leak into hot paths")

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        names = [a.name for a in node.names]
        self._check_chaos_import(node, node.module or "", names)
        # the evasion form: `from iotml_torch import chaos` / `from .. import
        # chaos` carries the package in the ALIAS list, not the module
        # path — importing the package (rather than the shim) is a
        # violation everywhere outside the subsystem itself
        segs = [s for s in (node.module or "").split(".") if s]
        if "chaos" not in segs and "chaos" in names and not self.in_chaos:
            self._emit("R7", node,
                       "importing the iotml_torch.chaos package itself: "
                       "production code may import only the shim module "
                       f"('{CHAOS_SHIM_MODULE}'), and only in "
                       "CHAOS_ALLOWED_MODULES")
        self.generic_visit(node)

    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self._check_chaos_import(node, alias.name)
        self.generic_visit(node)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # R10 — `<x>.brokers[i]` / `.servers[i]` / `.serving[i]` /
        # `.replicas[i]`: picking a broker instance by index outside the
        # cluster package bypasses PartitionMap routing — and with it
        # the NOT_LEADER re-route and epoch-fencing invariants
        v = node.value
        if not self.r10_exempt and isinstance(v, ast.Attribute) \
                and v.attr in _R10_COLLECTIONS:
            self._emit("R10", node,
                       f"direct broker-instance addressing "
                       f"(.{v.attr}[...]) outside iotml_torch/cluster/: "
                       f"route via PartitionMap / ClusterClient")
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        # R16 — reaching through a service's `.table` to the TwinTable
        # API outside the twin/gateway planes: serving raw table state
        # bypasses the owner's locking and the provenance the
        # changelog's crash story depends on
        v = node.value
        if not self.r16_exempt and isinstance(v, ast.Attribute) \
                and v.attr == "table" and node.attr in _TWIN_TABLE_ATTRS:
            self._emit("R16", node,
                       f"direct TwinTable access (.table.{node.attr}) "
                       "outside iotml_torch/twin/ + iotml_torch/gateway/: "
                       "query via TwinService / TwinFeatureStore / "
                       "GatewayClient")
        self.generic_visit(node)

    # R4 needs with-scope tracking, so visit With explicitly
    def visit_With(self, node: ast.With) -> None:
        held = []
        for item in node.items:
            name = _lockish_name(item.context_expr)
            if name is not None:
                held.append((name, node.lineno,
                             self.sup.suppressed("R4", node)))
        self._lock_stack.extend(held)
        self.generic_visit(node)
        del self._lock_stack[len(self._lock_stack) - len(held):]

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node)

        # R1 — wall clock in wire/broker/replica code
        if self.r1_scoped and _is_time_time(node):
            self._emit("R1", node,
                       "time.time() in wire/broker/replica code: use "
                       "time.monotonic() for deadlines/timeouts, or "
                       "annotate '# wallclock-ok: <reason>' for real "
                       "wall-clock reads (timestamps, uptime)")

        # R2 — _request call sites
        if name == "_request" and isinstance(node.func, ast.Attribute):
            api = node.args[0] if node.args else None
            api_name = api.id if isinstance(api, ast.Name) else None
            if api_name not in IDEMPOTENT_API_NAMES \
                    and not self.sup.retry_justified(node):
                shown = api_name or ast.unparse(api) if api else "<missing>"
                self._emit("R2", node,
                           f"_request({shown}, ...) is not on the "
                           "IDEMPOTENT_APIS allowlist: a reconnect will NOT "
                           "auto-retry it; add '# retry-ok: <redelivery "
                           "story>' acknowledging the contract")

        # R3 — bare acquire
        if name == "acquire" and isinstance(node.func, ast.Attribute):
            self._emit("R3", node,
                       "bare .acquire(): hold locks with 'with <lock>:' so "
                       "release is exception-safe and the runtime lockcheck "
                       "sees the hold")

        # R4 — blocking under a held lock
        if self._lock_stack and name is not None:
            active = [(n, ln) for n, ln, suppressed in self._lock_stack
                      if not suppressed]
            if active:
                reason = None
                if name in BLOCKING_CALLS:
                    reason = f"blocking {name}()"
                elif self.graph is not None and name in self.graph.bodies:
                    inner = self.graph.blocking_reason(name)
                    if inner:
                        reason = inner
                if reason is not None:
                    lock_name, lock_line = active[-1]
                    self._emit("R4", node,
                               f"{reason} while holding {lock_name} "
                               f"(acquired line {lock_line}): a stalled "
                               "peer parks every thread contending this "
                               "lock")
                # R6 — span recording under a held lock (same transitive
                # walk): the trace collector is lock-free by contract, so
                # a mark inside a critical section would smuggle exporter
                # work — and its latency — under a protocol lock
                sreason = _span_call_reason(node, name)
                if sreason is None and self.graph is not None \
                        and name in self.graph.bodies:
                    sreason = self.graph.span_reason(name)
                if sreason is not None:
                    lock_name, lock_line = active[-1]
                    self._emit("R6", node,
                               f"{sreason} while holding {lock_name} "
                               f"(acquired line {lock_line}): record "
                               "spans outside critical sections — the "
                               "collector is lock-free by design")

        # R6 — metric/span naming convention
        if name in _METRIC_FACTORY_CALLS and \
                isinstance(node.func, ast.Attribute):
            metric = _str_arg0(node)
            if metric is not None and not (
                    _SNAKE_NAME_RE.fullmatch(metric)
                    and (not metric.startswith("iotml")
                         or _IOTML_NAME_RE.fullmatch(metric))):
                self._emit("R6", node,
                           f"metric name {metric!r} violates the naming "
                           "convention: lowercase snake_case, and "
                           "framework-owned families must match "
                           "iotml_[a-z0-9_]+ exactly")
        stage = _str_arg0(node) if (
            (name in _SPAN_LITERAL_CALLS
             and isinstance(node.func, ast.Attribute))
            or _is_tracing_module_call(node)) else None
        if stage is not None and not _SNAKE_NAME_RE.fullmatch(stage):
            self._emit("R6", node,
                       f"span/stage name {stage!r} violates the naming "
                       "convention ([a-z][a-z0-9_]*): the span CLI and "
                       "the stage-label histograms aggregate by this "
                       "string")
        # R6 — metric LABEL vocabulary: keyword labels at metric record
        # sites must come from the closed set (see
        # obs.metrics.ALLOWED_LABEL_KEYS).  A runaway per-entity label
        # (car_id, trace, offset...) must fail here before it fails
        # production with an unbounded series explosion.
        if name in _METRIC_RECORD_CALLS and \
                isinstance(node.func, ast.Attribute) and node.keywords:
            for kw in node.keywords:
                if kw.arg is None:  # **labels passthrough: the metric
                    continue        # classes' own plumbing
                if kw.arg not in _ALLOWED_METRIC_LABELS:
                    self._emit("R6", node,
                               f"metric label {kw.arg!r} outside the "
                               "closed label vocabulary "
                               "(obs.metrics.ALLOWED_LABEL_KEYS): "
                               "unbounded label domains explode series "
                               "cardinality — extend the vocabulary "
                               "deliberately or drop the label")

        # R7 — faultpoint shim compiled outside the allowlist
        if name == "point" and not self.chaos_allowed \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("chaos", CHAOS_SHIM_MODULE) \
                and _str_arg0(node) is not None:
            self._emit("R7", node,
                       f"chaos.point({_str_arg0(node)!r}) outside the "
                       "faultpoint allowlist (CHAOS_ALLOWED_MODULES): "
                       "new injection sites are a reviewed allowlist "
                       "change, not a drive-by")

        # R8 — supervised-thread discipline.  Outer calls visit before
        # their argument nodes, so marking register_thread's Thread
        # argument here is always ahead of that Thread's own visit.
        if name == "register_thread":
            for arg in node.args:
                if isinstance(arg, ast.Call) and _is_thread_ctor(arg):
                    self._registered_threads.add(id(arg))
        if not self.in_supervise and _is_thread_ctor(node):
            kw = {k.arg: k.value for k in node.keywords}
            missing = []
            d = kw.get("daemon")
            if not (isinstance(d, ast.Constant) and d.value is True):
                missing.append("daemon=True")
            if "name" not in kw:
                missing.append("an explicit name=")
            if id(node) not in self._registered_threads:
                missing.append("a register_thread(...) wrapper "
                               "(iotml_torch.supervise.registry)")
            if missing:
                self._emit("R8", node,
                           "unsupervised thread: needs "
                           + ", ".join(missing)
                           + " — the self-healing runtime can only "
                             "supervise what it can enumerate")

        # R9 — durable-store write discipline: fsync is SegmentWriter's
        # alone, and an open() on a store path bypasses the frame/CRC/
        # fsync contract recovery depends on
        if not self.in_store:
            if name == "fsync":
                self._emit("R9", node,
                           "os.fsync outside iotml_torch/store/: durability "
                           "promises are made in one place — route the "
                           "write through store.segment.SegmentWriter")
            if name == "open":
                arg_src = " ".join(
                    ast.unparse(a) for a in list(node.args)
                    + [kw.value for kw in node.keywords])
                if _STORE_PATH_NAME_RE.search(arg_src):
                    self._emit("R9", node,
                               "naked open() on a store path outside "
                               "iotml_torch/store/: all bytes under a store "
                               "dir go through SegmentWriter (framing, "
                               "CRC, fsync accounting, recovery "
                               "semantics)")
            # tier extension: remote-tier writes (segment blob uploads,
            # .stage markers, the remote manifest) are RemoteTier's
            # alone — a foreign manifest write could reference torn
            # blobs, which the commit-marker protocol exists to forbid
            if name in _TIER_WRITE_CALLS:
                self._emit("R9", node,
                           "remote-tier segment upload outside "
                           "iotml_torch/store/: sealed segments reach the "
                           "object store only through RemoteTier's "
                           "stage -> blobs -> manifest-commit protocol")
            if name in ("open", "upload", "put_text", "atomic_write"):
                arg_src = " ".join(
                    ast.unparse(a) for a in list(node.args)
                    + [kw.value for kw in node.keywords])
                if _TIER_PATH_NAME_RE.search(arg_src):
                    self._emit("R9", node,
                               f"naked {name}() on a remote-tier path "
                               "(tiered/ blob, .stage marker, tier "
                               "manifest) outside iotml_torch/store/: the "
                               "remote tier has ONE writer, RemoteTier "
                               "— local bytes stay authoritative until "
                               "ITS manifest commit")

        # R11 — model-registry write discipline: registry bytes are
        # ModelRegistry's alone; a naked open/atomic_write on a registry
        # path bypasses the staged-rename + manifest-as-commit-marker
        # protocol that torn-publish recovery depends on
        if not self.in_mlops and name in ("open", "atomic_write"):
            arg_src = " ".join(
                ast.unparse(a) for a in list(node.args)
                + [kw.value for kw in node.keywords])
            if _REGISTRY_PATH_NAME_RE.search(arg_src):
                self._emit("R11", node,
                           f"naked {name}() on a model-registry path "
                           "outside iotml_torch/mlops/: all registry bytes "
                           "go through ModelRegistry (staged rename + "
                           "manifest commit marker + checksum; a "
                           "version is immutable once committed)")

        # R12 — compaction / twin-changelog write discipline.  First
        # half: CAR_TWIN (the twin's compacted changelog) has ONE
        # writer, TwinService — a foreign producer corrupts every
        # rebuild the changelog exists to make possible.
        if name in ("produce", "produce_many", "produce_batch"):
            topic = None
            topic_nodes = list(node.args)[:1] + [
                kw.value for kw in node.keywords if kw.arg == "topic"]
            for a in topic_nodes:
                if isinstance(a, ast.Constant) and \
                        isinstance(a.value, str):
                    topic = a.value
                elif isinstance(a, (ast.Name, ast.Attribute)):
                    const = a.id if isinstance(a, ast.Name) else a.attr
                    if const == "CHANGELOG_TOPIC":
                        topic = "CAR_TWIN"
                    elif const in _OBS_TOPIC_BY_NAME:
                        topic = _OBS_TOPIC_BY_NAME[const]
            if not self.in_twin and topic in _TWIN_CHANGELOG_TOPICS:
                self._emit("R12", node,
                           f"produce to twin changelog {topic!r} outside "
                           "iotml_torch/twin/: the changelog has one writer "
                           "(TwinService) — a foreign record corrupts "
                           "every rebuild that replays it")
            # telemetry-plane one-writer surface: the scrape
            # changelog, the TSDB chunk stream, and the alert log are
            # produced by the obs package alone — a foreign record
            # forks the history the SLO engine alerts from
            if not self.in_obs and topic in _OBS_TELEMETRY_TOPICS:
                self._emit("R12", node,
                           f"produce to telemetry topic {topic!r} "
                           "outside iotml_torch/obs/: the telemetry plane's "
                           "log topics have one writer family "
                           "(FleetCollector / TsdbAppender / SloEngine)")
        # Second half: the segment-rewrite machinery is store-internal;
        # compaction is triggered through Broker.run_compaction so the
        # swap protocol and its crash-safety live in one place
        if not self.in_store:
            if name in _COMPACT_WRITE_CALLS:
                self._emit("R12", node,
                           f"{name}() outside iotml_torch/store/: segment "
                           "compaction machinery is store-internal — "
                           "trigger it via Broker.run_compaction")
            if name in ("open", "atomic_write", "SegmentWriter"):
                arg_src = " ".join(
                    ast.unparse(a) for a in list(node.args)
                    + [kw.value for kw in node.keywords])
                if _CLEANED_PATH_RE.search(arg_src):
                    self._emit("R12", node,
                               f"{name}() on a .cleaned rewrite path "
                               "outside iotml_torch/store/: the compaction "
                               "swap protocol (durable tmp + atomic "
                               "os.replace + mount-time sweep) is the "
                               "store's alone")

        # R14 — ONE frame parser: the segment frame codec's entry
        # points (and any hand-rolled >IBqqi head struct) are confined
        # to iotml_torch/store/ + iotml_torch/ops/framing.py; everyone else
        # consumes raw batches through Broker.fetch_raw + FrameDecoder
        # or the ops.framing helpers, so the wire→disk→host contract
        # cannot fork
        if not self.r14_exempt:
            if name in _FRAME_PARSER_CALLS:
                self._emit("R14", node,
                           f"{name}() outside iotml_torch/store/ + "
                           "iotml_torch/ops/framing.py: the store frame "
                           "has ONE parser "
                           "— go through Broker.fetch_raw + "
                           "FrameDecoder (or ops.framing helpers)")
            if name in _STRUCT_CALLS:
                arg_src = " ".join(
                    ast.unparse(a) for a in list(node.args)
                    + [kw.value for kw in node.keywords])
                if _FRAME_HEAD_RE.search(arg_src):
                    self._emit("R14", node,
                               "hand-rolled frame-head struct "
                               "(>IBqqi) outside iotml_torch/store/ + "
                               "iotml_torch/ops/framing.py: the frame "
                               "layout is one contract with one "
                               "parser")
        if not self.r14_native_exempt and name in _FRAME_NATIVE_SYMBOLS:
            # write-path extension: a direct ctypes call on the frame
            # engine's symbols is a second frame codec in disguise —
            # the one binding lives in stream/native.py
            self._emit("R14", node,
                       f"direct native frame-codec call {name}() "
                       "outside iotml_torch/stream/native.py: frame "
                       "encoding/decoding goes through the bound "
                       "NativeCodec/FrameDecoder or ops.framing "
                       "helpers")

        # R15 — ISR / quorum-HWM mutation discipline: membership and
        # the quorum mark have one owner (iotml_torch/replication/), plus the
        # wire server's observe_fetch ingress.  A drive-by eviction or
        # admission would silently change what acks=all means.
        if not self.in_replication and name in _ISR_MUTATION_CALLS \
                and isinstance(node.func, ast.Attribute):
            self._emit("R15", node,
                       f"{name}() outside iotml_torch/replication/: the ISR "
                       "set and the quorum HWM are mutated in one "
                       "place — acks=all durability is only as strong "
                       "as the narrowest mutation path")
        if not self.r15_ingress and name in _ISR_INGRESS_CALLS \
                and isinstance(node.func, ast.Attribute):
            self._emit("R15", node,
                       f"{name}() outside iotml_torch/replication/ + "
                       "stream/kafka_wire.py: follower positions and "
                       "quorum waits enter through the wire server's "
                       "handlers only — a second ingress could admit "
                       "a replica that never fetched")

        # R13 — model updates go through the registry: an in-place
        # .set_params(...) on a serving scorer outside the mlops/online
        # machinery is an unversioned deploy — no registry id, no
        # rollback target, no swap metric, invisible to /healthz
        if not self.r13_exempt and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "set_params":
            self._emit("R13", node,
                       ".set_params(...) on a scorer outside "
                       "iotml_torch/mlops/ & iotml_torch/online/: publish the "
                       "weights as a registry version and let a "
                       "RegistryWatcher swap it (versioned, gated, "
                       "rollback-able)")

        # R16 — TwinTable one-owner discipline: constructing a table or
        # applying changelog records outside the twin/gateway planes
        # builds a twin nobody's changelog covers — a rebuild after a
        # crash silently disagrees with what was served
        if not self.r16_exempt:
            if name == "TwinTable":
                self._emit("R16", node,
                           "TwinTable(...) constructed outside "
                           "iotml_torch/twin/ + iotml_torch/gateway/: the "
                           "materialised twin is built by TwinService "
                           "or adopted through the gateway standby "
                           "plane — query via TwinService / "
                           "TwinFeatureStore / GatewayClient")
            if name == "apply_changelog" \
                    and isinstance(node.func, ast.Attribute):
                self._emit("R16", node,
                           ".apply_changelog(...) outside iotml_torch/twin/ "
                           "+ iotml_torch/gateway/: changelog replay is the "
                           "table owners' alone — a foreign apply "
                           "forks state the changelog can never "
                           "rebuild")

        # R10 — broker instances are the cluster package's to build:
        # constructing a ShardBroker elsewhere bypasses the controller's
        # ownership wiring (and the map that fences it)
        if not self.r10_exempt and name == "ShardBroker":
            self._emit("R10", node,
                       "ShardBroker(...) constructed outside "
                       "iotml_torch/cluster/: broker instances belong to the "
                       "ClusterController; clients route via "
                       "PartitionMap / ClusterClient")

        # R5 — engine-owned topic produced outside streamproc/
        if not self.in_streamproc and name in ("produce", "produce_many",
                                               "produce_batch"):
            topic = None
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                topic = node.args[0].value
            for kw in node.keywords:
                if kw.arg == "topic" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    topic = kw.value.value
            if topic is not None and \
                    topic.startswith(ENGINE_OWNED_TOPIC_PREFIXES):
                self._emit("R5", node,
                           f"produce to engine-owned topic {topic!r} outside "
                           "streamproc/: the AVRO leg is written exclusively "
                           "by the stream-proc engine (trusted_passthrough "
                           "soundness; Broker.restrict_topic enforces this "
                           "at runtime)")

        self.generic_visit(node)


# ---------------------------------------------------------- entry points
# directory walk relocated to program.py (shared with the whole-program
# passes); the old private name stays importable for callers/tests
_iter_py_files = iter_py_files


def suppressions_for(unit: FileUnit) -> _Suppressions:
    """The unit's suppression table — parsed once, shared across lint
    and the whole-program passes (one `# lint-ok:` mechanism)."""
    return unit.cached(
        "suppressions", lambda u: _Suppressions(u.path, u.source))


def call_graph_for(unit: FileUnit) -> Optional[_ModuleCallGraph]:
    """The unit's module-local call graph (R4's walker) — built once,
    shared with tracecheck/protocol/lockorder reachability walks."""
    if unit.tree is None:
        return None
    return unit.cached("callgraph", lambda u: _ModuleCallGraph(u.tree))


def lint_unit(unit: FileUnit,
              rules: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one pre-parsed unit (the parse-once entry point)."""
    rules = rules or set(RULES)
    if unit.tree is None:
        e = unit.parse_error
        return [Finding(unit.path, (e.lineno or 0) if e else 0, "PARSE",
                        f"syntax error: {e.msg if e else 'unparseable'}")]
    sup = suppressions_for(unit)
    graph = call_graph_for(unit) if rules & {"R4", "R6"} else None
    linter = _FileLinter(unit.path, unit.rel, unit.tree, sup, rules,
                         graph=graph)
    linter.visit(unit.tree)
    return sorted(linter.findings, key=lambda f: (f.path, f.line, f.rule))


def lint_file(path: str, rel: Optional[str] = None,
              rules: Optional[Set[str]] = None,
              program: Optional[Program] = None) -> List[Finding]:
    program = program if program is not None else Program()
    return lint_unit(program.unit(path, rel=rel if rel is not None
                                  else path), rules)


def lint_paths(paths: Iterable[str],
               rules: Optional[Set[str]] = None,
               program: Optional[Program] = None) -> List[Finding]:
    program = program if program is not None else Program()
    out: List[Finding] = []
    for unit in program.units(paths):
        out.extend(lint_unit(unit, rules))
    return out


def default_root() -> str:
    """The iotml_torch package directory this module is part of."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
