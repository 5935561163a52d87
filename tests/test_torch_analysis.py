"""The port's checker checked: iotml_torch.analysis against the JAX
package's seeded fixtures (tests/fixtures/analysis/, read and never
edited) case for case as tests/test_analysis.py holds iotml.analysis,
the same (rule, line) sets as the JAX passes on every fixture, a clean
port tree through the functions and the CLI, the torch hot-loop fixture
(tests/fixtures/torch_analysis/), the build guard on the CPU, the
runtime lock-order detector, the sanitizer target, and the repairs the
passes found (supervised threads, the SASL mechanism rejection)."""

import glob
import importlib
import importlib.util
import os
import shutil
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from iotml.analysis import drift as j_drift
from iotml.analysis import lint as j_lint
from iotml.analysis import protocol as j_protocol
from iotml_torch.analysis import drift as drift_mod
from iotml_torch.analysis import lint as lint_mod
from iotml_torch.analysis import lockcheck, lockorder
from iotml_torch.analysis import protocol as protocol_mod
from iotml_torch.analysis import tracecheck as trace_mod
from iotml_torch.analysis.lint import lint_file, lint_paths

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "analysis")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "torch_analysis")
REPO = os.path.dirname(HERE)
PY_FIXTURES = sorted(os.path.relpath(p, FIXTURES) for p in glob.glob(
    os.path.join(FIXTURES, "**", "*.py"), recursive=True))


def _rules_by_file(findings):
    out = {}
    for f in findings:
        out.setdefault(os.path.basename(f.path), set()).add(f.rule)
    return out


def _rule_counts(findings):
    out = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return out


def _rule_lines(findings):
    return sorted({(f.rule, f.line) for f in findings})


# ------------------------------------------------------------------ lint
def test_lint_flags_every_seeded_violation():
    by_file = _rules_by_file(lint_paths([FIXTURES]))
    assert by_file.get("bad_clock.py") == {"R1"}
    assert by_file.get("bad_acquire.py") == {"R3"}
    assert by_file.get("bad_retry.py") == {"R2"}
    assert by_file.get("bad_blocking.py") == {"R4"}
    assert by_file.get("bad_owned_topic.py") == {"R5"}
    assert by_file.get("bad_span_metric.py") == {"R6"}
    assert by_file.get("bad_chaos.py") == {"R7"}
    assert by_file.get("bad_thread.py") == {"R8"}
    assert by_file.get("bad_store.py") == {"R9"}
    assert by_file.get("bad_tier.py") == {"R9"}
    assert by_file.get("bad_cluster.py") == {"R10"}
    assert by_file.get("bad_ckpt.py") == {"R11"}
    assert by_file.get("bad_twin.py") == {"R12"}
    assert by_file.get("bad_online.py") == {"R13"}
    assert by_file.get("bad_frame.py") == {"R14"}
    assert by_file.get("bad_isr.py") == {"R15"}
    assert by_file.get("bad_gateway.py") == {"R16"}
    # a reason-less suppression is itself a finding AND does not suppress
    assert by_file.get("bad_suppression.py") == {"R3"}
    # the runtime fixture is lint-clean (locks held via `with` only)
    assert "lock_cycle.py" not in by_file


def test_lint_finding_lines_and_count():
    path = os.path.join(FIXTURES, "stream", "bad_clock.py")
    findings = lint_file(path)
    # the two deadline reads flagged; the wallclock-ok timestamp is not
    assert [f.rule for f in findings] == ["R1", "R1"]
    assert [f.line for f in findings] == [12, 13]
    assert all(str(f).startswith(f"{path}:") for f in findings)


def test_lint_r4_direct_and_transitive_but_not_outside():
    path = os.path.join(FIXTURES, "bad_blocking.py")
    findings = lint_file(path)
    assert [f.rule for f in findings] == ["R4", "R4"]
    # one direct recv, one through the _next -> _read_frame chain;
    # step_outside's recv (lock not held) stays clean
    assert "recv" in findings[0].message
    assert "_next" in findings[1].message or "recv" in findings[1].message


def test_lint_r6_naming_and_span_under_lock():
    """R6 both halves: naming convention (metric + stage literals) and
    span recording under a held lock, direct and through the module
    call-graph walk (reused from R4)."""
    path = os.path.join(FIXTURES, "bad_span_metric.py")
    findings = lint_file(path)
    assert [f.rule for f in findings] == ["R6"] * 5
    assert [f.line for f in findings] == [12, 20, 24, 27, 35]
    msgs = [f.message for f in findings]
    assert "iotml-Records.Total" in msgs[0]          # malformed family name
    assert "while holding _lock" in msgs[1]          # direct mark under lock
    assert "_note()" in msgs[2]                      # transitive chain named
    assert "Decode-Stage" in msgs[3]                 # malformed stage name
    assert "car_id" in msgs[4]                       # runaway label key
    assert "vocabulary" in msgs[4]
    # the lint mirror and the port's runtime bound enforce ONE vocabulary
    from iotml_torch.analysis.lint import _ALLOWED_METRIC_LABELS
    from iotml_torch.obs.metrics import ALLOWED_LABEL_KEYS

    assert _ALLOWED_METRIC_LABELS == ALLOWED_LABEL_KEYS


def test_lint_r7_chaos_allowlist_and_shim_discipline(tmp_path):
    """R7 all three shapes, plus the only-the-shim rule holding ON an
    allowlisted module, keyed on the port's package-relative paths."""
    path = os.path.join(FIXTURES, "bad_chaos.py")
    findings = lint_file(path)
    assert [f.rule for f in findings] == ["R7"] * 3
    assert [f.line for f in findings] == [7, 8, 12]
    assert "allowlist" in findings[1].message
    assert "broker.fetch" in findings[2].message
    bad = tmp_path / "broker.py"
    bad.write_text("from ..chaos import scenarios\n")
    findings = lint_file(str(bad), rel="iotml_torch/stream/broker.py")
    assert [f.rule for f in findings] == ["R7"]
    assert "shim" in findings[0].message
    for rel in ("iotml_torch/stream/broker.py", "iotml_torch/serve/live.py"):
        for stmt in ("from iotml_torch import chaos\n",
                     "from .. import chaos\n"):
            evade = tmp_path / "evade.py"
            evade.write_text(stmt)
            findings = lint_file(str(evade), rel=rel)
            assert [f.rule for f in findings] == ["R7"], (rel, stmt)
    ok = tmp_path / "ok_broker.py"
    ok.write_text("from ..chaos import faults as chaos\n"
                  "def fetch():\n    chaos.point('broker.fetch')\n")
    assert lint_file(str(ok), rel="iotml_torch/stream/broker.py") == []


def test_r7_allowlist_matches_the_tree():
    """Every module on the port's CHAOS_ALLOWED_MODULES compiles in a
    faultpoint, and every compiled-in faultpoint name is registered in
    the port's chaos registry."""
    import re

    from iotml_torch.chaos import faults

    root = lint_mod.default_root()
    used = set()
    for pkg, fn in lint_mod.CHAOS_ALLOWED_MODULES:
        src = open(os.path.join(root, pkg, fn)).read()
        names = re.findall(r"chaos\.point\(\"([^\"]+)\"\)", src)
        assert names, f"{pkg}/{fn} is allowlisted but has no faultpoint"
        used.update(names)
    assert used == set(faults.KNOWN_POINTS)


def test_lint_clean_on_the_tree():
    findings = lint_paths([lint_mod.default_root()])
    assert findings == [], "\n".join(str(f) for f in findings)


def _no_jax_cli(*argv):
    """``python -m iotml_torch.analysis <argv>`` in a fresh process that
    fails if anything imported jax or the JAX package."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['iotml_torch.analysis', *{list(argv)!r}]\n"
            "try:\n"
            "    runpy.run_module('iotml_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code or 0\n"
            "else:\n"
            "    rc = 0\n"
            "leaked = sorted(m for m in sys.modules\n"
            "                if m.split('.')[0] in ('jax', 'iotml'))\n"
            "if leaked:\n"
            "    print('LEAKED', leaked[:5])\n"
            "    rc = 99\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=120)


def test_lint_cli_exit_codes():
    clean = _no_jax_cli("lint", "--quiet")
    assert clean.returncode == 0, clean.stdout + clean.stderr
    seeded = _no_jax_cli("lint", "--quiet", FIXTURES)
    assert seeded.returncode == 1, seeded.stdout + seeded.stderr
    assert any(":12: R1" in ln for ln in seeded.stdout.splitlines())


def test_r2_allowlist_pinned_to_the_wire_client():
    """The lint's name allowlist and the port client's api-key allowlist
    are the same set."""
    from iotml_torch.stream import kafka_wire as kw

    lint_keys = {getattr(kw, name) for name in lint_mod.IDEMPOTENT_API_NAMES}
    assert lint_keys == set(kw.IDEMPOTENT_APIS)


# ---------------------------------------------------- parity with JAX
def _fixture_copy(tmp_path, rel):
    """The fixture itself, or (when it names the JAX package) a copy in
    ``tmp_path`` rewritten to name the port, at the same relative path."""
    src = os.path.join(FIXTURES, rel)
    text = open(src, encoding="utf-8").read()
    if "iotml." not in text and "iotml/" not in text:
        return src
    dst = tmp_path / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text.replace("iotml.", "iotml_torch.")
                   .replace("iotml/", "iotml_torch/"))
    return str(dst)


@pytest.mark.parametrize("rel", PY_FIXTURES)
def test_lint_parity_with_jax_on_fixture(tmp_path, rel):
    path = _fixture_copy(tmp_path, rel)
    shown = os.path.join("analysis", rel)
    want = _rule_lines(j_lint.lint_file(path, rel=shown))
    assert _rule_lines(lint_file(path, rel=shown)) == want


@pytest.mark.parametrize("rel", PY_FIXTURES)
def test_protocol_parity_with_jax_on_fixture(tmp_path, rel):
    path = _fixture_copy(tmp_path, rel)
    assert _rule_lines(protocol_mod.check_wire(path)) == \
        _rule_lines(j_protocol.check_wire(path))


@pytest.mark.parametrize("rel", PY_FIXTURES)
def test_drift_parity_with_jax_on_fixture(tmp_path, rel):
    path = _fixture_copy(tmp_path, rel)
    assert _rule_lines(drift_mod.analyze(paths=[path])) == \
        _rule_lines(j_drift.analyze(paths=[path]))


def test_protocol_parity_with_jax_on_the_cpp_skew():
    skew = os.path.join(FIXTURES, "bad_wire.cc")
    assert _rule_lines(protocol_mod.analyze(cpp=skew)) == \
        _rule_lines(j_protocol.analyze(cpp=skew))


def test_idempotency_mirror_matches_jax():
    assert lint_mod.IDEMPOTENT_API_NAMES == j_lint.IDEMPOTENT_API_NAMES


def test_env_key_names_are_jax_less_unported_and_unread():
    """The port's config ladder accepts the JAX keys of its sections but
    the unread ones: nothing the port resolves is unknown to JAX."""
    from iotml import config as j_config
    from iotml_torch import config as t_config

    port = set(t_config.env_key_names())
    jax_keys = set(j_config.env_key_names())
    assert port <= jax_keys
    cfg = t_config.Config()
    for key in jax_keys - port:
        section, _, field = key[len("IOTML_"):].lower().partition("_")
        assert f"{section}.{field}" in t_config.UNREAD_KEYS \
            or not hasattr(getattr(cfg, section), field), key


# -------------------------------------------------------------- lockcheck
def _session_lockcheck_live() -> bool:
    """The port's or the JAX package's detector (which patches the same
    names) is installed for the whole session."""
    other = sys.modules.get("iotml.analysis.lockcheck")
    return lockcheck.state() is not None or (
        other is not None and other.state() is not None)


@pytest.fixture
def fresh_lockcheck():
    """Isolated install: skips if a session-level lockcheck is live."""
    if _session_lockcheck_live():
        pytest.skip("session-level lockcheck active")
    st = lockcheck.install()
    try:
        yield st
    finally:
        lockcheck.uninstall()


def _load_lock_cycle():
    """A fresh module of the JAX fixture, so its locks are made under
    the port's detector whatever imported it before."""
    spec = importlib.util.spec_from_file_location(
        "_torch_lock_cycle", os.path.join(FIXTURES, "lock_cycle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lockcheck_flags_seeded_cycle(fresh_lockcheck):
    lock_cycle = _load_lock_cycle()
    lock_cycle.run_consistent()
    assert fresh_lockcheck.cycles() == []
    lock_cycle.run_cycle()
    cycles = fresh_lockcheck.cycles()
    assert len(cycles) == 1
    assert "lock_cycle.py" in cycles[0].message


def test_lockcheck_flags_sleep_under_lock(fresh_lockcheck):
    time.sleep(0)  # no lock held: clean
    assert not any(v.kind == "io-under-lock"
                   for v in fresh_lockcheck.violations)
    lk = threading.Lock()
    with lk:
        time.sleep(0)
    kinds = [v.kind for v in fresh_lockcheck.violations]
    assert "io-under-lock" in kinds
    assert fresh_lockcheck.cycles() == []


def test_lockcheck_watched_dict_lock_and_owner_modes(fresh_lockcheck):
    lk = threading.Lock()
    table = lockcheck.WatchedDict({}, "t.guarded", lock=lk)
    with lk:
        table["ok"] = 1
    assert not fresh_lockcheck.violations
    table["bad"] = 2
    assert any(v.kind == "unguarded-mutation" and "t.guarded" in v.message
               for v in fresh_lockcheck.violations)

    owned = lockcheck.WatchedDict({}, "t.owned")
    owned["claims-ownership"] = 1            # first mutator becomes owner
    t = threading.Thread(target=owned.__setitem__, args=("other", 2))
    t.start(); t.join(5)
    assert any(v.kind == "unguarded-mutation" and "t.owned" in v.message
               for v in fresh_lockcheck.violations)


def test_lockcheck_broker_commit_is_guarded(fresh_lockcheck):
    """The port's Broker and GroupCoordinator made under lockcheck get
    watched tables under their own attribute names, and the public
    mutation surface (produce, commit, a consumer's join) holds their
    locks."""
    from iotml_torch.stream.broker import Broker
    from iotml_torch.stream.group import GroupConsumer, GroupCoordinator

    b = Broker()
    for attr in ("_topics", "_parts", "_group_offsets"):
        assert isinstance(getattr(b, attr), lockcheck.WatchedDict), attr
    b.create_topic("t", partitions=2)
    b.produce("t", b"v")
    b.commit("g", "t", 0, 7)
    assert b.committed("g", "t", 0) == 7
    coord = GroupCoordinator(b, "g")
    for attr in ("_heartbeats", "_subscriptions", "_assignments"):
        assert isinstance(getattr(coord, attr), lockcheck.WatchedDict), attr
    GroupConsumer(coord, ["t"])
    bad = [v for v in fresh_lockcheck.violations
           if v.kind == "unguarded-mutation"]
    assert bad == [], bad
    assert fresh_lockcheck.cycles() == []


def test_lockcheck_uninstall_restores_everything():
    if _session_lockcheck_live():
        pytest.skip("session-level lockcheck active")
    lockcheck.install()
    assert isinstance(threading.Lock(), lockcheck.CheckedLock)
    lockcheck.uninstall()
    assert threading.Lock is lockcheck._REAL_LOCK
    assert threading.RLock is lockcheck._REAL_RLOCK
    assert time.sleep is lockcheck._REAL_SLEEP
    assert "recv" not in socket.socket.__dict__
    assert type(threading.Lock()).__module__ == "_thread"


def test_lockcheck_condition_integration(fresh_lockcheck):
    """Condition/Event built over checked locks keep the held-stack
    truthful across wait() (RLock _release_save/_acquire_restore)."""
    cv = threading.Condition()           # RLock() -> CheckedRLock
    done = []

    def waiter():
        with cv:
            cv.wait(timeout=5)
            done.append(True)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cv:
        cv.notify()
    t.join(5)
    assert done == [True]
    ev = threading.Event()
    threading.Thread(target=ev.set).start()
    assert ev.wait(5)
    assert fresh_lockcheck.cycles() == []


def test_lockcheck_refuses_beside_the_jax_detector(monkeypatch):
    """Both detectors patch threading.Lock: the port's will not install
    in a process where the JAX package's is live."""
    if _session_lockcheck_live():
        pytest.skip("session-level lockcheck active")
    import types

    fake = types.SimpleNamespace(_state=object())
    monkeypatch.setitem(sys.modules, "iotml.analysis.lockcheck", fake)
    with pytest.raises(RuntimeError, match="never both"):
        lockcheck.install()
    assert lockcheck.state() is None
    assert threading.Lock is lockcheck._REAL_LOCK


# ----------------------------------------------- whole-program passes
def test_protocol_clean_on_the_tree():
    findings = protocol_mod.analyze()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_tracecheck_clean_on_the_tree():
    findings = trace_mod.analyze()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_drift_clean_on_the_tree():
    findings = drift_mod.analyze()
    assert findings == [], "\n".join(str(f) for f in findings)


def test_protocol_fixture_catches_every_seeded_skew():
    findings = protocol_mod.check_wire(
        os.path.join(FIXTURES, "bad_protocol.py"))
    assert _rule_counts(findings) == {"P1": 3, "P2": 2, "P3": 1,
                                      "P5": 1, "P6": 1}
    msgs = " ".join(f.message for f in findings)
    assert "API_ORPHAN" in msgs
    assert "API_GHOST" in msgs
    assert "API_MYSTERY" in msgs
    assert "ERR_MESSAGE_TOO_LARGE" in msgs
    assert "bare error code 41" in msgs
    assert "suppressed_probe" not in msgs


def test_protocol_reads_a_dict_dispatch(tmp_path):
    """The port's server shape: a dict literal of handler methods, each
    method's codes (through its class's self-helpers) its api's."""
    src = '''\
PRODUCE, FETCH, GHOST = 0, 1, 9
ERR_NONE, ERR_NOT_LEADER_FOR_PARTITION, ERR_BIG = 0, 6, 10
_SUPPORTED = {PRODUCE: (0, 0), FETCH: (0, 0)}
IDEMPOTENT_APIS = frozenset({FETCH})


class Conn:
    def _dispatch(self, api_key, r, w):
        {PRODUCE: self._produce, GHOST: self._ghost}[api_key](r, w)

    def _produce(self, r, w):
        if self._too_big(r):
            w.i16(ERR_BIG)
        w.i16(self._leader_code())

    def _leader_code(self):
        return ERR_NOT_LEADER_FOR_PARTITION

    def _too_big(self, r):
        return False

    def _ghost(self, r, w):
        w.i16(41)


class Client:
    def _request(self, api, ver, body):
        chaos.point("wire.send")

    def produce(self):
        err = self._request(PRODUCE, 0, b"")
        if err == ERR_BIG:
            raise ValueError(err)

    def fetch(self):
        return self._request(FETCH, 0, b"")
'''
    p = tmp_path / "dict_wire.py"
    p.write_text(src)
    findings = protocol_mod.check_wire(str(p))
    got = {(f.rule, f.line) for f in findings}
    # FETCH: supported, no dispatch entry (P1 at its _SUPPORTED row);
    # GHOST: dispatched, disowned (P1) with a bare code (P1); produce()
    # misses the helper's NOT_LEADER (P3)
    assert got == {("P1", 3), ("P1", 9), ("P1", 23), ("P3", 31)}, findings
    assert "ERR_NOT_LEADER_FOR_PARTITION" in " ".join(
        f.message for f in findings if f.rule == "P3")


def test_tracecheck_torch_fixture_catches_every_seeded_hazard():
    path = os.path.join(TORCH_FIXTURES, "bad_torch_trace.py")
    findings = trace_mod.analyze(paths=[path])
    assert _rule_counts(findings) == {"T1": 1, "T2": 4, "T3": 2, "T4": 2}
    msgs = " ".join(f.message for f in findings)
    assert "'loss'" in msgs                       # T1 names the value
    assert ".item()" in msgs and "float()" in msgs and ".cpu()" in msgs
    assert "synchronize" in msgs
    assert "_build.load()" in msgs and "ctypes.CDLL()" in msgs
    assert "zeros()" in msgs and "reshape()" in msgs
    # the clean idioms stayed clean: static branches, host scalars,
    # cached and factory loaders, the suppressed and post-sync reads
    flagged = {f.line for f in findings}
    lines = open(path).read().splitlines()
    clean_from = next(i for i, ln in enumerate(lines, start=1)
                      if "clean shapes" in ln)
    assert not [ln for ln in flagged if ln > clean_from]


def test_tracecheck_targets_resolve():
    """Every TRACE_TARGETS row names a function that exists: a rename
    would silently drop a hot loop from the pass."""
    from iotml_torch.analysis.program import Program

    program = Program()
    root = lint_mod.default_root()
    for rel, targets in trace_mod.TRACE_TARGETS.items():
        unit = program.unit(os.path.join(root, rel))
        for qualname, device in targets:
            fn = trace_mod.resolve_function(unit.tree, qualname)
            assert fn is not None, (rel, qualname)
            params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
            assert set(device) <= params, (rel, qualname)


def test_drift_fixture_catches_every_seeded_drift():
    findings = drift_mod.analyze(
        paths=[os.path.join(FIXTURES, "bad_drift.py")])
    assert _rule_counts(findings) == {"D1": 2, "D2": 2, "D3": 1}
    msgs = " ".join(f.message for f in findings)
    assert "IOTML_BOGUS_KNOB" in msgs and "IOTML_PHANTOM" in msgs
    assert "fixture_total" in msgs and "ghost_total" in msgs
    assert "fixture.bogus_fault" in msgs
    assert "IOTML_SUPPRESSED_KNOB" not in msgs


def test_protocol_cpp_skew_fixture():
    """The skewed C++ snippet against the port's python wire: value
    drift both ways plus a claim with no constant, all P4."""
    findings = protocol_mod.analyze(
        cpp=os.path.join(FIXTURES, "bad_wire.cc"))
    assert _rule_counts(findings) == {"P4": 3}
    msgs = " ".join(f.message for f in findings)
    assert "API_FETCH = 41" in msgs
    assert "ERR_UNKNOWN_TOPIC = 77" in msgs
    assert "API_LIST_OFFSETS" in msgs


def _mutated(tmp_path, src_path, old, new, name):
    src = open(src_path).read()
    assert old in src, f"mutation anchor vanished from {src_path}"
    p = tmp_path / name
    p.write_text(src.replace(old, new, 1))
    return str(p)


def test_protocol_is_five_surface_sensitive(tmp_path):
    """Removing any ONE api mapping from any surface makes the pass
    fail: server (dict dispatch and _SUPPORTED), client, cluster
    router, C++ (both files) and the lint mirror."""
    root = lint_mod.default_root()
    wire = os.path.join(root, "stream", "kafka_wire.py")
    cluster = os.path.join(root, "cluster", "client.py")

    # server surface: drop FETCH from _SUPPORTED -> its dispatch
    # entry is orphaned (P1)
    skewed = _mutated(tmp_path, wire, "FETCH: (2, 2),", "", "w1.py")
    assert "P1" in {f.rule for f in protocol_mod.analyze(wire=skewed)}
    # ...and drop its dispatch entry instead (P1 the other way)
    skewed = _mutated(tmp_path, wire, "FETCH: self._fetch, ", "", "w1b.py")
    assert any(f.rule == "P1" and "FETCH" in f.message
               for f in protocol_mod.analyze(wire=skewed))

    # client surface: neuter produce_many's typed compare (P3)
    skewed = _mutated(tmp_path, wire,
                      "err == ERR_INVALID_REQUIRED_ACKS",
                      "err == ERR_NONE", "w2.py")
    findings = protocol_mod.analyze(wire=skewed)
    assert any(f.rule == "P3"
               and "ERR_INVALID_REQUIRED_ACKS" in f.message
               for f in findings)

    # cluster surface: point a delegation at a missing method (P2)
    skewed = _mutated(tmp_path, cluster, "c.heartbeat_group(",
                      "c.heartbeat_missing(", "c1.py")
    findings = protocol_mod.analyze(cluster=skewed)
    assert any(f.rule == "P2" and "heartbeat_missing" in f.message
               for f in findings)

    # lint-mirror surface: drop FETCH from the idempotency mirror (P5)
    trimmed = [n for n in lint_mod.IDEMPOTENT_API_NAMES if n != "FETCH"]
    findings = protocol_mod.analyze(lint_idempotent=trimmed)
    assert any(f.rule == "P5" and "FETCH" in f.message
               for f in findings)

    # C++ surface, the message-set engine beside the client: a skewed
    # copy of the cpp/ tree with an API constant added there (P4)
    tree = tmp_path / "tree"
    shutil.copytree(root, tree, ignore=shutil.ignore_patterns(
        "build", "__pycache__", "*.so"))
    with open(tree / "cpp" / "msgset_engine.cc", "a") as f:
        f.write("\nconstexpr int16_t API_FETCH = 77;\n")
    findings = protocol_mod.analyze(str(tree))
    assert any(f.rule == "P4" and "msgset_engine.cc" in f.path
               for f in findings), findings


def test_drift_d4_flags_missing_doc_rows(tmp_path):
    """A doc with only P1's row: every other rule id is a D4."""
    doc = tmp_path / "RULES.md"
    doc.write_text("| Rule | Contract |\n|---|---|\n| P1 | covered |\n")
    findings = drift_mod.analyze(paths=[], doc=str(doc))
    assert findings and {f.rule for f in findings} == {"D4"}
    missing = " ".join(f.message for f in findings)
    for rid in ("P2", "T1", "T4", "D1", "D4", "R1", "R16"):
        assert f"rule {rid} " in missing
    assert "rule P1 " not in missing


def test_drift_d4_reads_the_port_section_only(tmp_path):
    """Rows outside the README's port section (the JAX package's text)
    do not count for the port."""
    rows = "".join(f"| {r} | x |\n" for r in ("R1", "P1"))
    doc = tmp_path / "README.md"
    doc.write_text("# repo\n\n## Layout\n\n" + rows +
                   "\n## The PyTorch/CUDA port (`iotml_torch/`)\n\n"
                   "| P1 | here |\n\n## Quick start\n")
    missing = " ".join(f.message for f in
                       drift_mod.analyze(paths=[], doc=str(doc)))
    assert "rule R1 " in missing and "rule P1 " not in missing


# ------------------------------------------------- the build guard
@pytest.fixture
def fake_loader(monkeypatch):
    """``_build.load`` as a counted stand-in (no nvcc on the CPU): a
    name not yet in ``_LOADED`` is a load, as the real one's cache."""
    if os.environ.get("IOTML_TRACECHECK"):
        pytest.skip("session-level traceguard active")
    from iotml_torch.ops import _build

    loaded = {}
    monkeypatch.setattr(_build, "_LOADED", loaded)
    monkeypatch.setattr(_build, "load",
                        lambda name: loaded.setdefault(name, object()))
    trace_mod.reset_warm()
    trace_mod.RecompileGuard.install()
    try:
        yield _build
    finally:
        trace_mod.RecompileGuard.uninstall()
        trace_mod.reset_warm()


def test_recompile_guard_counts_and_hot_loop_wrap(fake_loader):
    import torch

    _build = fake_loader
    x = torch.ones(4)
    _build.load("warm")  # the warm-up load
    with trace_mod.expect_no_recompile("warmed library"):
        _build.load("warm")
    with pytest.raises(trace_mod.RecompileError):
        with trace_mod.expect_no_recompile("cold library"):
            _build.load("cold")

    class Good:
        def step(self, v):
            return _build.load("good"), v + 1

    Good.step = trace_mod.guard_hot_loop(Good.step, "Good.step")
    g = Good()
    g.step(x)   # warm-up: loads
    g.step(x)   # cached: no load, no error
    g.step(torch.ones(8))  # new signature: legal

    class Bad:
        def step(self, v):
            _build._LOADED.pop("bad", None)  # a per-call load
            return _build.load("bad"), v

    Bad.step = trace_mod.guard_hot_loop(Bad.step, "Bad.step")
    b = Bad()
    b.step(x)   # warm-up call may load
    with pytest.raises(trace_mod.RecompileError):
        b.step(x)  # identical signature loaded again: the guard fails it


def test_recompile_guard_ignores_cached_native_loads(monkeypatch):
    """``native.load`` counts only when the engine is not loaded yet."""
    if os.environ.get("IOTML_TRACECHECK"):
        pytest.skip("session-level traceguard active")
    from iotml_torch.stream import native

    sentinel = object()
    monkeypatch.setattr(native, "_lib", sentinel)
    trace_mod.RecompileGuard.install()
    try:
        with trace_mod.expect_no_recompile("loaded engine"):
            assert native.load() is sentinel
    finally:
        trace_mod.RecompileGuard.uninstall()
    assert not getattr(native.load, "__iotml_buildguard__", False)


def test_runtime_guard_targets_exist():
    """Every _GUARD_TARGETS row resolves to a real method, install is
    idempotent, and uninstall unwraps everything."""
    for mod_name, cls_name, meth in trace_mod._GUARD_TARGETS:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        assert meth in cls.__dict__, (cls_name, meth)
    if os.environ.get("IOTML_TRACECHECK"):
        pytest.skip("session-level traceguard active")
    patched = trace_mod.install_runtime_guard()
    try:
        assert set(patched) == {f"{c}.{m}"
                                for _, c, m in trace_mod._GUARD_TARGETS}
        assert trace_mod.install_runtime_guard() == []
    finally:
        unwrapped = trace_mod.uninstall_runtime_guard()
    assert set(unwrapped) == set(patched)
    for mod_name, cls_name, meth in trace_mod._GUARD_TARGETS:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        assert not getattr(cls.__dict__[meth], "__iotml_traceguard__",
                           False)


def test_runtime_guard_over_fit_compiled_on_the_cpu():
    """The guarded Trainer.fit_compiled warms and stays warm on the CPU
    (the plain version: no build, no load), with the fit unchanged."""
    if os.environ.get("IOTML_TRACECHECK"):
        pytest.skip("session-level traceguard active")
    from iotml_torch.data.dataset import Batch
    from iotml_torch.models.autoencoder import CAR_AUTOENCODER
    from iotml_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    xs = rng.uniform(-1, 1, (3, 16, 18)).astype(np.float32)
    bs = [Batch(x=xs[i], n_valid=16, first_index=16 * i) for i in range(3)]
    plain = Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(bs, 2)
    trace_mod.install_runtime_guard()
    try:
        tr = Trainer(CAR_AUTOENCODER, device="cpu")
        before = trace_mod.RecompileGuard.compiles()
        h1 = tr.fit_compiled(bs, 2)
        h2 = tr.fit_compiled(bs, 2)
        assert trace_mod.RecompileGuard.compiles() == before
    finally:
        trace_mod.uninstall_runtime_guard()
    assert h1["loss"] == plain["loss"]
    assert h2["loss"][0] < h1["loss"][0]


# ---------------------------------------------------------- lock order
def test_lockorder_extracts_real_edges():
    edges = lockorder.analyze()
    assert any("stream/broker.py" in a and "stream/broker.py" in b
               for a, b, _ in edges), edges
    assert lockorder.cycles_among(edges) == []


_LOCK_CYCLE_SRC = '''\
import threading


class T:
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()

    def _inner_b(self):
        with self._b:
            pass

    def ab(self):
        with self._a:
            self._inner_b()

    def ba(self):
        with self._b, self._a:
            pass
'''


def test_lockorder_static_cycle_detected(tmp_path):
    p = tmp_path / "cycle_mod.py"
    p.write_text(_LOCK_CYCLE_SRC)
    edges = lockorder.analyze(paths=[str(p)])
    assert len(edges) == 2, edges
    cycles = lockorder.cycles_among(edges)
    assert len(cycles) == 1, cycles


def test_lockorder_preseed_static(fresh_lockcheck):
    n = lockorder.preseed(state=fresh_lockcheck,
                          edges=[("f.py:1", "f.py:2", "f.py:10")])
    assert n == 1
    assert fresh_lockcheck.violations == []
    n = lockorder.preseed(state=fresh_lockcheck,
                          edges=[("f.py:2", "f.py:1", "f.py:20")])
    assert n == 1
    kinds = [v.kind for v in fresh_lockcheck.violations]
    assert kinds == ["static-cycle"]
    assert fresh_lockcheck.cycles() == []
    assert lockorder.preseed(state=fresh_lockcheck,
                             edges=[("f.py:1", "f.py:2", "f.py:10")]) == 0


def test_lockorder_preseed_closes_a_runtime_cycle(fresh_lockcheck,
                                                  tmp_path):
    """A runtime acquisition that inverts a statically-derived order
    closes a cycle although the opposite path never ran."""
    p = tmp_path / "cycle_mod.py"
    p.write_text(_LOCK_CYCLE_SRC)
    edges = [e for e in lockorder.analyze(paths=[str(p)])
             if e[0].endswith(":6")]   # only _a -> _b, from ab()
    assert len(edges) == 1
    lockorder.preseed(state=fresh_lockcheck, edges=edges)
    spec = importlib.util.spec_from_file_location("cycle_mod", str(p))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.T().ba()                          # runs _b then _a only
    cycles = fresh_lockcheck.cycles()
    assert len(cycles) == 1 and "cycle_mod.py:6" in cycles[0].message


def test_analysis_cli_all_and_lockorder_exit_clean_without_jax():
    r = _no_jax_cli("all")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "parsed once" in r.stderr and "0 finding(s)" in r.stderr
    r = _no_jax_cli("lockorder")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 static cycle(s)" in r.stderr


def test_rule_tables_are_disjoint_and_documented():
    families = [lint_mod.RULES, protocol_mod.PASS_RULES,
                trace_mod.PASS_RULES, drift_mod.PASS_RULES]
    seen = set()
    for table in families:
        assert not (set(table) & seen)
        seen |= set(table)
    assert {"P1", "P7", "T1", "T4", "D1", "D4", "R16"} <= seen
    # the same ids as the JAX package's passes
    from iotml.analysis import tracecheck as j_trace

    jax_ids = set(j_lint.RULES) | set(j_protocol.PASS_RULES) | \
        set(j_trace.PASS_RULES) | set(j_drift.PASS_RULES)
    assert seen == jax_ids


# ---------------------------------------------------------- sanitizer
def test_sanitizer_smoke_under_tsan_and_asan(tmp_path):
    """``make -C iotml_torch/cpp sanitize`` (into a scratch build dir):
    the msgset codec round trips and the MQTT ingest handle across
    threads, clean under ThreadSanitizer and AddressSanitizer."""
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make/g++")
    probe = tmp_path / "probe.cc"
    probe.write_text("int main() { return 0; }\n")
    for san in ("thread", "address"):
        ok = subprocess.run(["g++", f"-fsanitize={san}", "-o",
                             str(tmp_path / f"probe_{san}"), str(probe)],
                            capture_output=True, timeout=60)
        if ok.returncode != 0:
            pytest.skip(f"g++ lacks -fsanitize={san}")
    r = subprocess.run(
        ["make", "-s", "-C", os.path.join(REPO, "iotml_torch", "cpp"),
         "sanitize", f"BUILD={tmp_path / 'build'}"],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("sanitize smoke: OK") == 2, r.stdout


# ------------------------------------------------------------- repairs
def test_registry_enumerates_the_prefetch_and_metrics_threads():
    """The port's prefetcher and metrics server register their threads
    with the supervisor registry, as the JAX package's do."""
    from iotml.data.prefetch import DevicePrefetcher as JPrefetcher
    from iotml.supervise import registry as j_registry
    from iotml_torch.data.prefetch import DevicePrefetcher
    from iotml_torch.obs import metrics as t_metrics
    from iotml_torch.supervise import registry as t_registry

    gate = threading.Event()

    def held():
        # keeps each prefetch thread alive (the registry lists live
        # threads) until the checks are done
        gate.wait(30)
        yield from ()

    pf = DevicePrefetcher(held(), depth=1, device="cpu")
    jpf = JPrefetcher(held(), depth=1)
    srv = t_metrics.start_http_server(0)
    try:
        names = {t.name for t in t_registry.threads()}
        assert pf._thread in t_registry.threads()
        assert "iotml-prefetch" in names
        assert f"iotml-metrics-{srv.server_address[1]}" in names
        assert jpf._thread in j_registry.threads()
        assert "iotml-prefetch" in {t.name for t in j_registry.threads()}
    finally:
        gate.set()
        srv.shutdown()
        srv.server_close()
        list(pf)
        list(jpf)


def test_wire_server_thread_is_registered():
    from iotml_torch.stream.broker import Broker
    from iotml_torch.stream.kafka_wire import KafkaWireServer
    from iotml_torch.supervise import registry

    with KafkaWireServer(Broker(), port=0) as srv:
        assert srv._thread in registry.threads()


def _mechanism_rejecting_server():
    """A one-connection server that answers SASL_HANDSHAKE with
    SASL_AUTHENTICATION_FAILED (58), offering another mechanism."""
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(4)

    def serve():
        conn, _ = ls.accept()
        with conn:
            (size,) = struct.unpack(">i", conn.recv(4, socket.MSG_WAITALL))
            frame = conn.recv(size, socket.MSG_WAITALL)
            corr = struct.unpack(">i", frame[4:8])[0]
            mech = b"SCRAM-SHA-256"
            body = struct.pack(">ihi", corr, 58, 1) + \
                struct.pack(">h", len(mech)) + mech
            conn.sendall(struct.pack(">i", len(body)) + body)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return ls, t


@pytest.mark.parametrize("package", ["iotml", "iotml_torch"])
def test_sasl_mechanism_rejection_is_typed(package):
    """A server that rejects the PLAIN mechanism raises SaslAuthError
    with the JAX package's message, from both packages' clients."""
    kw = importlib.import_module(f"{package}.stream.kafka_wire")
    ls, t = _mechanism_rejecting_server()
    try:
        with pytest.raises(kw.SaslAuthError,
                           match=r"server rejected SASL mechanism PLAIN; "
                                 r"offers \['SCRAM-SHA-256'\]"):
            kw.KafkaWireBroker(f"127.0.0.1:{ls.getsockname()[1]}",
                               sasl_username="u", sasl_password="p",
                               timeout_s=10.0)
    finally:
        ls.close()
        t.join(5)
