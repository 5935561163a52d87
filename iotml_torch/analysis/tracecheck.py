"""Hot-loop discipline pass for PyTorch on CUDA: host syncs and per-call
builds.

The port's counterpart of the JAX package's ``analysis/tracecheck.py``.
The port has no ``jax.jit``, so there are no syntactic trace roots and
no retrace; what turns a device hot loop slow on a card is a Python
decision on a device value, a device→host sync, a kernel build or
library load per call, and a device value where a shape belongs.  The
same four rule ids say so here.

Static half
-----------
The pass walks a declared table of hot-loop functions
(``TRACE_TARGETS``: the step, scanned and ``fit_compiled`` loops, the
normalizer, the online learner's updates, the scorer's super-batch and
the kernels' launch wrappers).  Each function's body (nested defs
included, one transitive hop through same-module functions it calls by
bare name) is checked.  Device values are the function's parameters
annotated ``torch.Tensor`` or named as device values in the table, and
every local assigned from an expression that holds one (outside a
static position) or that makes one (a ``torch.*`` call, ``.to(...)``,
``.cuda()``, ``_to_device(...)``), until an outermost sync brings it to
the host:

T1  Python branch on a device tensor's value (``if loss > 0:``,
    ``while x.any():``): the branch reads the value on the host, a sync
    per call.  Branching on ``.shape``/``.ndim``/``.dtype``/
    ``.device``/``.numel()``/``len()``/``is None`` is static and allowed.
T2  Host sync: ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` of a
    device value, ``float()``/``int()``/``bool()`` of one,
    ``np.asarray``/``np.array`` of one, or ``torch.cuda.synchronize()``.
T3  Per-call build or load: ``ops/_build.py`` ``build``/``load``/
    ``build_log``/``build_variant``, ``stream/native.py``
    ``build``/``load``, or ``ctypes.CDLL`` reached from the hot loop
    rather than made once (module level, a ``make_*`` factory, or an
    ``lru_cache``/``cache``-decorated function).
T4  Device value in a shape position (``torch.zeros(n)``,
    ``x.reshape(n)`` with ``n`` on the device): a shape must be a
    host integer, so this is a sync per call.

The syncs the port makes by design (the one read-back that ends a fit,
the drift signal of an online window) carry ``# lint-ok: T2 <reason>``.
Findings use the shared ``Finding`` type.

Runtime half
------------
The port's "recompile" is a kernel build or a library load.
``RecompileGuard`` counts the calls into ``ops/_build.build``/``load``
and ``stream/native.build``/``load`` that build or load (a load that
finds its library cached is a lookup and not counted), and
``guard_hot_loop`` wraps a hot-loop method so that, once a given
(instance, shape/dtype signature) key has run once (the warm-up call),
a later call under the same key that builds or loads raises
``RecompileError``.  The pytest plugin installs it over
``Trainer.fit_compiled``, ``ShardedStreamTrainer.fit_round`` and
``fit_compiled``, and ``OnlineLearner._update`` when
``IOTML_TRACECHECK=1``.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import os
import threading
import types
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .lint import Finding, call_graph_for, suppressions_for
from .program import FileUnit, Program

PASS_RULES: Dict[str, str] = {
    "T1": "Python branch on a device tensor's value in a hot loop",
    "T2": "host sync (.item/.tolist/.cpu/.numpy/float/int of a device "
          "tensor, torch.cuda.synchronize) in a hot loop",
    "T3": "per-call kernel build or library load (ops/_build, "
          "stream/native, ctypes.CDLL) in a hot loop",
    "T4": "device tensor used in a shape position in a hot loop",
}

#: the hot loops this pass walks by default: package-relative file ->
#: ((qualified function name, device-valued parameters), ...): the JAX
#: package's TRACE_TARGET_RELS files, and the port's kernel wrappers.
TRACE_TARGETS: Dict[str, Tuple[Tuple[str, Tuple[str, ...]], ...]] = {
    "train/loop.py": (
        ("make_raw_train_step.step", ("state", "x", "y", "mask")),
        ("make_scanned_fit.fit", ("state", "xs", "ys", "masks")),
        ("make_scanned_window_steps.run", ("state", "xs", "masks")),
        ("Trainer.fit_compiled", ()),
    ),
    "parallel/streaming.py": (
        ("ShardedStreamTrainer.fit_round", ()),
        ("ShardedStreamTrainer._assemble", ()),
        ("shard_mean_losses", ("row_loss",)),
    ),
    "parallel/data_parallel.py": (
        ("ShardedTrainer._raw_step", ("x", "y", "mask")),
        ("ShardedTrainer._step", ("x", "y", "mask")),
        ("ShardedTrainer.fit", ()),
    ),
    "core/normalize.py": (
        ("Normalizer.__call__", ()),
    ),
    "online/learner.py": (
        ("OnlineLearner._update", ()),
        ("OnlineLearner._update_mesh", ()),
        ("OnlineLearner._update_group", ()),
    ),
    "serve/scorer.py": (
        ("StreamScorer._score_super_batch", ()),
    ),
    "ops/fused_train.py": (
        ("fused_fit", ()),
    ),
    "ops/attention.py": (
        ("flash_attention_fwd", ("q", "k", "v")),
        ("flash_bwd_dkv", ("qf", "kf", "vf", "dof", "lse", "delta")),
        ("flash_bwd_dq", ("qf", "kf", "vf", "dof", "lse", "delta")),
        ("_launch_bwd", ("folded", "outs")),
    ),
}

#: enclosing-function names allowed to build or load once per process
_FACTORY_PREFIXES = ("make", "_make")
_CACHE_DECORATORS = frozenset({"lru_cache", "cache"})

#: attributes and methods of a tensor that are host metadata, not its
#: value: reading them never syncs
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "requires_grad",
    "layout", "is_sparse", "numel", "dim", "size", "stride",
    "is_contiguous", "is_floating_point", "data_ptr", "element_size",
    "nbytes", "itemsize", "names"})
_STATIC_CALLS = frozenset({"len", "isinstance", "hasattr", "getattr",
                           "callable", "type", "id", "is_tensor"})
_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy"})
_SHAPE_BUILDERS = frozenset({"zeros", "ones", "full", "empty", "arange",
                             "eye", "rand", "randn", "randint",
                             "new_zeros", "new_ones", "new_empty",
                             "new_full"})
_SHAPE_METHODS = frozenset({"reshape", "view", "expand", "repeat",
                            "new_zeros", "new_ones", "new_empty"})
#: calls that make a device value from host data or place one
_DEVICE_METHODS = frozenset({"to", "cuda", "_to_device"})
#: torch calls that yield host objects, not tensors on the card
_HOST_TORCH_CALLS = frozenset({
    "from_numpy", "device", "no_grad", "is_tensor", "get_default_dtype",
    "is_grad_enabled", "inference_mode", "enable_grad", "Generator",
    "manual_seed", "Size", "finfo", "iinfo"})
#: (module alias, function) pairs of a kernel build or library load
_BUILD_CALLS = frozenset({
    ("_build", "build"), ("_build", "load"), ("_build", "build_log"),
    ("_build", "build_variant"), ("native", "build"), ("native", "load")})


def _line_node(line: int):
    return types.SimpleNamespace(lineno=line, end_lineno=line)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _static_names(expr: ast.AST, device: Set[str]) -> Set[str]:
    """Device names that appear only in STATIC positions of ``expr``:
    ``x is None``, ``x.shape``/``x.dtype``/``x.numel()``,
    ``len(x)``/``isinstance(x, …)``."""
    ok: Set[str] = set()
    for sub in ast.walk(expr):
        if isinstance(sub, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
            # `any(t.dtype != q.dtype for t in ts)`: the iterated device
            # values are static when the element reads only their
            # metadata
            targets = set()
            for gen in sub.generators:
                targets |= _names_in(gen.target)
            reads = [sub.elt] + [c for g in sub.generators for c in g.ifs]
            if not any(_hot(r, device | targets) & targets for r in reads):
                for gen in sub.generators:
                    ok |= _names_in(gen.iter) & device
        if isinstance(sub, ast.Compare) \
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in sub.ops):
            ok |= _names_in(sub) & device
        elif isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            ok |= _names_in(sub.value) & device
        elif isinstance(sub, ast.Call) and _terminal(sub.func) \
                in _STATIC_CALLS:
            for a in sub.args:
                ok |= _names_in(a) & device
    return ok


def _hot(expr: ast.AST, device: Set[str]) -> Set[str]:
    """Device names that ``expr`` reads as values."""
    return (_names_in(expr) & device) - _static_names(expr, device)


def _terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_torch_call(node: ast.Call) -> bool:
    """``torch.<f>(...)`` or ``torch.<m>.<f>(...)`` making a tensor."""
    f = node.func
    root = f
    while isinstance(root, ast.Attribute):
        root = root.value
    return isinstance(f, ast.Attribute) and isinstance(root, ast.Name) \
        and root.id == "torch" and f.attr not in _HOST_TORCH_CALLS \
        and not (isinstance(f.value, ast.Attribute)
                 and f.value.attr == "cuda")


def _is_sync_call(node: ast.AST) -> bool:
    """An expression whose outermost operation brings a value to the
    host: ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` or a Python
    scalar conversion."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in _SYNC_ATTRS:
        return True
    return isinstance(f, ast.Name) and f.id in ("float", "int", "bool")


def _makes_device(expr: ast.AST, device: Set[str]) -> bool:
    """``expr`` yields a device value (before any outermost sync)."""
    if _is_sync_call(expr):
        return False
    if _hot(expr, device):
        return True
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Call):
            if _is_torch_call(sub):
                return True
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in _DEVICE_METHODS:
                return True
            if isinstance(sub.func, ast.Name) \
                    and sub.func.id in _DEVICE_METHODS:
                return True
    return False


def _target_names(t: ast.AST) -> List[ast.AST]:
    if isinstance(t, (ast.Tuple, ast.List)):
        return list(t.elts)
    return [t]


def _device_names(fn: ast.AST, seeds: Set[str]) -> Set[str]:
    """Flow-insensitive device set of one function: the seeds plus every
    local assigned (or iterated) from a device-making expression,
    to a fixpoint."""
    device = set(seeds)
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            pairs: List[Tuple[ast.AST, ast.AST]] = []
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Tuple) \
                            and isinstance(node.value, ast.Tuple) \
                            and len(t.elts) == len(node.value.elts):
                        pairs += list(zip(t.elts, node.value.elts))
                    else:
                        pairs += [(e, node.value)
                                  for e in _target_names(t)]
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                    and node.value is not None:
                pairs.append((node.target, node.value))
            elif isinstance(node, (ast.For, ast.comprehension)):
                pairs += [(e, node.iter) for e in _target_names(node.target)]
            for tgt, value in pairs:
                for n in ast.walk(tgt):
                    if isinstance(n, ast.Name) and n.id not in device \
                            and _makes_device(value, device):
                        device.add(n.id)
                        changed = True
    return device


def _param_names(args: ast.arguments) -> List[str]:
    return [a.arg for a in args.posonlyargs + args.args
            if a.arg not in ("self", "cls")]


def _tensor_params(args: ast.arguments) -> Set[str]:
    """Parameters annotated ``torch.Tensor`` (or Optional of it)."""
    out: Set[str] = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is not None and \
                "Tensor" in ast.unparse(a.annotation):
            out.add(a.arg)
    return out


def _is_factory(fn) -> bool:
    name = getattr(fn, "name", "")
    if name == "make" or any(name.startswith(p) for p in _FACTORY_PREFIXES):
        return True
    return any(_terminal(d.func if isinstance(d, ast.Call) else d)
               in _CACHE_DECORATORS
               for d in getattr(fn, "decorator_list", ()))


def _build_call(node: ast.Call) -> Optional[str]:
    """``_build.load`` / ``native.build`` / ``ctypes.CDLL`` style call:
    its display name, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if (f.value.id, f.attr) in _BUILD_CALLS:
            return f"{f.value.id}.{f.attr}"
        if f.attr == "CDLL":
            return f"{f.value.id}.CDLL"
    if isinstance(f, ast.Name) and f.id == "CDLL":
        return "CDLL"
    return None


def resolve_function(tree: ast.Module, qualname: str):
    """The def named by a dotted ``Class.method`` / ``outer.inner``
    qualname, or None."""
    scope: Iterable[ast.AST] = tree.body
    found = None
    for part in qualname.split("."):
        found = next((n for n in scope
                      if isinstance(n, (ast.FunctionDef, ast.ClassDef,
                                        ast.AsyncFunctionDef))
                      and n.name == part), None)
        if found is None:
            return None
        scope = [n for n in ast.walk(found) if n is not found]
    return found if isinstance(found, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)) else None


class _LoopChecker:
    """Walks one hot-loop function (nested defs inline, one hop into
    module functions it calls by bare name) and emits T1-T4."""

    def __init__(self, unit: FileUnit, bodies: Dict[str, ast.AST],
                 sup, findings: List[Finding]):
        self.unit = unit
        self.bodies = bodies
        self.sup = sup
        self.findings = findings
        self._visited: Set[int] = set()
        self._seen: Set[Tuple[int, str]] = set()

    def emit(self, rule: str, line: int, message: str) -> None:
        if (line, rule) in self._seen:
            return
        self._seen.add((line, rule))
        if self.sup is not None \
                and self.sup.suppressed(rule, _line_node(line)):
            return
        self.findings.append(Finding(self.unit.path, line, rule, message))

    def check(self, fn, device_params: Iterable[str]) -> None:
        seeds = (set(device_params) | _tensor_params(fn.args)) \
            & set(_param_names(fn.args) + [a.arg
                                           for a in fn.args.kwonlyargs])
        self._body(fn, seeds, depth=0, factory=_is_factory(fn))

    def _body(self, fn, seeds: Set[str], depth: int,
              factory: bool) -> None:
        if id(fn) in self._visited or depth > 2:
            return
        self._visited.add(id(fn))
        device = _device_names(fn, seeds)
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                for name in sorted(_hot(node.test, device)):
                    self.emit(
                        "T1", node.lineno,
                        f"branch on device value {name!r} in a hot loop: "
                        f"the condition is read on the host, a sync per "
                        f"call (keep the decision on the device with "
                        f"torch.where, or branch on host state)")
            elif isinstance(node, ast.Call):
                self._call(node, device, depth, factory)

    def _call(self, node: ast.Call, device: Set[str], depth: int,
              factory: bool) -> None:
        func = node.func
        what = _build_call(node)
        if what is not None and not factory:
            self.emit(
                "T3", node.lineno,
                f"{what}() reached from a hot loop: a kernel build or "
                f"library load per call — make it once (module level, a "
                f"make_* factory, or a cached loader)")
            return
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_ATTRS and not _is_sync_call(
                    func.value) and (
                    _hot(func.value, device)
                    or _makes_device(func.value, device)):
                self.emit(
                    "T2", node.lineno,
                    f".{func.attr}() of a device value in a hot loop "
                    f"forces a device→host sync")
                return
            if func.attr == "synchronize":
                self.emit(
                    "T2", node.lineno,
                    "torch.cuda.synchronize() in a hot loop waits for "
                    "the whole device queue")
                return
            if func.attr in ("asarray", "array") \
                    and isinstance(func.value, ast.Name) \
                    and func.value.id in ("np", "numpy") and node.args \
                    and _hot(node.args[0], device):
                self.emit(
                    "T2", node.lineno,
                    f"np.{func.attr}() of a device value in a hot loop "
                    f"copies it to the host, a sync")
                return
            if func.attr in _SHAPE_BUILDERS and node.args:
                hot = _hot(node.args[0], device)
                if hot:
                    self.emit(
                        "T4", node.lineno,
                        f"device value {sorted(hot)[0]!r} in the shape "
                        f"argument of {func.attr}(): a shape is a host "
                        f"integer, so this syncs per call")
                    return
            if func.attr in _SHAPE_METHODS:
                hot: Set[str] = set()
                for a in node.args:
                    hot |= _hot(a, device)
                if hot:
                    self.emit(
                        "T4", node.lineno,
                        f"device value {sorted(hot)[0]!r} in the target "
                        f"shape of {func.attr}(): a shape is a host "
                        f"integer, so this syncs per call")
                    return
        elif isinstance(func, ast.Name):
            if func.id in ("float", "int", "bool") and node.args \
                    and _hot(node.args[0], device):
                names = sorted(_hot(node.args[0], device))
                self.emit(
                    "T2", node.lineno,
                    f"{func.id}() of device value {names[0]!r} in a hot "
                    f"loop is a device→host sync")
                return
            # one transitive hop: a bare-name call into a same-module
            # function checks that function too — its params bound to
            # our device args are device values there
            body = self.bodies.get(func.id)
            if isinstance(body, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = _param_names(body.args)
                passed: Set[str] = set()
                for i, a in enumerate(node.args):
                    if i < len(params) and _hot(a, device):
                        passed.add(params[i])
                self._body(body, passed, depth + 1,
                           factory or _is_factory(body))


def check_function(unit: FileUnit, qualname: str,
                   device_params: Iterable[str] = ()) -> List[Finding]:
    """T1-T4 over one named hot-loop function of a unit."""
    if unit.tree is None:
        e = unit.parse_error
        return [Finding(unit.path, (e.lineno or 0) if e else 0, "PARSE",
                        f"syntax error: {e.msg if e else 'unparseable'}")]
    fn = resolve_function(unit.tree, qualname)
    if fn is None:
        return [Finding(unit.path, 1, "T3",
                        f"hot-loop target {qualname!r} is not defined "
                        f"here: TRACE_TARGETS names a function that moved "
                        f"or was renamed")]
    findings: List[Finding] = []
    graph = call_graph_for(unit)
    bodies = graph.bodies if graph is not None else {}
    _LoopChecker(unit, bodies, suppressions_for(unit), findings).check(
        fn, device_params)
    return findings


def check_file(unit: FileUnit) -> List[Finding]:
    """T1-T4 over every top-level function and method of one file,
    each parameter annotated ``torch.Tensor`` a device value (the
    fixture entry point: a file outside the target table)."""
    if unit.tree is None:
        e = unit.parse_error
        return [Finding(unit.path, (e.lineno or 0) if e else 0, "PARSE",
                        f"syntax error: {e.msg if e else 'unparseable'}")]
    findings: List[Finding] = []
    graph = call_graph_for(unit)
    bodies = graph.bodies if graph is not None else {}
    checker = _LoopChecker(unit, bodies, suppressions_for(unit), findings)
    fns = [n for n in unit.tree.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for cls in unit.tree.body:
        if isinstance(cls, ast.ClassDef):
            fns += [n for n in cls.body
                    if isinstance(n, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))]
    for fn in fns:
        checker.check(fn, ())
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def analyze(root: Optional[str] = None, *,
            paths: Optional[Iterable[str]] = None,
            program: Optional[Program] = None) -> List[Finding]:
    """Run the static hot-loop pass.

    Default scope is the declared hot loops (``TRACE_TARGETS``) under
    the package root; pass ``paths`` to check arbitrary files
    (fixtures, new modules) through ``check_file``."""
    from .lint import default_root
    program = program if program is not None else Program()
    findings: List[Finding] = []
    if paths is not None:
        for unit in program.units(paths):
            findings.extend(check_file(unit))
    else:
        base = root if root is not None else default_root()
        for rel, targets in TRACE_TARGETS.items():
            p = os.path.join(base, rel)
            if not os.path.exists(p):
                continue
            unit = program.unit(p, rel=rel)
            for qualname, device_params in targets:
                findings.extend(check_function(unit, qualname,
                                               device_params))
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))


# --------------------------------------------------------------------------
# runtime half: the build guard
# --------------------------------------------------------------------------

class RecompileError(AssertionError):
    """A warmed hot loop built a kernel or loaded a library."""


class RecompileGuard:
    """Process-wide count of kernel builds and library loads.

    ``install()`` wraps ``ops/_build.build``/``load`` and
    ``stream/native.build``/``load`` with counting wrappers
    (idempotent); ``compiles()`` is the count so far and ``uninstall()``
    puts the originals back.  A call counts when it does the work: a
    build that finds its library (and log) on disk and a load that finds
    it in the process cache are not counted.
    """

    _lock = threading.Lock()
    _installed: Dict[Tuple[str, str], object] = {}
    _compiles = 0

    @classmethod
    def _bump(cls) -> None:
        with cls._lock:
            cls._compiles += 1

    @classmethod
    def _counting(cls, orig, does_work):
        """``orig`` wrapped to bump the count when ``does_work(*args)``
        says the call will build or load."""

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            if does_work(*args, **kwargs):
                cls._bump()
            return orig(*args, **kwargs)

        wrapped.__iotml_buildguard__ = True
        return wrapped

    @classmethod
    def install(cls) -> None:
        from ..ops import _build
        from ..stream import native

        def kernel_unbuilt(name: str) -> bool:
            lib = _build.library_path(name)
            return not (lib.exists() and lib.with_suffix(".log").exists())

        work = {
            (_build, "build"): kernel_unbuilt,
            (_build, "load"): lambda name: name not in _build._LOADED,
            (native, "build"): lambda *a, **k:
                not native.library_path(*a, **k).exists(),
            (native, "load"): lambda: native._lib is None,
        }
        with cls._lock:
            for (mod, attr), does_work in work.items():
                key = (mod.__name__, attr)
                if key not in cls._installed:
                    orig = getattr(mod, attr)
                    cls._installed[key] = orig
                    setattr(mod, attr, cls._counting(orig, does_work))

    @classmethod
    def uninstall(cls) -> None:
        import importlib

        with cls._lock:
            for (mod_name, attr), orig in cls._installed.items():
                setattr(importlib.import_module(mod_name), attr, orig)
            cls._installed.clear()

    @classmethod
    def compiles(cls) -> int:
        with cls._lock:
            return cls._compiles


@contextlib.contextmanager
def expect_no_recompile(label: str = "hot loop"):
    """Assert the enclosed block builds and loads nothing."""
    RecompileGuard.install()
    before = RecompileGuard.compiles()
    yield
    grew = RecompileGuard.compiles() - before
    if grew:
        raise RecompileError(
            f"{label}: {grew} kernel build(s) or library load(s) inside "
            f"a block expected to be warm")


#: (id(self), label, signature) -> warmed; cleared per test by the
#: pytest plugin so id() reuse across tests cannot alias
_WARMED: Set[tuple] = set()


def reset_warm() -> None:
    _WARMED.clear()


def _leaves(obj, out: list, depth: int = 0) -> None:
    if depth > 4:
        out.append(type(obj).__name__)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _leaves(v, out, depth + 1)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            _leaves(obj[k], out, depth + 1)
    else:
        out.append(obj)


def _abstract_sig(args, kwargs) -> tuple:
    """Shape/dtype signature: two calls with the same signature must
    reuse every library the first one built or loaded, so a build or
    load on the second is a per-call one.  Tensors and arrays key on
    shape, dtype (and a tensor on its device type); Python scalars of
    int/str/bool on their value; anything else (a batch source, a
    window) on its type."""
    leaves: list = []
    _leaves((args, kwargs), leaves)
    out = []
    for leaf in leaves:
        if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            dev = getattr(getattr(leaf, "device", None), "type", None)
            out.append((tuple(leaf.shape), str(leaf.dtype), dev))
        elif isinstance(leaf, (int, float, bool, str, bytes,
                               type(None))):
            out.append((type(leaf).__name__, leaf
                        if isinstance(leaf, (int, str, bool)) else None))
        else:
            out.append(type(leaf).__name__)
    return tuple(out)


def guard_hot_loop(fn, label: Optional[str] = None):
    """Wrap a hot-loop method: the first call per (instance, signature)
    is the warm-up; any later same-signature call that builds a kernel
    or loads a library raises RecompileError (fails the test)."""
    RecompileGuard.install()
    tag = label or getattr(fn, "__qualname__", getattr(fn, "__name__",
                                                       "hot-loop"))

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        key = (id(self), tag, _abstract_sig(args, kwargs))
        before = RecompileGuard.compiles()
        out = fn(self, *args, **kwargs)
        if key in _WARMED and RecompileGuard.compiles() > before:
            raise RecompileError(
                f"{tag}: warmed hot loop built a kernel or loaded a "
                f"library after the warm-up call with an identical "
                f"shape/dtype signature")
        _WARMED.add(key)
        return out

    wrapped.__iotml_traceguard__ = True
    wrapped.__wrapped__ = fn
    return wrapped


#: the hot loops the pytest plugin guards under IOTML_TRACECHECK=1
_GUARD_TARGETS = (
    ("iotml_torch.train.loop", "Trainer", "fit_compiled"),
    ("iotml_torch.parallel.streaming", "ShardedStreamTrainer", "fit_round"),
    ("iotml_torch.parallel.streaming", "ShardedStreamTrainer",
     "fit_compiled"),
    ("iotml_torch.online.learner", "OnlineLearner", "_update"),
)


def install_runtime_guard() -> List[str]:
    """Patch the known hot loops with guard_hot_loop (idempotent).
    Returns the list of patched qualnames (for the plugin's report)."""
    import importlib

    patched: List[str] = []
    for mod_name, cls_name, meth in _GUARD_TARGETS:
        try:
            mod = importlib.import_module(mod_name)
            cls = getattr(mod, cls_name)
            fn = cls.__dict__.get(meth)
        except Exception:
            continue
        if fn is None or getattr(fn, "__iotml_traceguard__", False):
            continue
        setattr(cls, meth, guard_hot_loop(fn, f"{cls_name}.{meth}"))
        patched.append(f"{cls_name}.{meth}")
    return patched


def uninstall_runtime_guard() -> List[str]:
    """Unwrap what ``install_runtime_guard`` patched and restore the
    build/load functions; returns the unwrapped qualnames."""
    import importlib

    unwrapped: List[str] = []
    for mod_name, cls_name, meth in _GUARD_TARGETS:
        cls = getattr(importlib.import_module(mod_name), cls_name)
        fn = cls.__dict__.get(meth)
        if fn is not None and getattr(fn, "__iotml_traceguard__", False):
            setattr(cls, meth, fn.__wrapped__)
            unwrapped.append(f"{cls_name}.{meth}")
    RecompileGuard.uninstall()
    reset_warm()
    return unwrapped
