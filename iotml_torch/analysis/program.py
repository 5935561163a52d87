"""Shared parse plane for the whole-program analysis passes.

A copy of the JAX package's ``analysis/program.py`` (numpy-free, so the
port keeps its own): a ``Program`` parses each file exactly once and
every pass (lint, protocol conformance, trace discipline, registry
drift, lock order) shares the same ``FileUnit`` (source, AST, line
table) plus whatever derived artifacts (suppression tables, call
graphs) the passes memoize onto it via ``FileUnit.cached``.

Nothing here knows about rules; the unit cache is a plain keyed memo so
lint's ``_Suppressions``/``_ModuleCallGraph`` and the new passes'
extractors can all live behind one parse without import cycles.
"""

from __future__ import annotations

import ast
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: directories never worth parsing
SKIP_DIRS = frozenset({"__pycache__", "build", ".git", ".venv",
                       "node_modules"})


class FileUnit:
    """One parsed source file: path, display-relative path, source text,
    AST (None on syntax error, with the error kept), and a keyed memo
    for pass-specific derived artifacts (suppressions, call graphs,
    extracted tables) so they are computed once per file per process."""

    __slots__ = ("path", "rel", "source", "tree", "parse_error", "_memo")

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree: Optional[ast.Module] = ast.parse(source,
                                                        filename=path)
        except SyntaxError as e:
            self.tree = None
            self.parse_error = e
        self._memo: Dict[str, object] = {}

    def cached(self, key: str, build: Callable[["FileUnit"], object]):
        """Memoized derived artifact: computed once, shared across every
        pass that asks with the same key."""
        if key not in self._memo:
            self._memo[key] = build(self)
        return self._memo[key]


def iter_py_files(paths: Iterable[str]) -> Iterable[Tuple[str, str]]:
    """Yield (abs_path, display_rel_path) for every .py under `paths`."""
    for root in paths:
        root = os.path.abspath(root)
        if os.path.isfile(root):
            yield root, os.path.basename(root)
            continue
        base = os.path.dirname(root)
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = os.path.join(dirpath, fn)
                    yield p, os.path.relpath(p, base)


class Program:
    """Parse-once view of a file set, shared across analysis passes.

    ``unit(path)`` parses on first access and memoizes by absolute
    path; ``units(paths)`` walks directories through the same cache, so
    running lint + protocol + tracecheck + drift over one tree parses
    each file exactly once.
    """

    def __init__(self) -> None:
        self._units: Dict[str, FileUnit] = {}

    def unit(self, path: str, rel: Optional[str] = None) -> FileUnit:
        key = os.path.abspath(path)
        u = self._units.get(key)
        if u is None:
            with open(key, "r", encoding="utf-8") as f:
                source = f.read()
            u = FileUnit(key, rel if rel is not None else path, source)
            self._units[key] = u
        return u

    def units(self, paths: Iterable[str]) -> List[FileUnit]:
        return [self.unit(p, rel) for p, rel in iter_py_files(paths)]

    def parsed(self) -> int:
        """Files parsed so far (the CLI summary's cache stat)."""
        return len(self._units)
