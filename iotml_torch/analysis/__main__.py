"""``python -m iotml_torch.analysis`` — run the port's checkers.

    python -m iotml_torch.analysis lint [PATH ...] [--rule R2 --rule R4]
    python -m iotml_torch.analysis protocol      # wire-protocol conformance
    python -m iotml_torch.analysis tracecheck    # hot-loop discipline
    python -m iotml_torch.analysis drift         # registry drift
    python -m iotml_torch.analysis lockorder     # static lock-order edges
    python -m iotml_torch.analysis all [PATH ...]
    python -m iotml_torch.analysis rules

Every verb exits 1 when any finding survives (0 on a clean tree),
printing ``path:line: RULE message`` per finding — the format editors
and CI annotate from.  ``all`` runs lint + protocol + tracecheck +
drift over ONE shared parse of the tree (each file is read and parsed
exactly once; the summary reports wall time and files parsed).
``lockorder`` prints the statically-extracted acquire-order edges and
fails only on a static cycle.
"""

from __future__ import annotations

import argparse
import sys
import time

from .lint import RULES, default_root, lint_paths
from .program import Program


def _summary(label: str, n_findings: int, program: Program,
             t0: float, quiet: bool) -> None:
    if quiet:
        return
    dt = time.monotonic() - t0
    print(f"iotml_torch.analysis {label}: {n_findings} finding(s), "
          f"{program.parsed()} file(s) parsed once, {dt:.2f}s wall",
          file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.analysis",
        description="concurrency & protocol-invariant checkers")
    sub = ap.add_subparsers(dest="cmd")

    lp = sub.add_parser("lint", help="run the AST lint pass (R1-R16)")
    lp.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the iotml_torch "
                         "package)")
    lp.add_argument("--rule", action="append", dest="rules", metavar="RN",
                    choices=sorted(RULES),
                    help="restrict to specific rules (repeatable)")
    lp.add_argument("--quiet", action="store_true",
                    help="suppress the summary line")

    for verb, help_ in (
            ("protocol", "wire-protocol conformance (P1-P7): server/"
                         "client/cluster/C++ symmetry"),
            ("tracecheck", "hot-loop discipline (T1-T4): device-value "
                           "branches, host syncs, per-call builds"),
            ("drift", "registry drift (D1-D4): env knobs, metric "
                      "labels, faultpoints, doc rows"),
            ("lockorder", "static lock-order extraction: print edges, "
                          "fail on a static cycle"),
            ("all", "lint + protocol + tracecheck + drift over one "
                    "shared parse")):
        vp = sub.add_parser(verb, help=help_)
        vp.add_argument("paths", nargs="*",
                        help="files/dirs (default: the iotml_torch package)")
        vp.add_argument("--quiet", action="store_true",
                        help="suppress the summary line")

    sub.add_parser("rules", help="print the rule table")

    args = ap.parse_args(argv)
    if args.cmd == "rules":
        from .drift import PASS_RULES as D_RULES
        from .protocol import PASS_RULES as P_RULES
        from .tracecheck import PASS_RULES as T_RULES
        for table in (RULES, P_RULES, T_RULES, D_RULES):
            for rid in sorted(table, key=lambda r: (r[0], int(r[1:]))):
                print(f"{rid}  {table[rid]}")
        return 0
    if args.cmd is None:
        ap.print_help()
        return 2

    t0 = time.monotonic()
    program = Program()
    findings = []

    if args.cmd == "lockorder":
        from . import lockorder
        root = args.paths[0] if args.paths else None
        edges = lockorder.analyze(root, program=program)
        for a, b, where in edges:
            print(f"{a} -> {b}  (at {where})")
        cycles = lockorder.cycles_among(edges)
        for cyc in cycles:
            print(f"STATIC CYCLE: {' -> '.join(cyc)}")
        if not args.quiet:
            dt = time.monotonic() - t0
            print(f"iotml_torch.analysis lockorder: {len(edges)} edge(s), "
                  f"{len(cycles)} static cycle(s), "
                  f"{program.parsed()} file(s) parsed once, "
                  f"{dt:.2f}s wall", file=sys.stderr)
        return 1 if cycles else 0

    if args.cmd == "lint":
        paths = args.paths or [default_root()]
        findings = lint_paths(paths,
                              set(args.rules) if args.rules else None,
                              program=program)
    elif args.cmd == "protocol":
        from . import protocol
        root = args.paths[0] if args.paths else None
        findings = protocol.analyze(root, program=program)
    elif args.cmd == "tracecheck":
        from . import tracecheck
        if args.paths:
            findings = tracecheck.analyze(paths=args.paths,
                                          program=program)
        else:
            findings = tracecheck.analyze(program=program)
    elif args.cmd == "drift":
        from . import drift
        root = args.paths[0] if args.paths else None
        findings = drift.analyze(root, program=program)
    elif args.cmd == "all":
        from . import drift, protocol, tracecheck
        paths = args.paths or [default_root()]
        root = args.paths[0] if args.paths else None
        findings = list(lint_paths(paths, program=program))
        findings += protocol.analyze(root, program=program)
        findings += tracecheck.analyze(root, program=program)
        findings += drift.analyze(root, program=program)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))

    for f in findings:
        print(f)
    _summary(args.cmd, len(findings), program, t0, args.quiet)
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main())
