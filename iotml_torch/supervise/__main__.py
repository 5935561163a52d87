"""``python -m iotml_torch.supervise``: the live chaos drills.

    python -m iotml_torch.supervise drill [--drill NAME | --all] [--seed S]
                                          [--records N] [--json]
                                          [--slo-promote S] [--slo-score S]
    python -m iotml_torch.supervise list

``drill`` runs a live drill (real threads, real wire servers, real
supervision) and exits with its verdict: 0 when the system healed itself
and every delivery invariant held.  The drills' scorers and the
leader-kill trainer run on ``cuda``; ``main(argv, device="cpu")`` runs
them on the CPU.  ``list`` shows the drills.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.device import DeviceLike


def main(argv=None, *, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.supervise",
        description="supervised runtime: live chaos drills with "
                    "recovery SLOs")
    sub = ap.add_subparsers(dest="cmd")
    dp = sub.add_parser("drill", help="run a live drill; exit status is "
                                      "the invariant verdict")
    dp.add_argument("--drill", default="leader-kill",
                    help="drill name (see `list`)")
    dp.add_argument("--all", action="store_true",
                    help="run every drill in sequence")
    dp.add_argument("--seed", type=int, default=7)
    dp.add_argument("--records", type=int, default=0,
                    help="records to pump (0 = the drill's default)")
    dp.add_argument("--slo-promote", type=float, default=10.0,
                    help="leader-kill: max seconds kill -> promotion")
    dp.add_argument("--slo-score", type=float, default=20.0,
                    help="leader-kill: max seconds kill -> first "
                         "post-failover score")
    dp.add_argument("--json", action="store_true")
    sub.add_parser("list", help="list available drills")
    args = ap.parse_args(argv)

    from .drill import DRILLS

    if args.cmd == "list":
        for name, fn in sorted(DRILLS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:<14} {doc}")
        return 0
    if args.cmd != "drill":
        ap.print_help()
        return 2

    names = sorted(DRILLS) if args.all else [args.drill]
    unknown = [n for n in names if n not in DRILLS]
    if unknown:
        print(f"unknown drill(s) {unknown}; have: {sorted(DRILLS)}",
              file=sys.stderr)
        return 2
    ok = True
    for name in names:
        kw = {"seed": args.seed, "device": device}
        if args.records:
            kw["records"] = args.records
        if name == "leader-kill":
            kw["slo_promote_s"] = args.slo_promote
            kw["slo_first_score_s"] = args.slo_score
        report = DRILLS[name](**kw)
        if args.json:
            print(json.dumps(report.to_dict(), indent=2, sort_keys=True,
                             default=str))
        else:
            print("\n".join(report.lines()))
        ok = ok and report.ok
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
