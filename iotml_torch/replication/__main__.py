"""CLI: live replication drills (the exit status is the invariant
verdict).

    python -m iotml_torch.replication drill [--name double-fault|reassign]
                                            [--seed 7] [--records 1500]
    python -m iotml_torch.replication list
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_drill(args) -> int:
    from .drill import DRILLS

    names = list(DRILLS) if args.name == "all" else [args.name]
    ok = True
    for name in names:
        report = DRILLS[name](seed=args.seed, records=args.records)
        print(json.dumps(report.to_dict(), indent=2, default=str))
        for line in report.lines():
            print(line, file=sys.stderr)
        ok = ok and report.ok
    return 0 if ok else 1


def cmd_list(_args) -> int:
    from .drill import DRILLS

    for name, fn in sorted(DRILLS.items()):
        doc = (fn.__doc__ or "").strip().splitlines()[0]
        print(f"{name:14s} {doc}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.replication",
        description="quorum ISR durability and elastic "
                    "reassignment drills")
    sub = ap.add_subparsers(dest="cmd", required=True)

    drill = sub.add_parser("drill", help="run a live drill")
    drill.add_argument("--name", default="all",
                       choices=("all", "double-fault", "reassign"))
    drill.add_argument("--seed", type=int, default=7)
    drill.add_argument("--records", type=int, default=1500)
    drill.set_defaults(fn=cmd_drill)

    lst = sub.add_parser("list", help="list drills")
    lst.set_defaults(fn=cmd_list)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
