"""CLI: ``python -m iotml_torch.twin drill`` — the live twin-rebuild
drill (``iotml.twin``'s command line).

Exit status is the verdict (0 = every invariant held), the same contract
as ``python -m iotml_torch.chaos run`` and the supervise/mlops drills.
"""

from __future__ import annotations

import argparse
import json
import sys

from .drill import run_twin_rebuild_drill


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m iotml_torch.twin")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("drill", help="kill + rebuild-from-changelog drill")
    d.add_argument("--seed", type=int, default=7)
    d.add_argument("--records", type=int, default=1000)
    d.add_argument("--json", action="store_true",
                   help="emit the full report as JSON")
    args = ap.parse_args(argv)

    report = run_twin_rebuild_drill(seed=args.seed, records=args.records)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, default=str))
    else:
        print(f"twin-rebuild drill  seed={report.seed} "
              f"records={report.records} published={report.published} "
              f"cars={report.cars} rebuilt={report.rebuilt_records} "
              f"compaction_removed={report.compaction_removed}")
        for inv in report.invariants:
            print(f"  {inv.verdict()}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
