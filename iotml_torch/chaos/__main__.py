"""``python -m iotml_torch.chaos`` — the fault-schedule CLI
(``iotml.chaos``'s twin):

    python -m iotml_torch.chaos run --list
    python -m iotml_torch.chaos schedule --scenario mqtt-flap --seed 7 \\
                                         --records 2000

``--list`` enumerates the scenarios with their topology; ``schedule``
prints a scenario's canonical schedule text, byte-identical for the same
(scenario, seed, records) and equal to the JAX package's.  ``run
--scenario`` drives the runner's topologies, which are ROADMAP A14: it
raises NotImplementedError naming the item (the ``alert-burn`` drill runs
through ``python -m iotml_torch.obs tsdb drill``).
"""

from __future__ import annotations

import argparse
import sys

from .scenarios import SCENARIOS, build


def _print_list() -> None:
    for name in sorted(SCENARIOS):
        _builder, topology, desc = SCENARIOS[name]
        print(f"{name:<24} [{topology:>6}]  {desc}")


def cmd_run(args) -> int:
    if args.list:
        _print_list()
        return 0
    if not args.scenario:
        print("run: --scenario NAME required (see --list)",
              file=sys.stderr)
        return 2
    raise NotImplementedError(
        f"python -m iotml_torch.chaos run --scenario {args.scenario}: the "
        f"scenario runner's topologies are not ported yet (ROADMAP A14); "
        f"the alert-burn drill runs through python -m iotml_torch.obs "
        f"tsdb drill")


def cmd_schedule(args) -> int:
    sys.stdout.write(build(args.scenario, seed=args.seed,
                           records=args.records).text())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.chaos",
        description="deterministic fault injection with invariant-"
                    "checked failure scenarios")
    sub = ap.add_subparsers(dest="cmd")

    rp = sub.add_parser("run", help="drive the pipeline under a "
                                    "scenario and check invariants")
    rp.add_argument("--scenario", default="")
    rp.add_argument("--seed", type=int, default=7)
    rp.add_argument("--records", type=int, default=2000)
    rp.add_argument("--spans", default=None,
                    help="keep the JSONL span log at this path")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable report")
    rp.add_argument("--list", action="store_true",
                    help="enumerate built-in scenarios and exit")

    sp = sub.add_parser("schedule", help="print the canonical (byte-"
                                         "reproducible) fault schedule")
    sp.add_argument("--scenario", required=True)
    sp.add_argument("--seed", type=int, default=7)
    sp.add_argument("--records", type=int, default=2000)

    args = ap.parse_args(argv)
    if args.cmd == "run":
        return cmd_run(args)
    if args.cmd == "schedule":
        return cmd_schedule(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
