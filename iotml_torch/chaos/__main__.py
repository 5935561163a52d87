"""``python -m iotml_torch.chaos`` — the fault-injection CLI
(``iotml.chaos``'s twin):

    python -m iotml_torch.chaos run --scenario mqtt-flap --seed 7 \
                                    --records 2000 [--json] [--spans PATH]
    python -m iotml_torch.chaos run --list
    python -m iotml_torch.chaos schedule --scenario mqtt-flap --seed 7 \
                                         --records 2000

``--list`` enumerates the scenarios with their topology; ``schedule``
prints a scenario's canonical schedule text, byte-identical for the same
(scenario, seed, records) and equal to the JAX package's.  ``run``
drives the pipeline under a scenario and prints the injected faults, the
invariant verdicts and the traced topologies' stage-latency breakdown
(exit status 0 iff every invariant passed); ``--spans PATH`` keeps that
span log.  ``compaction-under-crash`` drives the twin service and raises
NotImplementedError naming ROADMAP A16.  ``main(argv, device=...)`` runs
the scorers and trainers on ``device`` (``cuda`` unless given).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import TYPE_CHECKING

from .scenarios import SCENARIOS, build

if TYPE_CHECKING:  # the schedule command starts without torch
    from ..utils.device import DeviceLike


def _print_list() -> None:
    for name in sorted(SCENARIOS):
        _builder, topology, desc = SCENARIOS[name]
        print(f"{name:<24} [{topology:>6}]  {desc}")


def cmd_run(args, device: DeviceLike = None) -> int:
    if args.list:
        _print_list()
        return 0
    if not args.scenario:
        print("run: --scenario NAME required (see --list)",
              file=sys.stderr)
        return 2
    from .runner import ChaosRunner

    runner = ChaosRunner(args.scenario, seed=args.seed,
                         records=args.records, span_path=args.spans,
                         device=device)
    if args.spans and runner.schedule.topology == "wire":
        print("note: --spans has no effect on a wire-topology scenario "
              "(trace headers end at the TCP boundary by design)",
              file=sys.stderr)
    report = runner.run()
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True))
        return 0 if report.ok else 1

    print(f"scenario {report.scenario}  seed={report.seed}  "
          f"records={report.records}  topology={report.topology}")
    print(f"published={report.published}  scored={report.scored}  "
          f"rewinds={report.rewinds}  "
          f"accounted_drops={report.dropped_accounted}")
    print("\ninjected faults:")
    if report.injected:
        for label, n in report.injected.items():
            print(f"  {n:>6}  {label}")
    else:
        print("  (none fired)")
    print("\ninvariants:")
    for inv in report.invariants:
        print(f"  {inv.verdict()}")
    print("\nstage latency (obs.tracing breakdown of the faulted run):")
    if report.span_path:
        from ..obs.__main__ import load_spans, print_table, summarize

        stages, e2e = load_spans(report.span_path)
        print_table(summarize(stages, e2e))
        print(f"\nspan log: {report.span_path}")
    else:
        print("  (no spans: wire topology — trace headers end at the "
              "TCP boundary by design)")
    print(f"\nverdict: {'PASS' if report.ok else 'FAIL'}")
    return 0 if report.ok else 1


def cmd_schedule(args) -> int:
    sys.stdout.write(build(args.scenario, seed=args.seed,
                           records=args.records).text())
    return 0


def main(argv=None, device: DeviceLike = None) -> int:
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
        return cmd_run(args, device)
    if args.cmd == "schedule":
        return cmd_schedule(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
