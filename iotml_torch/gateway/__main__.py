"""CLI: the gateway serving plane, live (``iotml.gateway``'s copy).

``python -m iotml_torch.gateway drill``
    Kill a serving shard under a query storm, promote its warm standby,
    prove zero wrong answers.  Exit status is the verdict (0 = every
    invariant held) — CI and deploy/smoke.sh gate on it directly, the
    same contract as the twin/chaos/supervise drills.

``python -m iotml_torch.gateway front --stream HOST:PORT``
    Run ONE federated MQTT ingest front in this process: serve MQTT,
    bridge into the wire-protocol stream broker, announce the bound
    port as a JSON line, exit when stdin closes.  Spawned by
    ``FrontProcess``; useful standalone for manual federation.

``python -m iotml_torch.gateway fleet --cars 100000 --fronts 2``
    The reference's full 100,000-car scenario, live: N front processes,
    a consistent car→front assignment, the sharded gateway serving
    every car.  Exit status is the verdict.
"""

from __future__ import annotations

import argparse
import json
import sys

from .drill import run_gateway_drill
from .fronts import run_federated_fleet, run_front


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m iotml_torch.gateway")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("drill",
                       help="shard-kill + standby-promotion drill "
                            "under a query storm")
    d.add_argument("--seed", type=int, default=11)
    d.add_argument("--records", type=int, default=2000)
    d.add_argument("--cars", type=int, default=40)
    d.add_argument("--shards", type=int, default=2)
    d.add_argument("--partitions", type=int, default=4)
    d.add_argument("--json", action="store_true",
                   help="emit the full report as JSON")

    f = sub.add_parser("front",
                       help="one federated MQTT ingest front process")
    f.add_argument("--stream", required=True,
                   help="wire broker bootstrap, host:port")
    f.add_argument("--partitions", type=int, default=10)
    f.add_argument("--mqtt-port", type=int, default=0)
    f.add_argument("--topic", default="SENSOR_DATA_S_AVRO")

    fl = sub.add_parser("fleet",
                        help="federated fleet scenario: N fronts, "
                             "sharded gateway, every car served")
    fl.add_argument("--cars", type=int, default=100_000)
    fl.add_argument("--fronts", type=int, default=2)
    fl.add_argument("--ticks", type=int, default=2)
    fl.add_argument("--shards", type=int, default=2)
    fl.add_argument("--partitions", type=int, default=8)
    fl.add_argument("--seed", type=int, default=20)
    args = ap.parse_args(argv)

    if args.cmd == "front":
        run_front(args.stream, partitions=args.partitions,
                  mqtt_port=args.mqtt_port, topic=args.topic)
        return 0

    if args.cmd == "fleet":
        report = run_federated_fleet(
            cars=args.cars, fronts=args.fronts, ticks=args.ticks,
            shards=args.shards, partitions=args.partitions,
            seed=args.seed)
        print(json.dumps(report, indent=2))
        return 0 if report["ok"] else 1

    report = run_gateway_drill(seed=args.seed, records=args.records,
                               cars=args.cars, n_shards=args.shards,
                               partitions=args.partitions)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, default=str))
    else:
        print(f"gateway drill  seed={report.seed} cars={report.cars} "
              f"shards={report.n_shards} published={report.published} "
              f"storm_queries={report.storm_queries} "
              f"storm_p99_ms={report.storm_p99_ms} "
              f"promote_s={report.slos['promote_s']} "
              f"staleness_s={report.slos['staleness_s']}")
        for inv in report.invariants:
            print(f"  {inv.verdict()}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
