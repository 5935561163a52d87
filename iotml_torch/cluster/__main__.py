"""The cluster's command line (``iotml.cluster``'s twin).

    python -m iotml_torch.cluster up --brokers 3 --partitions 10 \\
        [--replication-factor 3 --min-isr 2] [--store-root DIR]
    python -m iotml_torch.cluster drill [--seed 7] [--records 2000]
    python -m iotml_torch.cluster add-broker --bootstrap H:P --shard 1
    python -m iotml_torch.cluster drain-broker --bootstrap H:P --shard 2
    python -m iotml_torch.cluster status --bootstrap H:P

``up`` boots N wire-served shard brokers (the reference's 3 brokers and
10 partitions), creates the topics, prints one bootstrap line any client
of the family reads (``ClusterClient(bootstrap=...)``) and serves until
interrupted (SIGINT).  With followers it arms per-shard failover under a
``Supervisor``.  ``drill`` runs the rebalance-under-chaos scenario and
exits non-zero on any failed invariant.  ``add-broker``,
``drain-broker`` and ``status`` reach the controller inside a running
``up`` over the CLUSTER_ADMIN extension and print its report (exit 1
unless the move ended moved or retired).

The pipeline knobs (``--prefetch-depth``, ``--decode-ring-buffers``,
``--raw-batch-bytes``, ``--raw-produce``, ``--produce-batch-bytes``,
``--mesh-data``, ``--device-normalize``) go through
``data.pipeline.set_knobs`` for the trainers this process's environment
starts; an invalid value is a usage error.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_up(args) -> int:
    from . import ClusterController

    ctl = ClusterController(
        brokers=args.brokers, host=args.host, store_root=args.store_root,
        replicated=args.replicated,
        replication_factor=args.replication_factor, min_isr=args.min_isr,
        base_port=args.base_port, advertise_host=args.advertise_host,
        mirror_groups=tuple(g for g in args.mirror_groups.split(",") if g))
    ctl.start()
    for topic in args.topics.split(","):
        if topic:
            ctl.create_topic(topic, partitions=args.partitions)
    if args.metrics_port:
        from ..obs.metrics import start_http_server

        start_http_server(args.metrics_port)
    sup = None
    if args.replicated or args.replication_factor:
        sup = ctl.supervised().start()
    if not args.quiet:
        print("iotml_torch cluster up:")
        for k, v in ctl.endpoints().items():
            print(f"  {k:14s} {v}")
        print(f"  topics         {args.topics} ({args.partitions} "
              f"partitions, {args.brokers}-way sharded)")
        print(f"  bootstrap      {ctl.bootstrap()}")
        if sup is not None:
            print(f"  supervisor     per-shard failover armed "
                  f"({ctl.n} probed shards)")
        print("Ctrl-C to stop.", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        if sup is not None:
            sup.stop()
        ctl.stop()
        if not args.quiet:
            print("stopped.", flush=True)
    return 0


def cmd_admin(args) -> int:
    """add-broker / drain-broker / status against a running ``up``."""
    from ..stream.kafka_wire import KafkaWireBroker

    client = KafkaWireBroker(args.bootstrap,
                             client_id="iotml-cluster-admin")
    try:
        payload = {}
        if args.cmd in ("add-broker", "drain-broker"):
            payload["shard"] = args.shard
        if getattr(args, "store_dir", None):
            payload["store_dir"] = args.store_dir
        doc = client.cluster_admin(args.cmd, payload)
    finally:
        client.close()
    print(json.dumps(doc, indent=2, default=str))
    return 0 if doc.get("state") in (None, "moved", "retired") else 1


def cmd_drill(args) -> int:
    # lint-ok: R7 CLI entry point delegating to the chaos harness — this
    # is drill orchestration (the runner's own caller), not a hot path
    from ..chaos.runner import ChaosRunner

    report = ChaosRunner("rebalance-under-chaos", seed=args.seed,
                         records=args.records).run()
    print(json.dumps(report.to_dict(), indent=2, default=str))
    for inv in report.invariants:
        print(inv.verdict(), file=sys.stderr)
    return 0 if report.ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.cluster",
        description="partitioned multi-broker data plane")
    sub = ap.add_subparsers(dest="cmd", required=True)

    up = sub.add_parser("up", help="boot an N-broker cluster and serve")
    up.add_argument("--brokers", type=int, default=3)
    up.add_argument("--partitions", type=int, default=10)
    up.add_argument("--topics", default="sensor-data,model-predictions")
    up.add_argument("--host", default="127.0.0.1")
    up.add_argument("--base-port", type=int, default=None,
                    help="fixed ports: shard i listens on base+i, its "
                         "followers above (default: ephemeral)")
    up.add_argument("--advertise-host", default=None,
                    help="the host clients dial when it differs from "
                         "--host")
    up.add_argument("--store-root", default=None,
                    help="durable mode: shard i mounts <root>/broker-<i> "
                         "(a cold restart resumes)")
    up.add_argument("--replicated", action="store_true",
                    help="one follower a shard and supervised per-shard "
                         "failover")
    up.add_argument("--replication-factor", type=int, default=None,
                    help="quorum mode: RF-1 ISR-tracked followers a "
                         "shard, acks=all at the quorum HWM, "
                         "ISR-restricted failover, and the add-broker / "
                         "drain-broker verbs")
    up.add_argument("--min-isr", type=int, default=2,
                    help="min.insync.replicas for acks=all (quorum mode)")
    up.add_argument("--mirror-groups", default="iotml",
                    help="comma list of groups whose offsets the "
                         "followers mirror")
    up.add_argument("--prefetch-depth", type=int, default=None,
                    help="host-to-device prefetch depth (sets "
                         "IOTML_PREFETCH_DEPTH)")
    up.add_argument("--decode-ring-buffers", type=int, default=None,
                    help="columnar decode buffers a pipeline (sets "
                         "IOTML_DECODE_RING_BUFFERS)")
    up.add_argument("--raw-batch-bytes", type=int, default=None,
                    help="max bytes a raw frame fetch (sets "
                         "IOTML_RAW_BATCH_BYTES)")
    up.add_argument("--raw-produce", default=None,
                    choices=("auto", "on", "off"),
                    help="the raw produce plane (sets IOTML_RAW_PRODUCE)")
    up.add_argument("--produce-batch-bytes", type=int, default=None,
                    help="max frame bytes a RAW_PRODUCE request (sets "
                         "IOTML_PRODUCE_BATCH_BYTES)")
    up.add_argument("--mesh-data", type=int, default=None,
                    help="data-parallel training for trainers launched "
                         "from this process's environment (sets "
                         "IOTML_MESH_DATA: data-axis devices; 0 = one "
                         "device)")
    up.add_argument("--device-normalize", default=None, choices=("0", "1"),
                    help="fold the normalization into the sharded train "
                         "step (sets IOTML_DEVICE_NORMALIZE; needs "
                         "--mesh-data >= 2)")
    up.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics and /healthz (0 = off)")
    up.add_argument("--quiet", action="store_true")
    up.set_defaults(fn=cmd_up)

    drill = sub.add_parser(
        "drill", help="rebalance-under-chaos (exit = invariant verdict)")
    drill.add_argument("--seed", type=int, default=7)
    drill.add_argument("--records", type=int, default=2000)
    drill.set_defaults(fn=cmd_drill)

    for verb, help_ in (("add-broker",
                         "online reassignment: a NEW broker node takes "
                         "over --shard (RAW_FETCH bootstrap, ISR join, "
                         "leadership move, the old leader retires)"),
                        ("drain-broker",
                         "move --shard's leadership onto an existing ISR "
                         "follower and retire the drained leader"),
                        ("status", "the cluster and its reassignments")):
        p = sub.add_parser(verb, help=help_)
        p.add_argument("--bootstrap", required=True,
                       help="any live broker (host:port[,...])")
        if verb != "status":
            p.add_argument("--shard", type=int, required=True)
        if verb == "add-broker":
            p.add_argument("--store-dir", default=None,
                           help="the new node's store directory (durable "
                                "clusters; default under the store root)")
        p.set_defaults(fn=cmd_admin, cmd=verb)

    args = ap.parse_args(argv)
    if args.cmd == "up":
        from ..data.pipeline import set_knobs

        try:
            set_knobs(prefetch_depth=args.prefetch_depth,
                      decode_ring_buffers=args.decode_ring_buffers,
                      raw_batch_bytes=args.raw_batch_bytes,
                      raw_produce=args.raw_produce,
                      produce_batch_bytes=args.produce_batch_bytes,
                      mesh_data=args.mesh_data,
                      device_normalize=None if args.device_normalize is None
                      else args.device_normalize == "1")
        except ValueError as e:
            ap.error(str(e))
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
