"""``python -m iotml_torch.online`` — online-learning CLI
(``python -m iotml.online``'s twin).

    python -m iotml_torch.online drill [--seed S] [--records N] [--json]
                                       [--slo-detect-records N]
    python -m iotml_torch.online run [--servers HOST:PORT] [--topic T]
                                     [--registry DIR] [--window N]
                                     [--detector ph|adwin|both]
                                     [--max-seconds S]
    python -m iotml_torch.online list

``drill`` runs the drift-adapt-swap drill (seeded regional drift →
detect → adapt → publish → fleet hot-swap → AUC recovery → rollback gate
rejects a wrecked adaptation) and exits with the invariant verdict.
``run`` attaches an ``OnlineLearner`` to a Kafka wire server and trains
until stopped, printing one JSON line per drain that trained and a final
``describe()``.  Both run on ``cuda``; ``main(argv, device="cpu")`` runs
them on the CPU from Python.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils.device import DeviceLike, resolve_device


def main(argv=None, *, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.online",
        description="true online learning: incremental updates, drift "
                    "detection, drift-triggered adaptation")
    sub = ap.add_subparsers(dest="cmd")
    dp = sub.add_parser("drill", help="run the live drift-adapt-swap "
                                      "drill; exit status = verdict")
    dp.add_argument("--drill", default="drift-adapt-swap",
                    help="drill name (see `list`)")
    dp.add_argument("--seed", type=int, default=7)
    dp.add_argument("--records", type=int, default=0,
                    help="records to pump (0 = the drill's default)")
    dp.add_argument("--slo-detect-records", type=int, default=1500,
                    help="max records between drift onset and detection")
    dp.add_argument("--json", action="store_true")
    rp = sub.add_parser("run", help="attach an online learner to a "
                                    "live broker")
    rp.add_argument("--servers", default="127.0.0.1:9092",
                    help="bootstrap host:port list (kafka wire)")
    rp.add_argument("--topic", default="SENSOR_DATA_S_AVRO")
    rp.add_argument("--group", default="cardata-online")
    rp.add_argument("--registry", default="",
                    help="model-registry root (default: "
                         "IOTML_MLOPS_REGISTRY_DIR)")
    rp.add_argument("--window", type=int, default=0,
                    help="records per incremental update "
                         "(0 = config online.window)")
    rp.add_argument("--detector", default="",
                    choices=("", "ph", "adwin", "both"))
    rp.add_argument("--max-seconds", type=float, default=0.0,
                    help="stop after this long (0 = run forever)")
    sub.add_parser("list", help="list available drills")
    args = ap.parse_args(argv)

    from .drill import DRILLS

    if args.cmd == "list":
        for name, fn in sorted(DRILLS.items()):
            doc = (fn.__doc__ or "").strip().splitlines()[0]
            print(f"{name:<18} {doc}")
        return 0
    if args.cmd == "run":
        return _run(args, resolve_device(device))
    if args.cmd != "drill":
        ap.print_help()
        return 2
    if args.drill not in DRILLS:
        print(f"unknown drill {args.drill!r}; have: {sorted(DRILLS)}",
              file=sys.stderr)
        return 2
    kw = {"seed": args.seed,
          "slo_detect_records": args.slo_detect_records,
          "device": resolve_device(device)}
    if args.records:
        kw["records"] = args.records
    report = DRILLS[args.drill](**kw)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2, sort_keys=True,
                         default=str))
    else:
        print("\n".join(report.lines()))
    return 0 if report.ok else 1


def _run(args, device) -> int:
    from ..config import load_config
    from ..mlops import ModelRegistry
    from ..stream.kafka_wire import KafkaWireBroker
    from .detectors import DriftMonitor
    from .learner import AdaptationPolicy, OnlineLearner

    cfg, _ = load_config([])
    oc = cfg.online
    registry_root = args.registry or cfg.mlops.registry_dir
    registry = ModelRegistry(registry_root) if registry_root else None
    broker = KafkaWireBroker(args.servers)
    monitor = DriftMonitor(
        detector=args.detector or oc.detector,
        ph_delta=oc.ph_delta, ph_threshold=oc.ph_threshold,
        adwin_delta=oc.adwin_delta)
    policy = AdaptationPolicy(
        action=oc.adapt, lr_boost=oc.lr_boost,
        boost_updates=oc.boost_updates, refit_epochs=oc.refit_epochs)
    learner = OnlineLearner(
        broker, args.topic, registry=registry, group=args.group,
        window=args.window or oc.window, monitor=monitor,
        policy=policy, buffer_batches=oc.buffer_batches,
        publish_every=oc.publish_every, device=device)

    def on_update(d):
        print(json.dumps({"updates": d["updates"], "loss": d["loss"],
                          "lr": d["lr"],
                          "drifts": d["monitor"]["drifts"],
                          "state": d["monitor"]["state"]}), flush=True)

    try:
        learner.run(max_seconds=args.max_seconds or None,
                    on_update=on_update)
    except KeyboardInterrupt:
        pass
    finally:
        learner.close()
    print(json.dumps(learner.describe(), default=str), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
