"""Long-lived train and score services over the Kafka wire, the continuous
twin of the batch CLIs (``iotml.cli.live``'s twin):

    python -m iotml_torch.cli.live train <servers> <topic> <artifact_root>
    python -m iotml_torch.cli.live score <servers> <topic> <result_topic> \\
        <artifact_root>

One process each, as ``deploy/model-training.yaml`` and
``deploy/model-predictions.yaml`` separate the pods.  The trainer fits a
round (one launch of the fit kernel) and publishes it; the scorer waits
for the first model, then scores the stream, hot-swaps each new round
between super-batches and writes predictions and car-health alert
transitions back.  With ``--registry DIR`` the trainer publishes every
round as a committed, offsets-stamped registry version (an async
checkpointer, ``--checkpoint-interval-s`` its cadence) and resumes from
the registry's newest version; the scorer follows the registry's serving
channel.  The ``mlops`` config section (``IOTML_MLOPS_*``) sets the
queue depth, retention, optimizer archival, promote-on-publish and the
scorer's channel poll.  Both connect through the native Kafka client
(``stream.native_kafka.NativeKafkaBroker``), whose fetch and decode are
one C++ call; ``--sasl USER:PASS`` authenticates with SASL/PLAIN.
``--stats`` prints one JSON line a round or drain; both exit 0 when
stdin closes or reads a ``STOP`` line, or after ``--max-seconds``.  Both
run on ``cuda``; ``main(argv, device="cpu")`` runs them on the CPU from
Python.

Differences from the JAX package's CLI:
- ``--model-name`` defaults to ``cardata-live.h5`` as there, and rounds
  are Keras h5; a name not ending in ``.h5`` stores the port's checkpoint
  (npz + JSON) instead, which ``iotml_torch.cli.serve`` can serve too.
- ``IOTML_MLOPS_REGISTRY_DIR`` (the config's ``mlops.registry_dir``)
  stands in for ``--registry`` when the flag is not given, as the config
  section documents it.
- ``--metrics-port N`` serves ``/metrics`` and ``/healthz``
  (``obs.metrics.start_http_server``; 0, the default, is off; a port
  that cannot be bound raises) until ``main`` returns.
- A flag the port has not got raises NotImplementedError naming its
  ROADMAP item when given: ``--mesh-data`` and ``--device-normalize`` (A10),
  ``--prefetch-depth`` (A10: only the mesh paths build a
  ``data.prefetch.DevicePrefetcher``, in the JAX package too).
- ``--decode-ring-buffers``, ``--raw-batch-bytes``, ``--raw-produce`` and
  ``--produce-batch-bytes`` set their knobs (``IOTML_DECODE_RING_BUFFERS``,
  ``IOTML_RAW_BATCH_BYTES``, ``IOTML_RAW_PRODUCE``,
  ``IOTML_PRODUCE_BATCH_BYTES``) through ``data.pipeline.set_knobs`` for
  every pipeline the process builds afterwards; an invalid value is a
  usage error (exit 2).
- There is no fallback to the pure-Python client: a native client that
  cannot connect raises (``ConnectionError``, an ``OSError``).
- The stdin watcher, ``iotml-stdin-watch``, is a daemon thread in the
  supervise registry (``supervise.registry.register_thread``).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from ..utils.device import DeviceLike, resolve_device

#: unported flags → the ROADMAP item that ports them
UNPORTED = {"mesh_data": "A10", "device_normalize": "A10",
            "prefetch_depth": "A10"}


def _stopper(max_seconds: float):
    """stop() that trips on stdin EOF, a STOP line or the deadline."""
    ev = threading.Event()

    def watch_stdin():
        try:
            for line in sys.stdin:
                if line.strip() == "STOP":
                    break
        except (OSError, ValueError):
            return  # no readable stdin (a captured one): the deadline rules
        ev.set()

    from ..supervise.registry import register_thread

    register_thread(threading.Thread(target=watch_stdin, daemon=True,
                                     name="iotml-stdin-watch")).start()
    deadline = time.time() + max_seconds if max_seconds else None
    return lambda: ev.is_set() or (deadline is not None
                                   and time.time() > deadline)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.cli.live",
        description="continuous train/score services over the Kafka wire")
    sub = ap.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="continuous trainer → artifacts")
    tr.add_argument("servers")
    tr.add_argument("topic")
    tr.add_argument("artifact_root")
    tr.add_argument("--group", default="cardata-live-train")
    tr.add_argument("--take-batches", type=int, default=20)
    tr.add_argument("--batch-size", type=int, default=100)
    tr.add_argument("--epochs-per-round", type=int, default=1)
    tr.add_argument("--backfill-since-ms", type=int, default=None,
                    help="cold start: begin at the first record at or "
                         "after this timestamp where the broker can seek "
                         "by time; a committed cursor still wins")
    tr.add_argument("--checkpoint-interval-s", type=float, default=0.5,
                    help="async-checkpoint cadence with --registry: "
                         "snapshots arriving faster are coalesced "
                         "(newest wins); 0 archives every round")

    sc = sub.add_parser("score", help="continuous scorer with hot-swap")
    sc.add_argument("servers")
    sc.add_argument("topic")
    sc.add_argument("result_topic")
    sc.add_argument("artifact_root")
    sc.add_argument("--group", default="cardata-live-score")
    sc.add_argument("--threshold", type=float, default=5.0)
    sc.add_argument("--car-threshold", default="0.38",
                    help="per-car EMA alert level, or 'auto' (fleet-"
                         "quantile calibration; needs a stable model)")
    sc.add_argument("--car-feature-heads", action="store_true",
                    help="per-feature error and value-drift heads on the "
                         "car detector (pair with --normalize full)")
    sc.add_argument("--batch-size", type=int, default=100)
    sc.add_argument("--wait-model-seconds", type=float, default=120.0)

    for p in (tr, sc):
        p.add_argument("--model-name", default="cardata-live.h5")
        p.add_argument("--normalize", choices=("parity", "full"),
                       default="parity",
                       help="parity = the reference's normalization; full "
                            "= all 18 fields live.  Train and score must "
                            "match.")
        p.add_argument("--sasl", default=None, metavar="USER:PASS")
        p.add_argument("--stats", action="store_true",
                       help="print one JSON line per round/drain")
        p.add_argument("--max-seconds", type=float, default=0.0,
                       help="exit after this long (0 = until stdin closes)")
        p.add_argument("--wait-topic-seconds", type=float, default=60.0,
                       help="wait this long for the input topic to appear")
        p.add_argument("--registry", default=None, metavar="DIR",
                       help="versioned model registry root: train "
                            "publishes async checkpoints stamped with "
                            "stream offsets; score follows the serving "
                            "channel")
        p.add_argument("--prefetch-depth", type=int, default=None,
                       help="not ported (A10)")
        p.add_argument("--decode-ring-buffers", type=int, default=None,
                       help="reusable columnar decode buffers (sets "
                            "IOTML_DECODE_RING_BUFFERS; default 4)")
        p.add_argument("--raw-batch-bytes", type=int, default=None,
                       help="max bytes per raw frame fetch (sets "
                            "IOTML_RAW_BATCH_BYTES; default 1 MiB)")
        p.add_argument("--raw-produce", default=None,
                       choices=("auto", "on", "off"),
                       help="raw produce plane (sets IOTML_RAW_PRODUCE; "
                            "default auto)")
        p.add_argument("--produce-batch-bytes", type=int, default=None,
                       help="max frame bytes per RAW_PRODUCE request "
                            "(sets IOTML_PRODUCE_BATCH_BYTES; default "
                            "1 MiB)")
        p.add_argument("--metrics-port", type=int, default=0,
                       help="serve /metrics + /healthz on this port "
                            "(0 = off)")
        p.add_argument("--mesh-data", type=int, default=None,
                       help="not ported (A10)")
        p.add_argument("--device-normalize", default=None,
                       choices=("0", "1"), help="not ported (A10)")
    return ap


def main(argv=None, *, device: DeviceLike = None) -> int:
    """Run one service until it is stopped; returns the exit code (1 when
    the input topic never appears; argparse exits 2 on bad arguments)."""
    ap = _parser()
    args = ap.parse_args(argv)
    for name, item in UNPORTED.items():
        if getattr(args, name, None) is not None:
            flag = "--" + name.replace("_", "-")
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    from ..data.pipeline import set_knobs

    try:
        set_knobs(decode_ring_buffers=args.decode_ring_buffers,
                  raw_batch_bytes=args.raw_batch_bytes,
                  produce_batch_bytes=args.produce_batch_bytes,
                  raw_produce=args.raw_produce)
    except ValueError as e:
        ap.error(str(e))
    car_th = None
    if args.cmd == "score":
        car_th = args.car_threshold if args.car_threshold == "auto" \
            else float(args.car_threshold)
    device = resolve_device(device)  # no card and no device: raise now

    from ..config import load_config
    from ..core.normalize import CAR_NORMALIZER, FULL_NORMALIZER
    from ..mlops import AsyncCheckpointer, ModelRegistry
    from ..stream.native_kafka import NativeKafkaBroker
    from ..train.artifacts import ArtifactStore

    # the env-resolved mlops policy (IOTML_MLOPS_*): queue depth,
    # promote-on-publish, optimizer archival, retention, the scorer's
    # channel poll; the CLI flag owns the cadence
    mcfg = load_config([])[0].mlops
    registry_root = args.registry or mcfg.registry_dir

    metrics_srv = None
    if args.metrics_port:
        from ..obs.metrics import start_http_server

        metrics_srv = start_http_server(args.metrics_port)
    user, pw = args.sasl.split(":", 1) if args.sasl else (None, None)
    try:
        broker = NativeKafkaBroker(args.servers, sasl_username=user,
                                   sasl_password=pw)
    except BaseException:
        _stop_server(metrics_srv)
        raise
    try:
        stop = _stopper(args.max_seconds)
        # the input topic may be created by an upstream stage: wait for it
        deadline = time.time() + args.wait_topic_seconds
        while broker.refresh_topic(args.topic) is None:
            if stop() or time.time() > deadline:
                print(f"topic {args.topic} not available after "
                      f"{args.wait_topic_seconds}s")
                return 1
            time.sleep(0.1)

        def emit(stats: dict) -> None:
            if args.stats:
                print(json.dumps(stats), flush=True)

        normalizer = (FULL_NORMALIZER if args.normalize == "full"
                      else CAR_NORMALIZER)
        store = ArtifactStore(args.artifact_root)
        registry = checkpointer = None
        if registry_root:
            registry = ModelRegistry(registry_root)
        if args.cmd == "train":
            from ..train.live import ContinuousTrainer

            if registry is not None:
                registry.recover()  # sweep torn publishes of a prior kill
                checkpointer = AsyncCheckpointer(
                    registry, queue_depth=mcfg.queue_depth,
                    save_opt_state=mcfg.save_opt_state,
                    auto_promote=mcfg.auto_promote,
                    keep_versions=mcfg.keep_versions,
                    min_interval_s=args.checkpoint_interval_s)
            svc = ContinuousTrainer(
                broker, args.topic, store, model_name=args.model_name,
                group=args.group, batch_size=args.batch_size,
                take_batches=args.take_batches,
                epochs_per_round=args.epochs_per_round,
                normalizer=normalizer,
                backfill_since_ms=args.backfill_since_ms,
                registry=registry, checkpointer=checkpointer, device=device)
            print(f"live train: {args.topic} rounds of "
                  f"{args.take_batches}x{args.batch_size} -> "
                  f"{args.artifact_root}/{args.model_name}"
                  + (f" + registry {registry_root}" if registry else ""),
                  flush=True)
            try:
                rounds = svc.run(stop=stop, on_round=emit)
            finally:
                svc.close()  # flush pending checkpoints, stop the writer
            print(f"live train done: {rounds} rounds, "
                  f"{svc.records_trained} records, last loss "
                  f"{svc.last_loss}", flush=True)
            return 0
        from ..serve.live import LiveScorer

        svc = LiveScorer(broker, args.topic, args.result_topic, store,
                         model_name=args.model_name, group=args.group,
                         threshold=args.threshold, car_threshold=car_th,
                         car_feature_heads=args.car_feature_heads,
                         batch_size=args.batch_size, normalizer=normalizer,
                         registry=registry, watch_poll_s=mcfg.watch_poll_s,
                         device=device)
        artifact = svc.wait_for_model(args.wait_model_seconds)
        print(f"live score: model {artifact} loaded; "
              f"{args.topic} -> {args.result_topic}", flush=True)
        n = svc.run(stop=stop, on_drain=emit)
        print(f"live score done: {n} rows, {svc.model_updates} model "
              f"updates, quality {svc.scorer.quality}", flush=True)
        return 0
    finally:
        broker.close()
        _stop_server(metrics_srv)


def _stop_server(srv) -> None:
    if srv is not None:
        srv.shutdown()
        srv.server_close()


if __name__ == "__main__":
    raise SystemExit(main())
