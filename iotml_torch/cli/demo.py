"""End-to-end demo: the reference's whole pipeline in one command
(``iotml.cli.demo``'s twin).

The reference demo needs a GKE cluster, Terraform, seven Helm releases, a
device-simulator fleet, a KSQL install, and two K8s app deployments before
the first anomaly score appears (reference `infrastructure/README.md`).
This command runs the same story in one process on one card:

  fleet (MQTT TCP) → bridge → sensor-data → KSQL pipeline → framed Avro →
  fit (one launch of the fused fit kernel) → checkpoint → artifact store →
  scorer → ordered predictions + anomaly verdicts → report

    python -m iotml_torch.cli.demo [--cars 50] [--seconds 8] [--epochs 5]

Prints a JSON summary (records through each stage, final loss, anomaly
counts) with the JAX CLI's keys and exits cleanly — also usable as the
port's integration smoke test.  The report's SVG needs matplotlib; where
it is not installed the demo says so on a line of its own and uploads
report.json alone.  Runs on ``cuda``; ``main(argv, device="cpu")`` runs it
on the CPU from Python.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import tempfile
import time

from ..utils.device import DeviceLike


def main(argv=None, device: DeviceLike = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m iotml_torch.cli.demo",
                                 description=__doc__)
    ap.add_argument("--cars", type=int, default=50)
    ap.add_argument("--seconds", type=float, default=8.0,
                    help="how long the fleet publishes before training")
    ap.add_argument("--rate", type=float, default=10.0, help="msgs/car/s")
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--failure-rate", type=float, default=0.02)
    ap.add_argument("--threshold", type=float, default=None,
                    help="anomaly threshold on reconstruction error "
                         "(default: 99th percentile of training errors)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..cli.up import Platform
    from ..data.dataset import SensorBatches
    from ..evaluate.anomaly import evaluate_detector, reconstruction_errors
    from ..evaluate.report import write_report
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..serve.scorer import StreamScorer
    from ..stream.consumer import StreamConsumer
    from ..stream.producer import OutputSequence
    from ..train.artifacts import ArtifactStore
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import Trainer

    t_start = time.perf_counter()
    plat = Platform(partitions=4, device=device).start()
    dev = plat.device
    try:
        # ---- L1/L2: fleet publishes over real MQTT for a while
        plat.start_fleet(args.cars, rate_hz=args.rate,
                         failure_rate=args.failure_rate)
        print(f"fleet: {args.cars} cars @ {args.rate}/s over MQTT "
              f"for {args.seconds}s ...")
        deadline = time.monotonic() + args.seconds
        while time.monotonic() < deadline:
            time.sleep(0.25)
            plat.pump()  # L4: KSQL pipeline keeps up with the stream
        plat.stop_fleet()
        # the front may still hold unparsed frames and the KSQL pump runs
        # on its own thread: train and score only once every published
        # message has reached the KSQL output and it stopped moving
        ingested = plat.drain_ingest()

        # ---- L5 train: consume the KSQL output topic, one fused fit
        spec = plat.broker.topic("SENSOR_DATA_S_AVRO")
        consumer = StreamConsumer(
            plat.broker,
            [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(spec.partitions)],
            group="demo-train")
        batches = SensorBatches(consumer, batch_size=100, only_normal=True)
        trainer = Trainer(CAR_AUTOENCODER, device=dev)
        history = trainer.fit_compiled(batches, epochs=args.epochs)
        if not history["loss"]:
            print("no records ingested; is the fleet publishing?")
            return 1

        # ---- checkpoint → artifact store (the train→bucket→serve handoff)
        root = tempfile.mkdtemp(prefix="iotml_demo_store_")
        ckpt = CheckpointManager(tempfile.mkdtemp(prefix="iotml_demo_ck_"))
        path = ckpt.save(trainer.state, cursors=consumer.positions())
        ArtifactStore(root).upload_tree(path, "demo-model")

        # ---- threshold from training reconstruction errors
        threshold = args.threshold
        if threshold is None:
            consumer.seek_to_start()
            # normal rows only: an anomaly-contaminated percentile would
            # inflate the threshold past the very anomalies it must catch
            sample = next(iter(SensorBatches(consumer, batch_size=512,
                                             only_normal=True)))
            errs = reconstruction_errors(CAR_AUTOENCODER,
                                         trainer.state.params,
                                         sample.x[: sample.n_valid],
                                         device=dev)
            threshold = float(np.percentile(np.asarray(errs), 99.0))

        # ---- L5 serve: score everything, ordered write-back + verdicts
        consumer2 = StreamConsumer(
            plat.broker,
            [f"SENSOR_DATA_S_AVRO:{p}:0" for p in range(spec.partitions)],
            group="demo-serve")
        scorer = StreamScorer(
            CAR_AUTOENCODER, trainer.state.params,
            SensorBatches(consumer2, batch_size=100),
            OutputSequence(plat.broker, "model-predictions", partition=0),
            threshold=threshold, device=dev)
        scored = scorer.score_available()

        anomalies = 0
        n_pred = plat.broker.end_offset("model-predictions", 0)
        off = plat.broker.begin_offset("model-predictions", 0)
        while off < n_pred:
            for m in plat.broker.fetch("model-predictions", 0, off, 2048):
                anomalies += b"|anomaly|" in m.value
                off = m.offset + 1

        # ---- persisted model-quality report beside the model (the
        # notebook's ROC/PR/threshold cells as report.json + report.svg).
        # Re-read through the serve consumer (rewound) rather than a third
        # consumer group; the one extra batched forward pass computes the
        # labeled scores the scorer does not retain
        consumer2.seek_to_start()
        xs, ys = [], []
        for b in SensorBatches(consumer2, batch_size=512, keep_labels=True):
            xs.append(b.x[: b.n_valid])
            ys.append(b.labels[: b.n_valid])
        x_eval = np.concatenate(xs)
        y_eval = np.concatenate(ys) != "false"
        eval_scores = np.asarray(reconstruction_errors(
            CAR_AUTOENCODER, trainer.state.params, x_eval, device=dev))
        eval_report = evaluate_detector(CAR_AUTOENCODER, trainer.state.params,
                                        x_eval, y_eval, threshold=threshold,
                                        scores=eval_scores, device=dev)
        # the SVG needs matplotlib, which a card's machine may not have:
        # the report then holds report.json alone, and says so
        svg = importlib.util.find_spec("matplotlib") is not None
        if not svg:
            print("report: matplotlib is not installed; report.svg is not "
                  "rendered, report.json is")
        report_paths = write_report(
            eval_report, eval_scores, y_eval,
            tempfile.mkdtemp(prefix="iotml_demo_report_"),
            store=ArtifactStore(root), name="demo-model-eval", svg=svg)

        summary = {
            "cars": args.cars,
            "mqtt_messages_bridged": ingested,
            "ksql_avro_records": sum(
                plat.broker.end_offset("SENSOR_DATA_S_AVRO", p)
                for p in range(spec.partitions)),
            "trained_records_per_epoch": history["records"][0],
            "epochs": args.epochs,
            "loss_first_to_last": [round(history["loss"][0], 4),
                                   round(history["loss"][-1], 4)],
            "anomaly_threshold": round(threshold, 4),
            "scored": scored,
            "anomalies_flagged": int(anomalies),
            "roc_auc": round(eval_report.roc_auc, 4),
            "avg_precision": round(eval_report.avg_precision, 4),
            "eval_report": report_paths["uploaded"] or report_paths["json"],
            "wall_seconds": round(time.perf_counter() - t_start, 2),
        }
        print(json.dumps(summary, indent=2))
        return 0
    finally:
        plat.stop()


if __name__ == "__main__":
    raise SystemExit(main())
