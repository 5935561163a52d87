"""Shared scaffolding for the reference-contract streaming CLIs
(``iotml.cli._app``'s twin).

The reference ML app (``cardata-v3.py``) is a program with positional
args, a train mode that fits on a stream slice and uploads the
checkpoint, and a predict mode that restores it and writes ordered
predictions back.  ``run_streaming_app`` is that program once;
``cli.cardata`` supplies the model and knobs.  ``--train.*`` flags and
``IOTML_TRAIN_*`` env vars override the train knobs (``config``).

``<servers>`` is ``emulator[:n_records]``: an in-process broker seeded
with generated fleet data, exactly as the JAX CLI seeds its own.  The
parts the port does not have yet raise NotImplementedError naming their
ROADMAP item: ``host:port`` servers (the Kafka wire client), ``.h5``
model files (Keras interop), a multi-device mesh and a multi-host job.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable

from ..config import load_config
from ..data.dataset import SensorBatches
from ..gen.simulator import FleetGenerator, FleetScenario
from ..serve.scorer import StreamScorer
from ..stream import native
from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from ..stream.producer import OutputSequence
from ..train.artifacts import ArtifactStore
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer
from ..utils.device import DeviceLike


def _broker_for(servers: str, topic: str) -> Broker:
    """Resolve <servers>: 'emulator[:n]' seeds an in-process broker with
    ``n // 100`` ticks of a 100-car fleet (30,000 records by default)."""
    if servers.startswith("emulator"):
        n = int(servers.split(":", 1)[1]) if ":" in servers else 30_000
        broker = Broker()
        gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
        gen.publish(broker, topic, n_ticks=max(1, n // 100))
        broker.create_topic("model-predictions")
        return broker
    raise NotImplementedError(
        f"servers {servers!r}: the Kafka wire client is not ported yet "
        f"(ROADMAP A6); use emulator[:n_records]")


def _stats_delta(before: dict, *keys: str) -> dict:
    return {k: native.stats[k] - before[k] for k in keys}


def run_streaming_app(argv, *, prog: str, usage: str, make_model: Callable,
                      group: str, epochs: int, batch_size: int,
                      take_batches: int, predict_skip: int,
                      predict_take: int, device: DeviceLike = None) -> int:
    """Run one train or predict job; returns the process exit code (1 on
    an argument error).  ``device`` is where the model runs (``cuda``
    unless given).  Each mode ends with a ``stats: {...}`` JSON line:
    losses and fit seconds (train), rows and scoring seconds (predict),
    and the rows and seconds of the native engine's decode and format
    calls."""
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        cfg, argv = load_config(argv)
    except ValueError as e:
        print(f"config error: {e}")
        return 1
    print("Options: ", argv)
    if len(argv) != 7:
        print(usage)
        return 1
    servers, topic, offset, result_topic, mode, model_file, artifact_root = argv
    mode = mode.strip().lower()
    if mode not in ("train", "predict"):
        print(f"Mode is invalid, must be either 'train' or 'predict': {mode}")
        return 1
    if model_file.endswith(".h5"):
        # refused BEFORE training, so no training run ends in a failed
        # export
        raise NotImplementedError(
            f"{prog}: '.h5' model files (Keras interop) are not ported yet "
            f"(ROADMAP A5); use a plain name for a checkpoint")
    offset = offset.strip().lower()
    if offset != "committed":
        offset = int(offset)
    if int(os.environ.get("IOTML_MESH_DATA", "0") or 0) >= 2:
        raise NotImplementedError(
            "IOTML_MESH_DATA >= 2 asks for a multi-device mesh, which is "
            "not ported yet (ROADMAP A10)")
    if int(os.environ.get("JAX_NUM_PROCESSES", "1") or 1) > 1:
        raise NotImplementedError(
            "JAX_NUM_PROCESSES > 1 asks for a multi-host job with a "
            "partition share per host, which is not ported yet (ROADMAP "
            "A10)")

    applied = cfg.applied
    if "train.epochs" in applied:
        epochs = cfg.train.epochs
    if "train.batch_size" in applied:
        batch_size = cfg.train.batch_size
    if "train.take_batches" in applied:
        take_batches = cfg.train.take_batches

    broker = _broker_for(servers, topic)
    store = ArtifactStore(artifact_root)

    # one host consumes every partition; `committed` resumes from the
    # group's offset cursor
    parts = range(broker.topic(topic).partitions)
    if offset == "committed":
        consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                 group=group)
    else:
        consumer = StreamConsumer(broker,
                                  [f"{topic}:{p}:{offset}" for p in parts],
                                  group=group)
    model = make_model()
    before = dict(native.stats)

    if mode == "train":
        trainer = Trainer(model, learning_rate=cfg.train.learning_rate,
                          device=device)
        batches = SensorBatches(consumer, batch_size=batch_size,
                                take=take_batches,
                                only_normal=cfg.train.only_normal)
        history = trainer.fit_compiled(batches, epochs=epochs)
        if not history["loss"]:
            print(f"No records on {topic} from offset {offset}; nothing "
                  f"trained, nothing stored")
            return 0
        print(f"Training complete, final loss {history['loss'][-1]:.6f}")
        ckpt_dir = tempfile.mkdtemp(prefix=f"iotml_torch_{prog}_ckpt_")
        try:
            path = CheckpointManager(ckpt_dir).save(
                trainer.state, cursors=consumer.positions())
            store.upload_tree(path, model_file)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        # commit AFTER the checkpoint is durable: the group cursor is the
        # resume point the '<offset>=committed' rerun contract promises
        consumer.commit()
        print("Model stored successfully", model_file)
        print("stats:", json.dumps({
            "mode": "train", "records": history["records"][0],
            "loss": history["loss"],
            "fit_seconds": history["host_pipeline_s"]
            + history["device_compute_s"],
            "host_pipeline_s": history["host_pipeline_s"],
            "device_compute_s": history["device_compute_s"],
            **_stats_delta(before, "decode_rows", "decode_s")}))
        return 0

    print("Downloading model", model_file)
    restore_dir = tempfile.mkdtemp(prefix=f"iotml_torch_{prog}_restore_")
    try:
        local = store.download_tree(model_file,
                                    os.path.join(restore_dir, "ckpt"))
        payload = CheckpointManager.load_dir(local)
    finally:
        shutil.rmtree(restore_dir, ignore_errors=True)
    print("Loading model")
    batches = SensorBatches(consumer, batch_size=batch_size,
                            skip=predict_skip, take=predict_take)
    out = OutputSequence(broker, result_topic, partition=0)
    scorer = StreamScorer(model, payload["params"], batches, out,
                          device=device)
    t0 = time.perf_counter()
    n = scorer.score_available()
    score_s = time.perf_counter() - t0
    print(f"predict complete: {n} records → {result_topic} "
          f"(end offset {broker.end_offset(result_topic, 0)})")
    print("stats:", json.dumps({
        "mode": "predict", "rows": n,
        "end_offset": broker.end_offset(result_topic, 0),
        "score_seconds": score_s,
        "host_pipeline_s": scorer.seconds["host_pipeline"],
        "device_compute_s": scorer.seconds["device_compute"],
        **_stats_delta(before, "decode_rows", "decode_s", "format_rows",
                       "format_s")}))
    return 0
