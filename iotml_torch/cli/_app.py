"""Shared scaffolding for the reference-contract streaming CLIs
(``iotml.cli._app``'s twin).

Both reference ML apps (``cardata-v3.py``, LSTM ``cardata-v2.py``) are
the same program with a different model: positional args, a train mode
that fits on a stream slice and uploads the checkpoint, and a predict
mode that restores it and writes ordered predictions back.
``run_streaming_app`` is that program once; ``cli.cardata`` and
``cli.lstm`` supply the model and knobs (the LSTM's: supervised, over
windows of the stream).  ``--train.*`` flags and
``IOTML_TRAIN_*`` env vars override the train knobs (``config``).

``<servers>`` is ``emulator[:n_records]``, an in-process broker seeded
with generated fleet data exactly as the JAX CLI seeds its own, or
``host:port[,...]``, a Kafka cluster or ``stream.kafka_wire``'s server
spoken to over the wire protocol, with the SASL/PLAIN credentials of the
``broker`` config section (``IOTML_BROKER_SASL_USERNAME`` /
``IOTML_BROKER_SASL_PASSWORD``, as the deploy manifests set them).

A model file whose name ends in ``.h5`` moves as a Keras h5 blob, as the
reference's does (cardata-v3.py:227-231): train exports the params
(``models.h5_export``, through ``utils.hdf5``) and uploads them, predict
downloads and imports them; any other name moves the port's checkpoint.
An app without h5 interop (the LSTM) refuses an ``.h5`` name with the JAX
CLI's message and exit 1.

A configured mesh (``--mesh.data`` / ``--mesh.model`` flags or a config
file, or the ``IOTML_MESH_DATA`` process knob at 2 or more, as the
deploy manifests set it) trains data-parallel
(``parallel.data_parallel.ShardedTrainer.fit``) over an ('data',
'model') mesh of the first devices of ``devices`` (every visible CUDA
device unless given; ``--mesh.data=-1`` takes them all) and prints
``mesh: {...} over N devices``; a mesh larger than the devices raises
ValueError, as JAX's CLI does.  On a multi-host Job
(``JAX_NUM_PROCESSES`` > 1) each process consumes its
``assign_partitions`` share of the topic (``JAX_PROCESS_ID``) and an
empty share trains nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, NamedTuple, Optional

from ..config import Config, load_config
from ..data.dataset import SensorBatches
from ..data.pipeline import mesh_data
from ..gen.simulator import FleetGenerator, FleetScenario
from ..models.h5_export import autoencoder_params_to_h5
from ..models.h5_import import autoencoder_params_from_h5
from ..parallel.data_parallel import ShardedTrainer
from ..parallel.distributed import assign_partitions
from ..parallel.mesh import auto_mesh, local_devices
from ..serve.scorer import StreamScorer
from ..stream import native
from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from ..stream.group import GroupCoordinator
from ..stream.kafka_wire import KafkaWireBroker, RemoteGroupCoordinator
from ..stream.producer import OutputSequence
from ..train.artifacts import ArtifactStore
from ..train.checkpoint import CheckpointManager
from ..train.loop import Trainer
from ..utils.device import DeviceLike


def _broker_for(servers: str, topic: str, cfg=None):
    """Resolve <servers>: 'emulator[:n]' seeds an in-process broker with
    ``n // 100`` ticks of a 100-car fleet (30,000 records by default);
    'host:port[,...]' connects the wire client with ``cfg.broker``'s
    SASL/PLAIN credentials (none when the username is empty; ``cfg``
    None is the defaults)."""
    if servers.startswith("emulator"):
        n = int(servers.split(":", 1)[1]) if ":" in servers else 30_000
        broker = Broker()
        gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
        gen.publish(broker, topic, n_ticks=max(1, n // 100))
        broker.create_topic("model-predictions")
        return broker
    creds = (cfg or Config()).broker
    return KafkaWireBroker(servers,
                           sasl_username=creds.sasl_username or None,
                           sasl_password=creds.sasl_password or None)


class Connection(NamedTuple):
    """What ``connected`` yields: the one place that tells the wire client
    from the in-process broker."""

    broker: object
    #: 'wire' or 'emulator' (the CLIs' stats lines carry it)
    kind: str
    #: group id → the group's coordinator: over the wire the group lives
    #: in the server, shared by the replicas' processes; in-process it
    #: lives here
    coordinator: Callable[[str], object]


@contextlib.contextmanager
def connected(servers: str, topic: str, cfg):
    """``_broker_for``'s broker for the block, as a ``Connection``; a wire
    client's socket is closed at its end."""
    broker = _broker_for(servers, topic, cfg)
    wire = isinstance(broker, KafkaWireBroker)
    coordinator = RemoteGroupCoordinator if wire else GroupCoordinator
    try:
        yield Connection(broker, "wire" if wire else "emulator",
                         lambda group: coordinator(broker, group))
    finally:
        if wire:
            broker.close()


def topic_partitions(broker, topic: str) -> range:
    """Every partition of ``topic``; partition 0 alone while the topic
    does not exist yet (a server's consumers may start before its
    producers)."""
    try:
        return range(broker.topic(topic).partitions)
    except KeyError:
        return range(1)


def _stats_delta(before: dict, *keys: str) -> dict:
    return {k: native.stats[k] - before[k] for k in keys}


def run_streaming_app(argv, *, prog: str, usage: str, make_model: Callable,
                      group: str, epochs: int, batch_size: int,
                      take_batches: int, predict_skip: int,
                      predict_take: int, supervised: bool = False,
                      window: Optional[int] = None,
                      h5_interop: bool = False,
                      device: DeviceLike = None, devices=None) -> int:
    """Run one train or predict job; returns the process exit code (1 on
    an argument error).  ``supervised`` and ``window`` are the LSTM's:
    fit ``model(x)`` to the next row, over [B, window, F] windows.
    ``h5_interop`` says whether the app takes ``.h5`` model files (the
    autoencoder's does; the LSTM's exits 1).
    ``device`` is where the model runs (``cuda`` unless given);
    ``devices`` are those a configured mesh is laid over (every visible
    CUDA device unless given; a device may repeat).  Each
    mode ends with a ``stats: {...}`` JSON line: losses and fit seconds
    (train), rows and scoring seconds (predict), and the rows and seconds
    of the native engine's decode and format calls."""
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
    if model_file.endswith(".h5") and not h5_interop:
        # fail BEFORE training, not after: the Keras-h5 exporter maps the
        # 4-Dense autoencoder stack only
        print(f"{prog}: '.h5' model files (Keras interop) are supported "
              f"for the autoencoder CLI only; use a plain name for an "
              f"orbax checkpoint")
        return 1
    offset = offset.strip().lower()
    if offset != "committed":
        offset = int(offset)

    applied = cfg.applied
    if "train.epochs" in applied:
        epochs = cfg.train.epochs
    if "train.batch_size" in applied:
        batch_size = cfg.train.batch_size
    if "train.take_batches" in applied:
        take_batches = cfg.train.take_batches

    # a configured mesh (flags, config file, or the IOTML_MESH_DATA knob
    # the deploy manifests set, >= 2 as everywhere) trains data-parallel
    use_mesh = bool({"mesh.data", "mesh.model"} & applied)
    knob = mesh_data()
    if knob >= 2 and "mesh.data" not in applied:
        cfg.mesh.data = knob
        use_mesh = True
    mesh = None
    if use_mesh:
        pool = list(devices) if devices is not None else local_devices()
        model_par = max(cfg.mesh.model, 1)
        n_dev = len(pool) if cfg.mesh.data in (-1, 0) \
            else cfg.mesh.data * model_par
        mesh = auto_mesh(n_dev, model_parallel=model_par, devices=pool)
        print(f"mesh: {dict(mesh.shape)} over {n_dev} devices")

    with connected(servers, topic, cfg) as conn:
        broker = conn.broker
        store = ArtifactStore(artifact_root)

        # this host's partition share: on an indexed multi-host Job each
        # process consumes a disjoint subset; an empty share (more hosts
        # than partitions) trains nothing rather than overlap another's.
        # `committed` resumes from the group's offset cursor
        n_parts = len(topic_partitions(broker, topic))
        n_hosts = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        host_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
        parts = assign_partitions(n_parts, n_hosts, host_id)
        if offset == "committed":
            consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                     group=group)
        else:
            consumer = StreamConsumer(broker,
                                      [f"{topic}:{p}:{offset}" for p in parts],
                                      group=group)
        if not parts:
            print(f"host {host_id}/{n_hosts}: no partition share of "
                  f"{n_parts}-partition topic {topic}; idle")
        model = make_model()
        before = dict(native.stats)

        if mode == "train":
            batches = SensorBatches(consumer, batch_size=batch_size,
                                    take=take_batches, window=window,
                                    only_normal=not supervised
                                    and cfg.train.only_normal)
            if mesh is not None:
                trainer = ShardedTrainer(
                    model, mesh, learning_rate=cfg.train.learning_rate,
                    supervised=supervised)
                history = trainer.fit(batches, epochs=epochs)
                if trainer.state is None:
                    history["loss"] = []
                # the step loop reports whole-epoch seconds only
                history["host_pipeline_s"] = None
                history["device_compute_s"] = None
                fit_s = sum(history["seconds"])
            else:
                trainer = Trainer(model, learning_rate=cfg.train.learning_rate,
                                  supervised=supervised, device=device)
                history = trainer.fit_compiled(batches, epochs=epochs)
                fit_s = None
            if not history["loss"]:
                print(f"No records on {topic} from offset {offset}; nothing "
                      f"trained, nothing stored")
                return 0
            print(f"Training complete, final loss {history['loss'][-1]:.6f}")
            ckpt_dir = tempfile.mkdtemp(prefix=f"iotml_torch_{prog}_ckpt_")
            try:
                if model_file.endswith(".h5"):
                    # the reference's artifact format: a consumer still on
                    # the reference stack can load models trained here
                    local_h5 = os.path.join(ckpt_dir, "model.h5")
                    autoencoder_params_to_h5(trainer.state.params, local_h5)
                    store.upload(local_h5, model_file)
                else:
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
                "mode": "train", "broker": conn.kind,
                "records": history["records"][0],
                "loss": history["loss"],
                "fit_seconds": fit_s if fit_s is not None
                else history["host_pipeline_s"]
                + history["device_compute_s"],
                "host_pipeline_s": history["host_pipeline_s"],
                "device_compute_s": history["device_compute_s"],
                **_stats_delta(before, "decode_rows", "decode_s")}))
            return 0

        print("Downloading model", model_file)
        restore_dir = tempfile.mkdtemp(prefix=f"iotml_torch_{prog}_restore_")
        try:
            local = os.path.join(restore_dir, "ckpt")
            if model_file.endswith(".h5"):
                payload = {"params": autoencoder_params_from_h5(
                    store.download(model_file, local))}
            else:
                payload = CheckpointManager.load_dir(
                    store.download_tree(model_file, local))
        finally:
            shutil.rmtree(restore_dir, ignore_errors=True)
        print("Loading model")
        batches = SensorBatches(consumer, batch_size=batch_size,
                                window=window, skip=predict_skip,
                                take=predict_take)
        out = OutputSequence(broker, result_topic, partition=0)
        scorer = StreamScorer(model, payload["params"], batches, out,
                              device=device)
        t0 = time.perf_counter()
        n = scorer.score_available()
        score_s = time.perf_counter() - t0
        print(f"predict complete: {n} records → {result_topic} "
              f"(end offset {broker.end_offset(result_topic, 0)})")
        print("stats:", json.dumps({
            "mode": "predict", "broker": conn.kind, "rows": n,
            "end_offset": broker.end_offset(result_topic, 0),
            "score_seconds": score_s,
            "host_pipeline_s": scorer.seconds["host_pipeline"],
            "device_compute_s": scorer.seconds["device_compute"],
            **_stats_delta(before, "decode_rows", "decode_s", "format_rows",
                           "format_s")}))
        return 0
