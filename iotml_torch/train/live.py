"""Continuous stream training with a publish every round
(``iotml.train.live``'s twin).

The reference's training side is a K8s Job that fits one slice, uploads
the model and exits; ``run.sh`` re-runs it and restarts the predict pods
so they download the new weights.  ``ContinuousTrainer`` is that loop as
one long-lived process: a persistent consumer cursor over the stream,
fixed-shape rounds (each one ``Trainer.fit_compiled``: one launch of the
fit kernel), and after every round an immutable versioned model upload
and an atomic flip of the ``{model_name}.latest`` pointer, which a
``serve.live.LiveScorer`` polls to hot-swap mid-stream.

A round trains on exactly ``take_batches`` batches of ``batch_size``
normal rows; it starts only once the stream holds ``min_available`` new
records (the round's records + 10%, so the label filter cannot starve its
last batch).  The group commit follows the publish: a crash re-trains a
slice, never skips one.

Round K stores the port's checkpoint (``train.checkpoint``, npz + JSON,
zipped as ``{model_name}.r{K}``), so ``python -m iotml_torch.cli.serve``
can serve any round; the JAX package stores Keras h5, not ported (ROADMAP
A5).  Not ported either: the versioned registry and its async
checkpointer (A5, and with it ``commit_manifest_offsets``), the
multi-device mesh (A10), the metrics registry's round counters (A13),
the train watermark and the chaos point of the poll loop (A3).
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Callable, Optional

from ..data.dataset import SensorBatches
from ..models.autoencoder import CAR_AUTOENCODER
from ..stream.consumer import StreamConsumer
from ..utils.device import DeviceLike
from .artifacts import ArtifactStore
from .checkpoint import CheckpointManager
from .loop import Trainer


class ContinuousTrainer:
    """Round-based continuous training → versioned artifacts + pointer.

    Args:
      broker: ``Broker`` duck-type (in-process, the wire client or the
        native client).
      topic: the input stream (the reference's SENSOR_DATA_S_AVRO).
      store/model_name: artifact root and base name: round K uploads
        ``{model_name}.r{K}`` then flips ``{model_name}.latest``.
      group: consumer group; the cursor resumes from its committed
        offsets and commits after each round's publish.
      take_batches × batch_size: records a round (default 20 × 100).
      backfill_since_ms: a partition with no committed offset starts at
        the first record at or after this timestamp, where the broker
        has ``offset_for_timestamp`` (the native client has not).
      device: where the fit runs (``cuda`` unless given).
    """

    def __init__(self, broker, topic: str, store: ArtifactStore,
                 model_name: str = "cardata-live",
                 group: str = "cardata-live-train",
                 batch_size: int = 100, take_batches: int = 20,
                 epochs_per_round: int = 1, normalizer=None,
                 backfill_since_ms: Optional[int] = None,
                 registry=None, checkpointer=None, mesh=None,
                 device: DeviceLike = None):
        if registry is not None or checkpointer is not None:
            raise NotImplementedError(
                "the versioned model registry and its async checkpointer "
                "are not ported yet (ROADMAP A5)")
        if mesh is not None:
            raise NotImplementedError(
                "a multi-device mesh is not ported yet (ROADMAP A10)")
        if model_name.endswith(".h5"):
            raise NotImplementedError(
                "'.h5' model files (Keras interop) are not ported yet "
                "(ROADMAP A5); use a plain name for a checkpoint")
        if store is None:
            raise ValueError("need an ArtifactStore to publish models to")
        self.broker = broker
        self.topic = topic
        self.store = store
        self.model_name = model_name
        self.group = group
        self.batch_size = batch_size
        self.take_batches = take_batches
        self.epochs_per_round = epochs_per_round
        self.trainer = Trainer(CAR_AUTOENCODER, device=device)
        parts = range(broker.topic(topic).partitions)
        # ONE persistent cursor for the process's lifetime
        self.consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                      group=group)
        if backfill_since_ms is not None:
            oft = getattr(broker, "offset_for_timestamp", None)
            if oft is not None:
                for p in parts:
                    if broker.committed(group, topic, p) is None:
                        self.consumer.seek(topic, p,
                                           oft(topic, p, backfill_since_ms))
        batch_kw = {} if normalizer is None else dict(normalizer=normalizer)
        self.batches = SensorBatches(self.consumer, batch_size=batch_size,
                                     take=take_batches, only_normal=True,
                                     **batch_kw)
        self.rounds = 0
        self.records_trained = 0
        self.last_loss: Optional[float] = None
        #: new records a round waits for: its records + 10%
        self.min_available = int(take_batches * batch_size * 1.1) + 1
        #: wall seconds over all rounds: the fit's host pipeline (poll,
        #: decode, batch, stack) and device legs, the publish
        #: (checkpoint, zip, upload, pointer) and the group commit
        self.seconds = {"host_pipeline": 0.0, "device_compute": 0.0,
                        "publish": 0.0, "commit": 0.0}

    # ------------------------------------------------------------ rounds
    def available(self) -> int:
        """Records between the persistent cursor and the log end."""
        return sum(self.broker.end_offset(t, p) - off
                   for t, p, off in self.consumer.positions())

    def train_round(self) -> dict:
        """One fixed-shape fit over the next slice, then the publish and
        the commit; {} when the slice was empty."""
        t0 = time.perf_counter()
        history = self.trainer.fit_compiled(self.batches,
                                            epochs=self.epochs_per_round)
        self.seconds["host_pipeline"] += history["host_pipeline_s"]
        self.seconds["device_compute"] += history["device_compute_s"]
        if not history["loss"]:
            return {}
        self.rounds += 1
        self.records_trained += history["records"][-1] * self.epochs_per_round
        self.last_loss = float(history["loss"][-1])
        t1 = time.perf_counter()
        artifact = self.publish()
        t2 = time.perf_counter()
        # commit AFTER the artifact is durable (the `committed` resume
        # contract: a crash re-trains the slice rather than skipping it)
        self.consumer.commit()
        t3 = time.perf_counter()
        self.seconds["publish"] += t2 - t1
        self.seconds["commit"] += t3 - t2
        return {"t": time.time(), "round": self.rounds,
                "loss": self.last_loss,
                "records": history["records"][-1],
                "records_cum": self.records_trained,
                "seconds": round(t3 - t0, 4),
                "artifact": artifact}

    def publish(self) -> str:
        """Upload round K's checkpoint as an immutable blob, then flip the
        pointer to it; returns the blob's name."""
        name = f"{self.model_name}.r{self.rounds}"
        ckpt_dir = tempfile.mkdtemp(prefix="iotml_torch_live_")
        try:
            path = CheckpointManager(ckpt_dir).save(
                self.trainer.state, cursors=self.consumer.positions())
            self.store.upload_tree(path, name)
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        self.store.put_text(f"{self.model_name}.latest", name)
        return name

    def run(self, stop: Optional[Callable[[], bool]] = None,
            max_rounds: Optional[int] = None,
            poll_interval_s: float = 0.05,
            on_round: Optional[Callable[[dict], None]] = None) -> int:
        """Train rounds until ``stop()`` or ``max_rounds``; returns the
        rounds run.  ``on_round`` gets each round's stats."""
        start = self.rounds
        while (stop is None or not stop()) and \
                (max_rounds is None or self.rounds - start < max_rounds):
            if self.available() < self.min_available:
                time.sleep(poll_interval_s)
                continue
            stats = self.train_round()
            if stats and on_round is not None:
                on_round(stats)
        return self.rounds - start
