"""Continuous stream training with a publish every round
(``iotml.train.live``'s twin).

The reference's training side is a K8s Job that fits one slice, uploads
the model and exits; ``run.sh`` re-runs it and restarts the predict pods
so they download the new weights.  ``ContinuousTrainer`` is that loop as
one long-lived process: a persistent consumer cursor over the stream,
fixed-shape rounds (each one ``Trainer.fit_compiled``: one launch of the
fit kernel), and after every round a publish.

A round trains on exactly ``take_batches`` batches of ``batch_size``
normal rows; it starts only once the stream holds ``min_available`` new
records (the round's records + 10%, so the label filter cannot starve its
last batch).

Two ways to publish:

- **store mode**: round K uploads an immutable blob ``{model_name}.r{K}``
  and flips the ``{model_name}.latest`` pointer, which a
  ``serve.live.LiveScorer`` polls; a name ending in ``.h5`` (the
  default, as in the JAX package) stores Keras h5, any other name the
  port's checkpoint (``train.checkpoint``, npz + JSON, zipped), which
  ``python -m iotml_torch.cli.serve`` can serve too.  The group commit
  follows the publish: a crash re-trains a slice, never skips one.
- **registry mode** (``mlops``): each round's state is snapshotted on
  this thread (one device→host copy) with the cursors it was trained
  through, and an ``AsyncCheckpointer`` writer publishes it as a
  committed registry version; the GROUP COMMIT trails that durability
  (``commit_manifest_offsets`` on the writer thread), so committed
  offsets never pass the newest durable manifest's, and a restarted
  trainer resumes the lineage tip's weights, Adam state and cursors.

Each round counts into ``live_train_rounds_total``, sets
``live_train_loss`` and publishes the ``train`` watermark from the
consumer's event-time ranges; the poll loop passes the chaos point
``trainer.poll``.  Not ported: the multi-device mesh (ROADMAP A10).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

from ..chaos import faults as chaos
from ..data.dataset import SensorBatches
from ..mlops.checkpoint import AsyncCheckpointer, restore_trainer
from ..models.autoencoder import CAR_AUTOENCODER
from ..models.h5_export import autoencoder_params_to_h5
from ..obs import metrics as obs_metrics
from ..obs import watermark
from ..stream.consumer import StreamConsumer
from ..utils.device import DeviceLike
from .artifacts import ArtifactStore
from .checkpoint import CheckpointManager
from .loop import Trainer


def commit_manifest_offsets(broker, group: str, manifest) -> None:
    """Commit a durable manifest's stamped offsets for ``group``,
    FORWARD-ONLY and ``commit_many``-batched where the broker has it:
    the post-durability half of offsets-as-checkpoint (``committed <=
    newest durable manifest`` at every instant).  Runs on the checkpoint
    writer's thread."""
    by_topic: dict = {}
    for t, p, off in manifest.offsets:
        cur = broker.committed(group, t, p)
        if cur is None or off > cur:
            by_topic.setdefault(t, []).append((p, off))
    commit_many = getattr(broker, "commit_many", None)
    for t, entries in by_topic.items():
        if commit_many is not None:
            commit_many(group, t, entries)
        else:
            for p, off in entries:
                broker.commit(group, t, p, off)


class ContinuousTrainer:
    """Round-based continuous training → versioned artifacts + pointer,
    or registry versions.

    Args:
      broker: ``Broker`` duck-type (in-process, the wire client or the
        native client).
      topic: the input stream (the reference's SENSOR_DATA_S_AVRO).
      store/model_name: artifact root and base name (store mode): round
        K uploads ``{model_name}.r{K}`` then flips ``{model_name}.latest``.
      group: consumer group; the cursor resumes from its committed
        offsets (and a registry's manifest cursors, forward only).
      take_batches × batch_size: records a round (default 20 × 100).
      backfill_since_ms: a partition with no committed offset (and no
        manifest cursor) starts at the first record at or after this
        timestamp, where the broker has ``offset_for_timestamp`` (the
        native client has not).
      registry/checkpointer: registry mode (a ``ModelRegistry``, or an
        ``AsyncCheckpointer`` over one); with ``warm_start`` the trainer
        resumes from the registry's newest committed version;
        ``checkpoint_interval_s`` is the cadence of a checkpointer made
        here.
      device: where the fit runs (``cuda`` unless given).
    """

    def __init__(self, broker, topic: str, store: Optional[ArtifactStore],
                 model_name: str = "cardata-live.h5",
                 group: str = "cardata-live-train",
                 batch_size: int = 100, take_batches: int = 20,
                 epochs_per_round: int = 1, only_normal: bool = True,
                 normalizer=None,
                 backfill_since_ms: Optional[int] = None,
                 registry=None, checkpointer=None, warm_start: bool = True,
                 checkpoint_interval_s: float = 0.0, mesh=None,
                 device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "a multi-device mesh is not ported yet (ROADMAP A10)")
        if store is None and registry is None and checkpointer is None:
            raise ValueError("need an ArtifactStore, a ModelRegistry, or "
                             "an AsyncCheckpointer to publish models to")
        self.broker = broker
        self.topic = topic
        self.store = store
        self.model_name = model_name
        self.group = group
        self.batch_size = batch_size
        self.take_batches = take_batches
        self.epochs_per_round = epochs_per_round
        self.trainer = Trainer(CAR_AUTOENCODER, device=device)
        self.registry = registry
        self.checkpointer = checkpointer
        if registry is not None and checkpointer is None:
            self.checkpointer = AsyncCheckpointer(
                registry, min_interval_s=checkpoint_interval_s)
        if self.checkpointer is not None:
            self.registry = self.checkpointer.registry
            self.checkpointer.commit_fn = self._commit_checkpointed
        parts = range(broker.topic(topic).partitions)
        # ONE persistent cursor for the process's lifetime
        self.consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                      group=group)
        # registry warm start: the newest committed version's weights (+
        # Adam state when archived) and its stamped offsets; the manifest
        # beats both offset 0 and backfill for its partitions (the
        # restored model already knows the data up to those cursors)
        manifest_offsets = {}
        self.restored_version: Optional[int] = None
        if self.registry is not None and warm_start:
            m = restore_trainer(self.trainer, self.registry)
            if m is not None:
                manifest_offsets = {(t, p): off for t, p, off in m.offsets}
                self.restored_version = m.version
        if backfill_since_ms is not None:
            oft = getattr(broker, "offset_for_timestamp", None)
            if oft is not None:
                for p in parts:
                    if broker.committed(group, topic, p) is None and \
                            (topic, p) not in manifest_offsets:
                        self.consumer.seek(topic, p,
                                           oft(topic, p, backfill_since_ms))
        # manifest cursors FORWARD-ONLY: committed can trail the manifest
        # (the commit follows the checkpoint) but is never rewound
        for (t, p), off in manifest_offsets.items():
            cur = broker.committed(group, t, p) or 0
            if off > cur:
                self.consumer.seek(t, p, off)
        batch_kw = {} if normalizer is None else dict(normalizer=normalizer)
        self.batches = SensorBatches(self.consumer, batch_size=batch_size,
                                     take=take_batches, only_normal=only_normal,
                                     **batch_kw)
        self.rounds = 0
        self.records_trained = 0
        self.last_loss: Optional[float] = None
        self._last_coalesced = False
        #: new records a round waits for: its records + 10%
        self.min_available = int(take_batches * batch_size * 1.1) + 1
        #: wall seconds over all rounds: the fit's host pipeline (poll,
        #: decode, batch, stack) and device legs, the publish (store mode:
        #: serialize, upload, pointer; registry mode: the snapshot) and
        #: the group commit (store mode)
        self.seconds = {"host_pipeline": 0.0, "device_compute": 0.0,
                        "publish": 0.0, "commit": 0.0}

    # ------------------------------------------------------------ rounds
    def available(self) -> int:
        """Records between the persistent cursor and the log end."""
        return sum(self.broker.end_offset(t, p) - off
                   for t, p, off in self.consumer.positions())

    def train_round(self) -> dict:
        """One fixed-shape fit over the next slice, then the publish (and
        in store mode the commit); {} when the slice was empty."""
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
        obs_metrics.live_train_rounds.inc()
        obs_metrics.live_train_loss.set(self.last_loss)
        # the round's slice is trained: the ingest→train watermark
        watermark.observe_taken("train", self.consumer.take_event_time(),
                                group=self.group)
        t1 = time.perf_counter()
        if self.checkpointer is not None:
            # capture the state (device->host) and the cursors it was
            # trained through, and go back to training: serialize and
            # fsync happen on the writer, and the group commit trails
            # durability (_commit_checkpointed)
            self._snapshot()
            artifact = f"registry:r{self.rounds}"
            if self.store is not None:  # the pointer flow rides along
                artifact = self.publish()
            t2 = t3 = time.perf_counter()
        else:
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
        """Upload round K's model as an immutable blob (Keras h5 for an
        ``.h5`` name, else the port's checkpoint), then flip the pointer
        to it; returns the blob's name."""
        name = f"{self.model_name}.r{self.rounds}"
        tmp = tempfile.mkdtemp(prefix="iotml_torch_live_")
        try:
            if self.model_name.endswith(".h5"):
                local = os.path.join(tmp, "model.h5")
                autoencoder_params_to_h5(self.trainer.state.params, local)
                self.store.upload(local, name)
            else:
                path = CheckpointManager(tmp).save(
                    self.trainer.state, cursors=self.consumer.positions())
                self.store.upload_tree(path, name)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.store.put_text(f"{self.model_name}.latest", name)
        return name

    def _snapshot(self, force: bool = False) -> None:
        """Enqueue the current state + cursors for the async writer.  The
        checkpointer's cadence may coalesce it away (tracked, so a clean
        exit can force-archive the newest state)."""
        if not self.checkpointer.would_accept(force):
            self.checkpointer.coalesced += 1
            self._last_coalesced = True
            return
        before = self.checkpointer.coalesced
        cursors = self.consumer.positions()
        # the log ends now: the writer's offsets lag without a broker call
        ends = {(t, p): self.broker.end_offset(t, p)
                for t, p, _off in cursors}
        self.checkpointer.snapshot(
            self.trainer.state, cursors,
            metrics={"loss": self.last_loss if self.last_loss is not None
                     else float("nan"),
                     "records": float(self.records_trained)},
            end_offsets=ends, force=force)
        self._last_coalesced = self.checkpointer.coalesced > before

    def _commit_checkpointed(self, manifest) -> None:
        """The writer's post-durability hook: commit the manifest's
        stamped offsets for this group, forward only."""
        commit_manifest_offsets(self.broker, self.group, manifest)

    def close(self, timeout_s: float = 30.0) -> None:
        """Flush pending checkpoints and stop an owned writer thread."""
        if self.checkpointer is not None:
            self.checkpointer.stop(flush=True, timeout_s=timeout_s)

    def run(self, stop: Optional[Callable[[], bool]] = None,
            max_rounds: Optional[int] = None,
            poll_interval_s: float = 0.05,
            on_round: Optional[Callable[[dict], None]] = None) -> int:
        """Train rounds until ``stop()`` or ``max_rounds``; returns the
        rounds run.  ``on_round`` gets each round's stats.  In registry
        mode the checkpointer's writer runs meanwhile, and at the end the
        newest state is archived (forced past the cadence) and the queue
        drained."""
        if self.checkpointer is not None:
            # live mode owns its writer thread: a no-op when a supervisor
            # runs the writer's unit_loop() instead
            self.checkpointer.start()
        start = self.rounds
        while (stop is None or not stop()) and \
                (max_rounds is None or self.rounds - start < max_rounds):
            chaos.point("trainer.poll")
            if self.available() < self.min_available:
                time.sleep(poll_interval_s)
                continue
            stats = self.train_round()
            if stats and on_round is not None:
                on_round(stats)
        if self.checkpointer is not None:
            if self.rounds > start and self._last_coalesced:
                self._snapshot(force=True)
            self.checkpointer.flush(timeout_s=30.0)
        return self.rounds - start
