"""Partition-parallel columnar feeds into a sharded train step
(``iotml.parallel.streaming``'s twin).

- ``MeshFeeds`` gives each data-axis shard its own host pipeline: a
  partition subset (the static ``assign_partitions`` split, or a group
  member's live assignment), one ``SensorBatches`` whose ``poll_into``
  fills that feed's private ``DecodeRing``, and a ``DevicePrefetcher``
  thread that decodes ahead of the step.  The feeds share one consumer
  group: committed offsets stay partition-keyed, so a checkpoint
  manifest stamping every feed's cursors is one resume unit.
- ``ShardedStreamTrainer`` pairs feed *d* with data-axis device *d*:
  each step copies feed *d*'s rows onto device *d* only and runs the
  sharded step (``parallel.data_parallel``), whose shard losses sum to
  the batch's loss.  A feed with no batch in a step (its partitions ran
  dry) contributes a zero shard with a zero mask.
- With ``device_normalize=True`` the feeds ship raw float32 columns
  (``core.normalize.RAW_COLUMNS``) and the affine map runs on each
  device inside the step.

The per-row pre-update loss stays on its shard's device in the step's
metrics; ``shard_mean_losses`` reads the per-device means the online
learner's per-device drift monitors take.  A round syncs the host once,
for its step losses.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..data.dataset import SensorBatches
from ..stream.consumer import StreamConsumer
from ..stream.group import GroupConsumer, GroupCoordinator
from ..train.loop import TrainState
from ..train.optim import Adam
from .data_parallel import ShardedTrainer, _host_tensor
from .distributed import assign_partitions
from .mesh import Mesh, ShardedTensor


def data_axis_devices(mesh: Mesh) -> list:
    """The mesh's devices in 'data'-axis order: feed *d* owns device
    *d*.  The streaming trainer is pure data parallelism, so a mesh
    whose first axis is not 'data', or with another axis larger than 1,
    is refused."""
    if mesh.axis_names[0] != "data":
        raise ValueError(f"streaming mesh must lead with the 'data' axis, "
                         f"got {mesh.axis_names}")
    for name in mesh.axis_names[1:]:
        if mesh.shape[name] != 1:
            raise ValueError(
                f"streaming trainer is pure data-parallel; axis "
                f"{name!r} has size {mesh.shape[name]} (use a "
                f"('data',) or ('data', 'model'=1) mesh)")
    return list(mesh.devices.reshape(mesh.shape["data"], -1)[:, 0])


class MeshFeeds:
    """Per-shard partition-parallel host pipelines over one group.

    Args:
      broker: Broker duck-type (in-process, wire client, ClusterClient).
      topic: the consumed stream.
      n_feeds: the local data-axis size: one feed (consumer, batcher,
        decode ring) a shard.
      group: the shared consumer group.
      coordinator: None = the static split (``assign_partitions``:
        offsets stay shard-stable across restarts); a
        ``GroupCoordinator``, or a zero-argument factory of one (a wire
        ``RemoteGroupCoordinator`` a member), makes each feed a group
        member instead, whose partitions move under rebalance.
      batch_size/take_batches/only_normal/poll_chunk: each feed's
        ``SensorBatches`` knobs; ``take_batches`` bounds each feed's
        round.
      normalizer: the host-side normalizer (not read under
        ``device_normalize``).
      device_normalize: ship raw float32 columns; the affine map runs on
        the devices (pass the normalizer to ``ShardedStreamTrainer``).
    """

    def __init__(self, broker, topic: str, n_feeds: int,
                 group: str = "cardata-mesh-train",
                 coordinator: Union[None, GroupCoordinator, Callable] = None,
                 batch_size: int = 100, take_batches: Optional[int] = None,
                 only_normal: bool = True, normalizer=None,
                 device_normalize: bool = False, poll_chunk: int = 8192):
        from ..core.normalize import RAW_COLUMNS

        if n_feeds < 1:
            raise ValueError(f"n_feeds must be >= 1, got {n_feeds}")
        self.broker = broker
        self.topic = topic
        self.group = group
        self.batch_size = batch_size
        self.device_normalize = device_normalize
        n_parts = broker.topic(topic).partitions
        self.consumers: List = []
        self.partitions: List[List[int]] = []
        for d in range(n_feeds):
            if coordinator is None:
                parts = assign_partitions(n_parts, n_feeds, d)
                consumer = StreamConsumer.from_committed(
                    broker, topic, parts, group=group)
            else:
                coord = coordinator() if callable(coordinator) \
                    else coordinator
                consumer = GroupConsumer(coord, [topic])
                parts = [p for _t, p in consumer.assignment]
            self.consumers.append(consumer)
            self.partitions.append(list(parts))
        if coordinator is not None:
            # members join one by one and each join rebalances: one
            # heartbeat round lets every member adopt the converged
            # assignment before any consumes
            for consumer in self.consumers:
                consumer._ensure_membership()
            self.partitions = [[p for _t, p in c.assignment]
                               for c in self.consumers]
        batch_kw = {}
        if device_normalize:
            batch_kw["normalizer"] = RAW_COLUMNS
        elif normalizer is not None:
            batch_kw["normalizer"] = normalizer
        self.batchers = [
            SensorBatches(c, batch_size=batch_size, take=take_batches,
                          only_normal=only_normal, poll_chunk=poll_chunk,
                          **batch_kw)
            for c in self.consumers]

    def __len__(self) -> int:
        return len(self.consumers)

    def set_take(self, take_batches: Optional[int]) -> None:
        """Bound every feed's next round (None = to the log end)."""
        for b in self.batchers:
            b.take = take_batches

    def rounds(self):
        """Yield each step's ``[Batch | None a feed]`` until every
        feed's bounded iteration ends.  Each feed decodes on its own
        staging thread (a ``DevicePrefetcher`` passing host batches
        through), so the feeds' host pipelines overlap each other and
        the device step; every device call stays on this thread."""
        from ..data.prefetch import DevicePrefetcher

        pfs = [DevicePrefetcher(iter(b), to_device=lambda batch: batch,
                                device="cpu", loop="train")
               for b in self.batchers]
        its = [iter(pf) for pf in pfs]
        try:
            while True:
                row = [next(it, None) for it in its]
                if all(b is None for b in row):
                    return
                yield row
        finally:
            for pf in pfs:
                pf.close()

    # ------------------------------------------ the consumer's surface
    def positions(self) -> List[tuple]:
        """Every feed's cursors in one sorted list: what a checkpoint
        manifest stamps, all shards' partitions as one unit."""
        out: List[tuple] = []
        for c in self.consumers:
            out.extend(tuple(p) for p in c.positions())
        return sorted(out)

    def available(self) -> int:
        return sum(self.broker.end_offset(t, p) - off
                   for t, p, off in self.positions())

    def commit(self) -> None:
        for c in self.consumers:
            c.commit()

    def seek(self, topic: str, partition: int, offset: int) -> None:
        """Move the cursor of the feed that owns ``partition`` now.  A
        group member has no absolute seek (the group's committed offset
        is its cursor) and refuses."""
        for c in self.consumers:
            owned = {p for _t, p in c.assignment} \
                if hasattr(c, "assignment") \
                else {p for _t, p, _ in c.positions()}
            if partition in owned:
                seek = getattr(c, "seek", None)
                if seek is None:
                    raise NotImplementedError(
                        "group-elastic feeds seek via committed offsets "
                        "(commit before rebuilding), not absolute seeks")
                seek(topic, partition, offset)
                return
        raise KeyError(f"partition {partition} not owned by any feed")

    def take_event_time(self) -> dict:
        """The feeds' event-time ranges merged (the watermark publish)."""
        merged: dict = {}
        for c in self.consumers:
            take = getattr(c, "take_event_time", None)
            if take is None:
                continue
            for key, (lo, hi) in take().items():
                if key in merged:
                    mlo, mhi = merged[key]
                    merged[key] = (min(mlo, lo), max(mhi, hi))
                else:
                    merged[key] = (lo, hi)
        return merged

    def take_traces(self) -> list:
        out: list = []
        for b in self.batchers:
            out.extend(b.take_traces())
        return out

    def assignments(self) -> List[List[tuple]]:
        """Each feed's (topic, partition) ownership now (a group member's
        moves under rebalance)."""
        out = []
        for c in self.consumers:
            if hasattr(c, "assignment"):
                out.append(sorted(c.assignment))
            else:
                out.append(sorted({(t, p) for t, p, _ in c.positions()}))
        return out

    def close(self) -> None:
        for c in self.consumers:
            close = getattr(c, "close", None)
            if close is not None:
                try:
                    close()
                except (ConnectionError, RuntimeError, OSError):
                    pass


class ShardedStreamTrainer:
    """The streaming face of ``ShardedTrainer``: per-shard feeds in,
    sharded optimizer steps out.

    It has ``train.loop.Trainer``'s warm-start surface (``state``,
    ``_ensure_state``, ``device``), so ``mlops.restore_trainer`` and the
    ``AsyncCheckpointer`` take it as any trainer: a restored state is
    held on the host side and laid out over the mesh at the next step,
    and ``state`` is the whole state on the first shard's device, which
    the checkpoint snapshot copies to the host in one piece.
    """

    def __init__(self, model, mesh: Mesh, feeds: MeshFeeds,
                 learning_rate: float = 1e-3, tx=None, seed: int = 0,
                 normalizer=None, supervised: bool = False):
        if normalizer is None and feeds.device_normalize:
            raise ValueError(
                "feeds ship raw columns (device_normalize=True) but no "
                "device-side normalizer was given — the step would train "
                "on unnormalized data")
        self.mesh = mesh
        self.feeds = feeds
        self.learning_rate = learning_rate
        self.tx = tx if tx is not None else Adam(learning_rate)
        self._devices = data_axis_devices(mesh)
        if len(self._devices) != len(feeds):
            raise ValueError(
                f"mesh data axis {len(self._devices)} != feeds "
                f"{len(feeds)} — one feed per data-axis device")
        self._st = ShardedTrainer(
            model, mesh, seed=seed, tx=self.tx, supervised=supervised,
            normalizer=normalizer if feeds.device_normalize else None,
            row_loss=True)
        self.model = self._st.model
        self._host_state: Optional[TrainState] = None
        self._fresh = True  # the mesh holds no state yet
        self._zero_shard: Optional[np.ndarray] = None
        self.last_shard_losses: Optional[np.ndarray] = None
        self.records_trained = 0

    @property
    def device(self) -> torch.device:
        return self._st.device

    # ------------------------------------------------ Trainer-shaped state
    @property
    def state(self) -> Optional[TrainState]:
        return self._host_state if self._fresh else self._st.state

    @state.setter
    def state(self, st: TrainState) -> None:
        # the restore path: hold the state; the mesh takes it at the
        # next step
        self._host_state = st
        self._fresh = True
        self._st.state = None

    def _ensure_state(self) -> None:
        if self.state is None:
            self._host_state = TrainState.create(self.model, self.tx)

    # ------------------------------------------------------------ input
    def _global_put(self, shards: List[np.ndarray]) -> ShardedTensor:
        """Feed *d*'s rows onto device *d* only: the mesh sees one
        row-sharded batch, and no rows cross devices."""
        return ShardedTensor([_host_tensor(s, d) for s, d in
                              zip(shards, self._devices)],
                             self._st.data_sharding)

    def _assemble(self, row: Sequence):
        """Per-feed batches → (x, mask, n_valid).  A feed with no batch
        this step contributes a zero shard with a zero mask: the masked
        loss ignores its rows (the activity penalty counts them, as the
        batch's row count does), and the shapes stay fixed."""
        template = next(b for b in row if b is not None)
        if self._zero_shard is None or \
                self._zero_shard.shape != template.x.shape:
            self._zero_shard = np.zeros_like(template.x)
        xs, masks, n_valid = [], [], 0
        zero_mask = np.zeros((template.x.shape[0],), np.float32)
        for b in row:
            if b is None:
                xs.append(self._zero_shard)
                masks.append(zero_mask)
            else:
                xs.append(np.ascontiguousarray(b.x, np.float32))
                masks.append(b.mask)
                n_valid += b.n_valid
        return self._global_put(xs), self._global_put(masks), n_valid

    # ---------------------------------------------------------- training
    def fit_round(self) -> dict:
        """One bounded pass over the feeds (their ``take`` budget): a
        step a batch row, the losses kept on the device until the round
        ends (one sync), the per-device row losses of the last step on
        ``last_shard_losses``.  The history has ``Trainer.fit_compiled``'s
        shape, so ``ContinuousTrainer.train_round`` reads it as it is."""
        from ..obs import metrics as obs_metrics

        t0 = time.perf_counter()
        losses: list = []
        records = 0
        dev_s = 0.0
        last_row_loss = None
        last_counts = None
        for row in self.feeds.rounds():
            xg, mg, n_valid = self._assemble(row)
            if self._fresh:
                self._ensure_state()
                self._st.init(from_state=self._host_state)
                self._host_state = None
                self._fresh = False
            t_step = time.perf_counter()
            m = self._st._step(xg, xg, mg)
            dev_s += time.perf_counter() - t_step
            losses.append(m["loss"])  # a device scalar: no sync a step
            last_row_loss = m["row_loss"]
            last_counts = [0 if b is None else b.n_valid for b in row]
            records += n_valid
        if not losses:
            return {"loss": [], "accuracy": [], "records": [],
                    "seconds": [], "host_pipeline_s":
                        time.perf_counter() - t0, "device_compute_s": 0.0}
        # device_compute spans through the sync: the steps queue
        # asynchronously, so the round's device leg is the dispatch time
        # plus the closing wait, observed as one sample
        t_sync = time.perf_counter()
        # lint-ok: T2 the round's one sync, for its step losses
        losses = torch.stack([v.to(self.device) for v in losses]).cpu()
        losses = losses.tolist()
        dev_s += time.perf_counter() - t_sync
        obs_metrics.step_seconds.observe(dev_s, loop="train",
                                         phase="device_compute")
        if last_row_loss is not None:
            self.last_shard_losses = shard_mean_losses(
                last_row_loss, last_counts)
        self.records_trained += records
        obs_metrics.records_trained.inc(records)
        seconds = time.perf_counter() - t0
        return {"loss": [float(np.mean(losses))],
                "accuracy": [float("nan")],
                "records": [records],
                "seconds": [seconds],
                "host_pipeline_s": seconds - dev_s,
                "device_compute_s": dev_s,
                "steps": len(losses), "step_loss": losses}

    def fit_compiled(self, _batches=None, epochs: int = 1) -> dict:
        """The Trainer's call, for ``ContinuousTrainer``: the feeds are
        the batch source.  Rounds are single-epoch (a committed cursor
        cannot re-read its slice without a seek)."""
        if epochs != 1:
            raise ValueError("mesh streaming rounds are single-epoch "
                             "(the cursor is the slice)")
        return self.fit_round()


def shard_mean_losses(row_loss: ShardedTensor,
                      valid_counts: Sequence[int]) -> np.ndarray:
    """Each shard's mean pre-update loss from the step's row-sharded
    ``row_loss`` ([B], padding rows 0): the shard's sum over its valid
    row count, in shard (= feed, device) order; one device→host copy."""
    if len(row_loss.shards) != len(valid_counts):
        raise ValueError(f"{len(row_loss.shards)} row-loss shards != "
                         f"{len(valid_counts)} feeds")
    home = row_loss.shards[0].device
    # lint-ok: T2 the per-device means reach the host once a step
    sums = torch.stack([s.sum().to(home) for s in row_loss.shards]).tolist()
    return np.asarray([v / max(c, 1) for v, c in zip(sums, valid_counts)])


# --------------------------------------------------------------- benching
def leg_record(leg: str, devices: int, records: int, seconds: float,
               loss_first: Optional[float], loss_last: Optional[float],
               **extra) -> dict:
    """One leg of a scaling curve, in the JAX package's shared schema
    (``leg``, ``devices``, ``records``, ``seconds``, ``records_per_sec``,
    ``loss_first``, ``loss_last``)."""
    rec = {"leg": leg, "devices": int(devices), "records": int(records),
           "seconds": round(float(seconds), 4),
           "records_per_sec": round(records / seconds, 1)
           if seconds > 0 else 0.0,
           "loss_first": None if loss_first is None
           else round(float(loss_first), 6),
           "loss_last": None if loss_last is None
           else round(float(loss_last), 6)}
    rec.update(extra)
    return rec


def bench_leg(n_devices: int, records: int = 40_000,
              warmup_records: int = 8_000, batch_size: int = 100,
              partitions: int = 8, store_dir: Optional[str] = None,
              devices: Optional[Sequence] = None) -> dict:
    """One point of a 1→N curve: a durable broker seeded with ``warmup +
    records`` rows, partition-parallel feeds over the first
    ``n_devices`` of ``devices`` (every visible CUDA device unless
    given; a device may repeat), device-side normalization on, one warm
    round, then a timed drain of the rest through the sharded step."""
    import shutil
    import tempfile

    from ..core.normalize import CAR_NORMALIZER
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..store.log import StorePolicy
    from ..stream.broker import Broker
    from .mesh import local_devices, make_mesh

    devices = list(devices) if devices is not None else local_devices()
    if n_devices > len(devices):
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    tmp = None
    if store_dir is None:
        tmp = store_dir = tempfile.mkdtemp(prefix="iotml_torch_multichip_")
    broker = None
    feeds = None
    try:
        broker = Broker(store_dir=store_dir,
                        store_policy=StorePolicy(fsync="never"))
        num_cars = 100
        gen = FleetGenerator(FleetScenario(num_cars=num_cars,
                                           failure_rate=0.01))
        total = warmup_records + records
        gen.publish(broker, "SENSOR_DATA_S_AVRO",
                    n_ticks=max(total // num_cars, 1),
                    partitions=partitions)
        mesh = make_mesh((n_devices,), ("data",),
                         devices=devices[:n_devices])
        feeds = MeshFeeds(broker, "SENSOR_DATA_S_AVRO", n_devices,
                          group=f"multichip-bench-{n_devices}",
                          batch_size=batch_size, only_normal=True,
                          device_normalize=True)
        trainer = ShardedStreamTrainer(CAR_AUTOENCODER, mesh, feeds,
                                       normalizer=CAR_NORMALIZER)
        # the warm round: a bounded take a feed
        warm_take = max(warmup_records // (n_devices * batch_size), 1)
        feeds.set_take(warm_take)
        warm = trainer.fit_round()
        # the timed leg: the rest of the stream through the mesh
        feeds.set_take(None)
        t0 = time.perf_counter()
        hist = trainer.fit_round()
        seconds = time.perf_counter() - t0
        trained = hist["records"][-1] if hist["records"] else 0
        step_losses = (warm.get("step_loss") or []) + \
            (hist.get("step_loss") or [])
        return leg_record(
            "streaming dp", n_devices, trained, seconds,
            step_losses[0] if step_losses else None,
            step_losses[-1] if step_losses else None,
            per_device_batch=batch_size, partitions=partitions,
            steps=hist.get("steps", 0), device_normalize=True)
    finally:
        # close on every exit: a failed round must not leak the
        # broker's threads or open segments into the caller
        if feeds is not None:
            feeds.close()
        if broker is not None:
            broker.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
