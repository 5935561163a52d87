"""True online learning: per-window SGD folded into the consume loop
(``iotml.online.learner``'s twin).

The reference is explicit that it does micro-batch streaming ingestion,
*not* online learning (reference README.md:130-140): its train job
re-fits a 10k-record slice and redeploys.  ``OnlineLearner`` goes past
it — every polled window (default 100 records, one fixed-shape step)
updates the model in place, a ``DriftMonitor`` watches the step's own
loss signal for distribution drift, and a drift triggers an adaptation
(learning-rate boost, detector-window reset, or a replay-buffer re-fit)
whose result is published through the ``ModelRegistry`` so the scorer
fleet hot-swaps it live.

Discipline shared with ``ContinuousTrainer`` (train/live.py):

- ONE persistent committed-offsets cursor; offsets-as-checkpoint still
  holds: snapshots ride the ``AsyncCheckpointer`` with the exact cursors
  they were trained through, and the group commit trails manifest
  durability (``commit_manifest_offsets``), so a crashed learner resumes
  model + stream position as one consistent unit.
- Model updates reach scorers ONLY through the registry.

On the device:

- a single window is one autograd step of the injectable-rate Adam
  (``train.optim.InjectableAdam``: a boost edits the optimizer state);
- a catch-up group of K windows is ``make_scanned_window_steps``: one
  transfer of the stacked windows, K steps, and the K pre-update losses
  back in one sync (the detector needs one loss per window, so the
  fused kernel, which returns per-epoch means, cannot run it);
- a refit replays the buffer on the fused fit kernel
  (``ops.fused_train.fused_fit``, at the learner's current rate) in at
  most two launches — ``refit_epochs - 1`` passes over every window,
  then one pass over all but the last — and takes the very last window
  as one step, whose pre-update loss is the ``last_loss`` the publish
  stamps, as in the JAX package's step-by-step refit.  On the card a
  kernel that fails to build or launch raises; nothing falls back.

Instrumented at the JAX learner's sites: the chaos point
``online.update`` a window of the drain, ``iotml_online_updates_total``,
``iotml_records_trained_total``, ``iotml_train_step_seconds`` and
``iotml_step_seconds{loop=online}`` (``device_compute`` a step or group,
``host_pipeline`` a drain), the drift and adaptation counters by
detector and action, ``iotml_online_converged_total``, the
``iotml_online_learning_rate`` and ``iotml_online_drift_stat`` gauges,
and the ``train`` watermark at each group boundary; counts and seconds
stay plain attributes too.

With ``mesh=`` each window's step runs data-parallel
(``parallel.data_parallel.ShardedTrainer``: the window's rows split over
the data axis, padded to a multiple of it), window by window, and each
shard's device has its own ``DriftMonitor`` (``chip_monitors``) fed its
rows' mean pre-update loss: a drift that only one shard's rows carry
trips that shard's monitor while the fleet mean stays calm, and opens
one episode on the global monitor (one model, one registry).  A refit
replays the buffer through the sharded step, as the JAX package's does,
so the mesh path launches no fit kernel.  ``device_normalize=True``
ships raw columns and folds the normalization into the step.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..chaos import faults as chaos
from ..data.dataset import SensorBatches
from ..mlops.checkpoint import AsyncCheckpointer, restore_trainer
from ..models.autoencoder import CAR_AUTOENCODER
from ..obs import metrics as obs_metrics
from ..obs import watermark
from ..ops import fused_train
from ..stream.consumer import StreamConsumer
from ..train.live import commit_manifest_offsets
from ..train.loop import Trainer, TrainState, scanned_window_steps_cached
from ..train.optim import InjectableAdam, set_learning_rate
from ..utils.device import DeviceLike
from .detectors import ADAPTING, DriftMonitor


def _padded_shard_counts(mask: np.ndarray, n_shards: int) -> list:
    """Each shard's valid-row count under ``ShardedTrainer.put_batch``'s
    padding: rows pad up to a multiple of the data axis, shards are
    contiguous row blocks, padding rows carry mask 0."""
    b = len(mask)
    r = b if b % n_shards == 0 else b + (n_shards - b % n_shards)
    m = np.zeros((r,), np.float32)
    m[:b] = mask
    return [int(c) for c in m.reshape(n_shards, -1).sum(axis=1)]


@dataclasses.dataclass
class AdaptationPolicy:
    """Which adaptation a drift episode triggers.

    ``action``:
      boost — multiply the learning rate by ``lr_boost`` for the next
        ``boost_updates`` windows, then restore it.  Cheap; right for
        mild shifts the optimizer can chase.
      refit — replay the bounded recent-batch buffer for
        ``refit_epochs`` extra passes (a mini retrain biased to the
        post-drift distribution), THEN boost.  Right for severe
        shifts where per-window steps alone converge too slowly.
      reset — detector-window reset only (the monitor always resets
        its windows on drift; this action adds nothing else — the
        "trust the optimizer" null adaptation).
      auto — pick by measured severity: ``refit`` when the smoothed
        error rose past ``severe_ratio`` × baseline, else ``boost``.
    """

    action: str = "auto"
    lr_boost: float = 5.0
    boost_updates: int = 80
    refit_epochs: int = 2
    severe_ratio: float = 4.0

    def choose(self, severity: float, buffer_len: int) -> str:
        if self.action != "auto":
            return self.action
        if severity >= self.severe_ratio and buffer_len:
            return "refit"
        return "boost"


class OnlineLearner:
    """Per-window incremental trainer with drift-triggered adaptation,
    publishing through the model registry.

    Args:
      broker/topic/group: the stream leg, ContinuousTrainer-shaped.
      registry | checkpointer: where adapted models publish.  Pass a
        registry and an ``AsyncCheckpointer`` is built; pass a
        checkpointer to control its policy — but a checkpointer is
        PER-TRAINER: its one commit hook encodes this group's cursor
        discipline, so trainers share a ModelRegistry, never a writer
        (enforced).  ``None`` both runs detect-only.
      window: records per incremental update (one fixed [window, F]
        step).
      monitor/policy: drift detection + adaptation knobs.
      publish_every: windows between steady-state publishes (drift
        adaptations publish at the next group boundary, and again on
        convergence).
      fuse: catch-up fusion cap: a backlog is trained in groups of up to
        this many windows (power-of-two sizes); 1 trains window by
        window.
      device: where the model trains (``cuda`` unless given; a mesh
        names its own devices).
      mesh/device_normalize/chip_monitors: the data-parallel learner, a
        monitor a data-axis device (fresh ``DriftMonitor``s unless
        given), and the device-side normalization, which needs a mesh.
    """

    def __init__(self, broker, topic: str, registry=None,
                 checkpointer=None, model=None,
                 group: str = "cardata-online", window: int = 100,
                 learning_rate: float = 1e-3,
                 monitor: Optional[DriftMonitor] = None,
                 policy: Optional[AdaptationPolicy] = None,
                 normalizer=None, only_normal: bool = True,
                 publish_every: int = 20, buffer_batches: int = 32,
                 warm_start: bool = True, keep_versions: int = 0,
                 fuse: int = 8, mesh=None, device_normalize: bool = False,
                 chip_monitors: Optional[list] = None,
                 device: DeviceLike = None):
        if mesh is not None and device is not None:
            raise ValueError("a mesh names its devices: pass mesh or "
                             "device, not both")
        self.broker = broker
        self.topic = topic
        self.group = group
        self.model = model if model is not None else CAR_AUTOENCODER
        self.window = int(window)
        self.fuse = max(1, int(fuse))
        self.base_lr = float(learning_rate)
        self.monitor = monitor or DriftMonitor()
        self.policy = policy or AdaptationPolicy()
        self.publish_every = int(publish_every)
        # the rate is optimizer state: a boost is a state edit
        self._tx = InjectableAdam(learning_rate)
        self.mesh = mesh
        self._sharded = None
        self.chip_monitors: list = []
        self.last_chip_losses = None
        self._chip_signal: Optional[tuple] = None
        if mesh is not None:
            from ..core.normalize import CAR_NORMALIZER
            from ..parallel.data_parallel import ShardedTrainer
            from ..parallel.streaming import data_axis_devices

            devices = data_axis_devices(mesh)
            device = devices[0]
            self._sharded = ShardedTrainer(
                self.model, mesh, tx=self._tx,
                normalizer=(normalizer or CAR_NORMALIZER)
                if device_normalize else None, row_loss=True)
            self.chip_monitors = list(chip_monitors) if chip_monitors \
                else [DriftMonitor() for _ in devices]
            if len(self.chip_monitors) != len(devices):
                raise ValueError(f"{len(self.chip_monitors)} chip "
                                 f"monitors for a {len(devices)}-device mesh")
        elif chip_monitors:
            raise ValueError("chip_monitors need a mesh")
        if device_normalize:
            if mesh is None:
                raise ValueError("device_normalize needs a mesh (the "
                                 "affine fold lives in the sharded step)")
            from ..core.normalize import RAW_COLUMNS

            normalizer = RAW_COLUMNS  # the batcher ships raw columns
        self.trainer = Trainer(self.model, learning_rate=learning_rate,
                               tx=self._tx, device=device)
        self.checkpointer = checkpointer
        self.registry = registry
        if registry is not None and checkpointer is None:
            self.checkpointer = AsyncCheckpointer(
                registry, keep_versions=keep_versions)
        if self.checkpointer is not None:
            self.registry = self.checkpointer.registry
            if self.checkpointer.commit_fn is not None:
                # the checkpointer has ONE commit hook, and it encodes
                # one trainer's (group, cursor) discipline — stealing it
                # would stall the other trainer's committed cursor AND
                # commit this group's offsets for records it never
                # trained
                raise ValueError(
                    "checkpointer is already wired to another "
                    "trainer's commit hook; each trainer owns its own "
                    "AsyncCheckpointer (they may share one "
                    "ModelRegistry)")
            self.checkpointer.commit_fn = lambda m: \
                commit_manifest_offsets(self.broker, self.group, m)
        broker.create_topic(topic)  # idempotent; a learner may boot
        # before the first producer provisions the stream
        parts = list(range(broker.topic(topic).partitions))
        self.consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                      group=group)
        # registry warm start — ContinuousTrainer's contract: resume the
        # lineage TIP's weights and apply its stamped cursors
        # forward-only (committed may trail the manifest, never lead it)
        self.restored_version: Optional[int] = None
        if self.registry is not None and warm_start:
            m = restore_trainer(self.trainer, self.registry)
            if m is not None:
                self.restored_version = m.version
                for t, p, off in m.offsets:
                    cur = broker.committed(group, t, p) or 0
                    if off > cur:
                        self.consumer.seek(t, p, off)
        batch_kw = {} if normalizer is None else dict(normalizer=normalizer)
        # take-budgeted drains: each emits at most `fuse` windows and the
        # batcher never polls past what it will emit, so
        # consumer.positions() at a drain boundary IS the trained frontier
        self.batches = SensorBatches(self.consumer, batch_size=self.window,
                                     only_normal=only_normal,
                                     take=self.fuse,
                                     poll_chunk=max(self.window, 4096),
                                     **batch_kw)
        #: bounded replay buffer of recent (x, mask, rows) windows on the
        #: device — what a "refit" re-fits on (drop-oldest: biased to the
        #: newest data)
        self.buffer: collections.deque = collections.deque(
            maxlen=max(1, int(buffer_batches)))
        self.updates = 0
        self.records_trained = 0
        self.last_loss: Optional[float] = None
        self.adaptations: list = []  # [(update_idx, signal, action)]
        self.published_versions: list = []
        self.refits = 0
        #: wall seconds: the drains' host pipeline (poll, decode, batch),
        #: the training calls (transfer, steps, the loss sync), the
        #: refits (stack, launches, the last step and its sync) and the
        #: publishes' snapshots
        self.seconds = {"host_pipeline": 0.0, "device_compute": 0.0,
                        "refit": 0.0, "publish": 0.0}
        self._boost_left = 0
        self._since_publish = 0
        # publish requests raised inside a group are applied at the
        # GROUP boundary: a mid-group snapshot would stamp the drain's
        # end offsets against a partially-trained state
        self._publish_pending = False
        self._publish_force = False
        obs_metrics.online_lr.set(self.base_lr)

    # -------------------------------------------------------------- lr
    @property
    def current_lr(self) -> float:
        st = self.trainer.state
        if st is None:
            return self.base_lr
        return float(st.opt_state.hyperparams["learning_rate"])

    def set_lr(self, lr: float) -> None:
        """Runtime LR change — an optimizer-state edit."""
        st = self.trainer.state
        if st is None:
            self.base_lr = float(lr)
            return
        self.trainer.state = dataclasses.replace(
            st, opt_state=set_learning_rate(st.opt_state, lr))
        if self._sharded is not None and self._sharded.state is not None:
            # the sharded step trains from its own copies
            self._sharded.state = self.trainer.state
        obs_metrics.online_lr.set(float(lr))

    # ----------------------------------------------------------- update
    def _update(self, b) -> float:
        """One incremental step on one window; returns the pre-update
        loss (the drift signal)."""
        if self._sharded is not None:
            return self._update_mesh(b)
        tr = self.trainer
        tr._ensure_state()
        t0 = time.perf_counter()
        x, mask = tr._to_device(b.x), tr._to_device(b.mask)
        tr.state, m = tr._step(tr.state, x, x, mask)
        # lint-ok: T2 the window's one sync: the pre-update loss is the
        # drift detector's host-side signal, read once a window
        loss = float(m["loss"])
        self._observe_step(time.perf_counter() - t0)
        self.updates += 1
        self.records_trained += b.n_valid
        self.last_loss = loss
        obs_metrics.online_updates.inc()
        obs_metrics.records_trained.inc(b.n_valid)
        self.buffer.append((x, mask, b.n_valid))
        return loss

    def _update_mesh(self, b) -> float:
        """The sharded window step: the global pre-update loss is the
        drift signal as ever, and each shard's mean pre-update loss also
        feeds its device's monitor; a monitor that fires stages one
        episode, which ``_after_update`` opens on the global monitor."""
        from ..parallel.streaming import shard_mean_losses

        tr = self.trainer
        if self._sharded.state is None:
            # the (possibly warm-started) state, laid out once
            tr._ensure_state()
            self._sharded.init(from_state=tr.state)
        t0 = time.perf_counter()
        m = self._sharded.step(b.x, b.x, b.mask)
        # lint-ok: T2 the window's one sync: the pre-update loss is the
        # drift detector's host-side signal, read once a window
        loss = float(m["loss"])
        self._observe_step(time.perf_counter() - t0)
        # the publish, the refit and current_lr read the trainer's state
        tr.state = self._sharded.state
        counts = _padded_shard_counts(b.mask, len(self.chip_monitors))
        chip = shard_mean_losses(m["row_loss"], counts)
        self.last_chip_losses = chip
        for i, (mon, cl, cnt) in enumerate(
                zip(self.chip_monitors, chip, counts)):
            if cnt <= 0:
                continue  # an all-padding shard: no signal to judge
            sig = mon.update(float(cl))
            if sig is not None:
                self._chip_signal = (i, sig)
        self.updates += 1
        self.records_trained += b.n_valid
        self.last_loss = loss
        obs_metrics.online_updates.inc()
        obs_metrics.records_trained.inc(b.n_valid)
        self.buffer.append((b.x, b.mask, b.n_valid))
        return loss

    def _update_group(self, bs) -> list:
        """K windows in one call (catch-up fusion): K sequential
        updates, the per-window losses back in one sync for the
        detector."""
        tr = self.trainer
        tr._ensure_state()
        t0 = time.perf_counter()
        xs = tr._to_device(np.stack([b.x for b in bs]))
        masks = tr._to_device(np.stack([b.mask for b in bs]))
        scan = scanned_window_steps_cached(tr.model, self._tx)
        tr.state, losses = scan(tr.state, xs, masks)
        # lint-ok: T2 the group's one sync: the K pre-update losses come
        # back together for the detector
        losses = losses.tolist()
        self._observe_step(time.perf_counter() - t0)
        n_valid = sum(b.n_valid for b in bs)
        self.updates += len(bs)
        self.records_trained += n_valid
        self.last_loss = losses[-1]
        obs_metrics.online_updates.inc(len(bs))
        obs_metrics.records_trained.inc(n_valid)
        for x, mask, b in zip(xs, masks, bs):
            self.buffer.append((x, mask, b.n_valid))
        return losses

    def _observe_step(self, seconds: float) -> None:
        """A step's or a group's transfer + step + loss read-back."""
        self.seconds["device_compute"] += seconds
        obs_metrics.train_step_seconds.observe(seconds)
        obs_metrics.step_seconds.observe(seconds, loop="online",
                                         phase="device_compute")

    def _take_group(self, limit: int) -> list:
        """One budgeted drain: at most ``limit`` windows, polled under
        the batcher's take cap so the consumer cursor never runs ahead
        of what this group will train (the offsets-as-checkpoint edge).
        The iterator is run to completion — every drain leaves
        positions() == the trained frontier (modulo label-filtered
        rows, consumed by design as in ContinuousTrainer)."""
        self.batches.take = max(1, limit)
        t0 = time.perf_counter()
        group = []
        for b in iter(self.batches):
            chaos.point("online.update")
            if b.n_valid:
                group.append(b)
        seconds = time.perf_counter() - t0
        self.seconds["host_pipeline"] += seconds
        obs_metrics.step_seconds.observe(seconds, loop="online",
                                         phase="host_pipeline")
        return group

    def _after_update(self, loss: float) -> None:
        """The per-window control body: feed the monitor, adapt on
        drift, publish on cadence / episode end."""
        was_adapting = self.monitor.state == ADAPTING
        conv_before = self.monitor.converged
        signal = self.monitor.update(loss)
        obs_metrics.online_drift_stat.set(self.monitor.ph.stat)
        chip_signal, self._chip_signal = self._chip_signal, None
        if signal is not None:
            self._adapt(signal)
        elif chip_signal is not None and not was_adapting \
                and self.monitor.state != ADAPTING:
            # a shard-local drift the fleet mean diluted: open ONE global
            # episode (one model) and adapt at that shard's severity
            i, sig = chip_signal
            tag = f"chip{i}-{sig}"
            self.monitor.begin_episode(tag)
            self._adapt(tag, severity=self.chip_monitors[i].severity())
        elif was_adapting and self.monitor.state != ADAPTING:
            # adaptation episode ended (converged or timed out): restore
            # the base LR and publish the adapted model — THIS is the
            # version the drift story promised the fleet
            if self.monitor.converged > conv_before:
                obs_metrics.online_converged.inc()
            self._boost_left = 0
            self.set_lr(self.base_lr)
            self._request_publish(force=True)
        elif self._boost_left > 0:
            self._boost_left -= 1
            if self._boost_left == 0:
                self.set_lr(self.base_lr)
        self._since_publish += 1
        if self._since_publish >= self.publish_every:
            self._request_publish()

    def _request_publish(self, force: bool = False) -> None:
        """Queue a publish for the next GROUP boundary: snapshots stamp
        consumer positions, and mid-group those describe rows the state
        has not trained through yet."""
        self._publish_pending = True
        self._publish_force = self._publish_force or force

    def process_available(self, max_updates: Optional[int] = None) -> int:
        """Consume and train on everything currently in the stream;
        returns windows processed.  A deep backlog is chewed in groups
        (power-of-two sizes up to ``fuse``); at the stream head the
        group degenerates to single windows.  Adaptations land between
        calls (a drift detected inside a group boosts/refits before the
        NEXT group) and publishes land at group boundaries, where the
        consumer cursor and the trained state agree."""
        n = 0
        while True:
            want = self.fuse if max_updates is None \
                else min(self.fuse, max_updates - n)
            group = self._take_group(want)
            if not group:
                break
            while group:
                # largest power-of-two chunk, as the JAX package bounds
                # its compiled variants; a mesh steps window by window
                # (the shard losses are window-granular)
                k = 1 if self._sharded is not None \
                    else 1 << (len(group).bit_length() - 1)
                chunk, group = group[:k], group[k:]
                losses = [self._update(chunk[0])] if k == 1 \
                    else self._update_group(chunk)
                for loss in losses:
                    self._after_update(loss)
                n += k
            # group boundary: consumed == trained
            watermark.observe_taken("train",
                                    self.consumer.take_event_time(),
                                    group=self.group)
            if self._publish_pending:
                force, self._publish_pending = self._publish_force, False
                self._publish_force = False
                self._publish(force=force)
            if max_updates is not None and n >= max_updates:
                break
        return n

    # ------------------------------------------------------- adaptation
    def _adapt(self, signal: str, severity: Optional[float] = None) -> None:
        if severity is None:
            severity = self.monitor.severity()
        action = self.policy.choose(severity, len(self.buffer))
        self.adaptations.append((self.updates, signal, action))
        obs_metrics.online_drifts.inc(detector=signal)
        obs_metrics.online_adaptations.inc(action=action)
        # window reset is unconditional: pre-drift detector state is
        # meaningless across a regime change (monitor.update already
        # moved to ADAPTING; reset re-arms its post-episode windows)
        self.monitor.reset_windows()
        if action == "refit":
            self._refit()
        if action in ("boost", "refit"):
            self.set_lr(self.base_lr * self.policy.lr_boost)
            self._boost_left = self.policy.boost_updates
        # ship the first adapted state at the group boundary
        self._request_publish(force=True)

    def refit_launches(self, windows: int) -> int:
        """Fused-fit launches a refit over ``windows`` buffered windows
        makes: one for the first ``refit_epochs - 1`` passes, one for the
        last pass but its last window (each skipped when empty)."""
        epochs = self.policy.refit_epochs
        if epochs <= 0 or windows <= 0:
            return 0
        return int(epochs > 1) + int(windows > 1)

    def _refit(self) -> None:
        """Replay-buffer mini-retrain: ``refit_epochs`` passes over the
        recent windows (drop-oldest buffer ⇒ post-drift biased), at the
        current rate.  The passes but the last step run on the fused fit
        kernel; the last step runs alone so its pre-update loss becomes
        ``last_loss``."""
        epochs = self.policy.refit_epochs
        wins = list(self.buffer)
        if epochs <= 0 or not wins:
            return
        t0 = time.perf_counter()
        if self._sharded is not None:
            self._refit_mesh(epochs, wins)
            self.seconds["refit"] += time.perf_counter() - t0
            return
        tr = self.trainer
        xs = torch.stack([x for x, _m, _n in wins])
        masks = torch.stack([m for _x, m, _n in wins])
        st, opt = tr.state, tr.state.opt_state
        lr, l1 = self.current_lr, tr.model.activity_l1
        fit = TrainState(step=st.step, params=st.params, opt_state=opt.inner)
        if epochs > 1:
            fit, _, _ = fused_train.fused_fit(fit, xs, masks, epochs - 1,
                                              lr=lr, l1=l1)
        if len(wins) > 1:
            fit, _, _ = fused_train.fused_fit(fit, xs[:-1], masks[:-1], 1,
                                              lr=lr, l1=l1)
        tr.state = TrainState(
            step=fit.step, params=fit.params,
            opt_state=dataclasses.replace(
                opt, count=opt.count + fit.step - st.step,
                inner=fit.opt_state))
        tr.state, m = tr._step(tr.state, xs[-1], xs[-1], masks[-1])
        self.records_trained += epochs * sum(n for _x, _m, n in wins)
        self.last_loss = float(m["loss"])
        self.refits += 1
        self.seconds["refit"] += time.perf_counter() - t0

    def _refit_mesh(self, epochs: int, wins: list) -> None:
        """The refit on a mesh: the buffered windows replayed through the
        sharded step, ``epochs`` passes, as the JAX package's refit."""
        last = None
        for _ in range(epochs):
            for x, mask, n in wins:
                last = self._sharded.step(x, x, mask)
                self.records_trained += n
        self.trainer.state = self._sharded.state
        # lint-ok: T2 the refit's last pre-update loss, once a refit
        self.last_loss = float(last["loss"])
        self.refits += 1

    # ------------------------------------------------------- publishing
    def _publish(self, force: bool = False) -> None:
        self._since_publish = 0
        if self.checkpointer is None:
            return
        if not self.checkpointer.would_accept(force):
            self.checkpointer.coalesced += 1
            return
        t0 = time.perf_counter()
        cursors = self.consumer.positions()
        ends = {(t, p): self.broker.end_offset(t, p)
                for t, p, _off in cursors}
        self.checkpointer.snapshot(
            self.trainer.state, cursors,
            metrics={"loss": self.last_loss
                     if self.last_loss is not None else float("nan"),
                     "records": float(self.records_trained),
                     "drifts": float(self.monitor.drifts),
                     "online": 1.0},
            end_offsets=ends, force=force)
        self.seconds["publish"] += time.perf_counter() - t0

    def write_published(self) -> list:
        """Deterministically drain the checkpoint writer (tests/drills;
        live mode runs checkpointer.start() instead).  Returns the
        versions committed by this drain."""
        out = []
        if self.checkpointer is None:
            return out
        while True:
            v = self.checkpointer.write_once()
            if v is None:
                break
            out.append(v)
        self.published_versions.extend(out)
        return out

    # -------------------------------------------------------- lifecycle
    def run(self, stop: Optional[Callable[[], bool]] = None,
            max_seconds: Optional[float] = None,
            poll_interval_s: float = 0.05,
            on_update: Optional[Callable[[dict], None]] = None) -> int:
        """Consume-and-train until ``stop()``/``max_seconds``; returns
        windows processed.  Owns the checkpoint writer thread."""
        if self.checkpointer is not None:
            self.checkpointer.start()
        deadline = None if max_seconds is None else \
            time.monotonic() + max_seconds
        n = 0
        while (stop is None or not stop()) and \
                (deadline is None or time.monotonic() < deadline):
            got = self.process_available(max_updates=256)
            n += got
            if on_update is not None and got:
                on_update(self.describe())
            if not got:
                time.sleep(poll_interval_s)
        if self.checkpointer is not None:
            self._publish(force=True)  # newest state must not die
            self.checkpointer.flush(timeout_s=30.0)
        return n

    def close(self, timeout_s: float = 30.0) -> None:
        if self.checkpointer is not None:
            self.checkpointer.stop(flush=True, timeout_s=timeout_s)

    def describe(self) -> dict:
        out = {"updates": self.updates,
               "records_trained": self.records_trained,
               "loss": self.last_loss, "lr": self.current_lr,
               "adaptations": list(self.adaptations),
               "monitor": self.monitor.describe(),
               "published": list(self.published_versions)}
        if self.chip_monitors:
            out["chips"] = [m.describe() for m in self.chip_monitors]
        return out
