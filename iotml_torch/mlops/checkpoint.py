"""Async checkpointing — snapshot on the train thread, bytes off it
(``iotml.mlops.checkpoint``'s twin).

A save is split at the device boundary:

- ``snapshot()`` (train thread): the params and the Adam moments go to
  host memory in ONE device-to-host copy (a flat buffer of their own, so
  a later fit cannot overwrite what the snapshot holds), and join a
  BOUNDED queue with the stream cursors captured at the same instant.
  That copy is the one device sync a publish costs
  (``seconds["snapshot"]``).
- the **writer** (a background thread, or ``write_once()`` driven
  deterministically): serializes the snapshot (``seconds["serialize"]``:
  Keras h5 through ``utils.hdf5`` + ``state.npz``) and commits it to the
  ``ModelRegistry`` (``seconds["fsync"]``: the atomic-write + directory
  fsync publication), stamping the manifest with the captured offsets so
  model state and stream position land as one atomic unit.  It touches
  host arrays only, never a CUDA tensor, so it never waits behind the
  train thread's kernels.

The queue is **drop-oldest**: when the disk falls behind, pending
snapshots are evicted (``dropped``) and the newest wins — a slow disk
degrades checkpoint FREQUENCY, never training throughput.

``state.npz`` is the JAX package's positional layout, so each package
resumes the other's: ``p_0..p_7`` are the params in flax's sorted leaf
order (``decoder0/bias``, ``decoder0/kernel``, ``decoder1/bias``, …,
``encoder1/kernel``; kernels [in, out]), ``o_*`` the optimizer state
and ``step`` the train step.  The optimizer state has one of two
layouts, picked by the state's optimizer:

- the plain ``optax.adam`` (``AdamState``), 17 leaves: ``count``, then
  ``mu`` and ``nu`` in the params' order;
- the online learner's ``inject_hyperparams(optax.adam)``
  (``InjectableAdamState``), 23 leaves: ``count``, the float32
  ``b1``, ``b2``, ``eps``, ``eps_root`` and ``learning_rate``, the
  inner ``count``, then ``mu`` and ``nu``.

A blob of one layout does not restore onto a template of the other
(``ValueError``); ``restore_trainer`` then loads the weights alone.

The write passes the chaos point ``ckpt.write`` between serialize and
the registry publication (a crash there: host state gone, registry
untouched).  The phases feed ``iotml_checkpoint_seconds{phase}`` beside
the plain ``seconds``, evictions ``iotml_checkpoint_dropped_total``, and
``offsets_lag`` the gauge ``iotml_model_offsets_lag{component}``.

The writer runs either as its own registered daemon thread (``start()``)
or as a supervised loop unit (``unit_loop()``, which hands the writer to
a ``Supervisor``: a crash restarts it under backoff with the pending
snapshots still queued, and ``start()`` becomes a no-op).
"""

from __future__ import annotations

import collections
import io
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos import faults as chaos
from ..models.autoencoder import LAYERS
from ..models.h5_export import autoencoder_params_to_h5
from ..models.h5_import import autoencoder_params_from_h5
from ..obs import metrics as obs_metrics
from ..models.convert import (adam_from_optax, adam_to_optax,
                              inject_adam_from_optax, inject_adam_to_optax,
                              params_from_jax, params_to_jax)
from ..train.loop import TrainState
from ..train.optim import HYPERPARAMS, AdamState, InjectableAdamState
from .registry import ModelRegistry


# ------------------------------------------------------- state codecs
def _leaves(tree: dict) -> List[np.ndarray]:
    """A flax-layout param tree's leaves in JAX's flatten order (sorted
    keys at every level)."""
    return [tree[layer][leaf] for layer in sorted(tree)
            for leaf in sorted(tree[layer])]


def _unleaves(leaves: Sequence[np.ndarray], like: dict) -> dict:
    it = iter(leaves)
    return {layer: {leaf: next(it) for leaf in sorted(like[layer])}
            for layer in sorted(like)}


def state_to_npz_bytes(params, opt_state, step: int) -> bytes:
    """(params state_dict, ``AdamState`` or ``InjectableAdamState``,
    step) → one .npz blob in the JAX package's positional leaf order
    (``p_<i>`` / ``o_<i>`` / ``step``)."""
    p_leaves = _leaves(params_to_jax(params))
    if isinstance(opt_state, InjectableAdamState):
        count, hp, (inner_count, mu, nu) = inject_adam_to_optax(opt_state)
        head = [count] + [hp[k] for k in HYPERPARAMS] + [inner_count]
    else:
        count, mu, nu = adam_to_optax(opt_state)
        head = [count]
    o_leaves = head + _leaves(mu) + _leaves(nu)
    arrays = {f"p_{i}": a for i, a in enumerate(p_leaves)}
    arrays.update({f"o_{i}": a for i, a in enumerate(o_leaves)})
    arrays["step"] = np.asarray(int(step))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _read_leaves(arrays: dict, prefix: str, shapes) -> List[np.ndarray]:
    """``arrays[prefix<i>]`` for each wanted shape, checked in order: the
    first leaf whose shape differs (or that the blob lacks) raises."""
    out = []
    for i, want in enumerate(shapes):
        got = arrays.get(f"{prefix}{i}")
        if got is None or tuple(got.shape) != tuple(want):
            raise ValueError(
                f"checkpoint leaf shape "
                f"{None if got is None else tuple(got.shape)} of "
                f"{prefix}{i} does not match template {tuple(want)} — "
                f"wrong model architecture or optimizer for this "
                f"checkpoint")
        out.append(got)
    return out


def state_from_npz_bytes(data: bytes, template_state):
    """Rebuild a ``TrainState`` from ``state_to_npz_bytes`` output (the
    port's or the JAX package's) onto a template with the same model and
    optimizer, shape-checked leaf by leaf; the tensors land on the
    template's device.  A blob of the other optimizer layout (17 leaves
    onto an injectable template, or 23 onto a plain one) fails the
    check with ``ValueError``."""
    with np.load(io.BytesIO(data)) as z:
        arrays = {k: z[k] for k in z.files}
    # the template's flax-layout shapes (kernels [in, out]), read off the
    # state_dict without a copy
    p_tmpl = {layer: {"bias": tuple(template_state.params[f"{layer}.bias"]
                                    .shape),
                      "kernel": tuple(template_state.params[
                          f"{layer}.weight"].shape[::-1])}
              for layer in LAYERS}
    p_shapes = _leaves(p_tmpl)
    inject = isinstance(template_state.opt_state, InjectableAdamState)
    n_head = 2 + len(HYPERPARAMS) if inject else 1
    p_leaves = _read_leaves(arrays, "p_", p_shapes)
    o_leaves = _read_leaves(arrays, "o_", [()] * n_head + p_shapes * 2)
    n = len(p_shapes)
    mu = _unleaves(o_leaves[n_head:n_head + n], p_tmpl)
    nu = _unleaves(o_leaves[n_head + n:], p_tmpl)
    device = next(iter(template_state.params.values())).device
    if inject:
        opt = inject_adam_from_optax(
            o_leaves[0], dict(zip(HYPERPARAMS, o_leaves[1:n_head - 1])),
            (o_leaves[n_head - 1], mu, nu))
        opt.inner = _adam_to(opt.inner, device)
    else:
        opt = _adam_to(adam_from_optax(o_leaves[0], mu, nu), device)
    return TrainState(
        step=int(arrays["step"]),
        params=_to(params_from_jax(_unleaves(p_leaves, p_tmpl)), device),
        opt_state=opt)


def _adam_to(opt: AdamState, device) -> AdamState:
    return AdamState(count=opt.count, mu=_to(opt.mu, device),
                     nu=_to(opt.nu, device))


def _to(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in params.items()}


def params_to_h5_bytes(params) -> bytes:
    """Serving weights as the reference's h5 byte layout (what scorers
    hot-swap; see models/h5_export)."""
    buf = io.BytesIO()
    autoencoder_params_to_h5(params, buf)
    return buf.getvalue()


def params_from_h5_bytes(data: bytes) -> Dict[str, torch.Tensor]:
    return autoencoder_params_from_h5(data)


def host_state(state) -> Tuple[Dict[str, torch.Tensor], object]:
    """(params, optimizer state) of ``state`` as CPU tensors, in ONE
    device-to-host copy into a buffer of their own: views of it, never of
    a device buffer that a later fit overwrites.  An
    ``InjectableAdamState`` keeps its counts and (host) hyperparameters
    around the copied moments."""
    names = list(state.params)
    opt = state.opt_state
    adam = opt.inner if isinstance(opt, InjectableAdamState) else opt
    parts = [tree[k] for tree in (state.params, adam.mu, adam.nu)
             for k in names]
    flat = torch.cat([t.detach().reshape(-1) for t in parts]).to("cpu")
    views, off = [], 0
    for t in parts:
        views.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    n = len(names)
    params = dict(zip(names, views[:n]))
    moments = AdamState(count=int(adam.count),
                        mu=dict(zip(names, views[n:2 * n])),
                        nu=dict(zip(names, views[2 * n:])))
    if adam is opt:
        return params, moments
    return params, InjectableAdamState(
        count=int(opt.count),
        hyperparams={k: v.clone() for k, v in opt.hyperparams.items()},
        inner=moments)


class _Snapshot:
    __slots__ = ("params", "opt_state", "step", "offsets", "metrics",
                 "end_offsets")

    def __init__(self, params, opt_state, step, offsets, metrics,
                 end_offsets):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.offsets = offsets
        self.metrics = metrics
        self.end_offsets = end_offsets


class AsyncCheckpointer:
    """Bounded-queue async checkpoint pipeline into a ModelRegistry.

    Args:
      registry: the destination ``ModelRegistry`` (this object is its
        single writer).
      queue_depth: max pending snapshots; beyond it the OLDEST pending
        snapshot is dropped (counted), newest-wins.
      save_opt_state: also serialize optimizer moments (``state.npz``)
        so a resumed trainer continues the same Adam trajectory; off,
        checkpoints are weights+offsets only (smaller, scorer-grade).
      auto_promote: point ``serving`` at each committed version (the
        continuous-delivery default); an A/B-gated deployment turns it
        off and lets the gate own promotion.
      min_interval_s: the cadence: a snapshot sooner than this after the
        last ACCEPTED one is coalesced away (counted); 0 accepts all.
      keep_versions: after each commit, prune committed versions beyond
        the newest ``keep_versions`` (channel targets never); 0 keeps all.
    """

    def __init__(self, registry: ModelRegistry, queue_depth: int = 2,
                 save_opt_state: bool = True, auto_promote: bool = True,
                 min_interval_s: float = 0.0, keep_versions: int = 0):
        self.registry = registry
        self.queue_depth = max(1, int(queue_depth))
        self.save_opt_state = save_opt_state
        self.keep_versions = int(keep_versions)
        self.min_interval_s = float(min_interval_s)
        self.coalesced = 0
        self._last_accept = float("-inf")
        self.auto_promote = auto_promote
        #: post-durability hook (set by ContinuousTrainer): called with
        #: the committed Manifest AFTER publication, ON THE WRITER
        #: thread — this is where the group commit trails checkpoint
        #: durability, so committed offsets never outrun a restorable
        #: model state
        self.commit_fn: Optional[Callable] = None
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()
        #: serializes whole drains: a flush()/stop() on a caller thread
        #: may run while the writer thread is mid-write_once, and the
        #: registry is single-writer (listdir-based next_version,
        #: pid-named stage dir)
        self._drain_lock = threading.Lock()
        self._kick = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: a supervisor owns the writer loop (``unit_loop``)
        self._external = False
        self._idle = threading.Event()
        self._idle.set()
        self.written = 0
        self.dropped = 0
        self.last_error: Optional[str] = None
        self.last_version: Optional[int] = None
        #: records between the newest written version's cursors and the
        #: log end captured with its snapshot (``end_offsets``), summed
        #: over partitions; None until such a version is written
        self.offsets_lag: Optional[int] = None
        #: cumulative wall seconds per phase: the device-to-host snapshot
        #: (train thread), serialize (h5 + npz) and fsync (the registry
        #: publish), both on the writer
        self.seconds = {"snapshot": 0.0, "serialize": 0.0, "fsync": 0.0}

    # ------------------------------------------------- train-thread side
    def snapshot(self, state, cursors: Sequence[Tuple[str, int, int]],
                 metrics: Optional[Dict[str, float]] = None,
                 end_offsets: Optional[Dict[Tuple[str, int], int]] = None,
                 force: bool = False) -> None:
        """Capture (device→host) and enqueue; returns immediately.

        ``cursors`` are the consumer positions AT THIS INSTANT — they
        ride the snapshot into the manifest, so the committed version
        names exactly the data this state was trained through.
        ``end_offsets`` (optional ``(topic, part) → end``) lets the
        writer compute ``offsets_lag`` without touching the broker from
        the writer thread.  ``force`` bypasses the cadence throttle
        (shutdown wants the newest state archived)."""
        if not self.would_accept(force):
            self.coalesced += 1
            return
        self._last_accept = time.monotonic()
        t0 = time.perf_counter()
        params, opt_state = host_state(state)
        snap = _Snapshot(params, opt_state if self.save_opt_state else None,
                         int(state.step), [tuple(c) for c in cursors],
                         dict(metrics or {}), dict(end_offsets or {}))
        seconds = time.perf_counter() - t0
        self.seconds["snapshot"] += seconds
        obs_metrics.checkpoint_seconds.observe(seconds, phase="snapshot")
        with self._lock:
            while len(self._queue) >= self.queue_depth:
                self._queue.popleft()
                self.dropped += 1
                obs_metrics.checkpoint_dropped.inc()
            self._queue.append(snap)
            self._idle.clear()
        self._kick.set()

    def would_accept(self, force: bool = False) -> bool:
        """Cheap cadence pre-check: would ``snapshot()`` accept right
        now?  Callers use it to skip capturing the cursors for a
        snapshot the throttle would coalesce anyway."""
        return force or self.min_interval_s <= 0 or \
            time.monotonic() - self._last_accept >= self.min_interval_s

    # ------------------------------------------------------ writer side
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def write_once(self) -> Optional[int]:
        """Drain ONE pending snapshot into the registry; returns the
        committed version (None when idle).  The deterministic drive
        point: the writer thread and tests all come through here."""
        with self._drain_lock:
            return self._write_one()

    def _write_one(self) -> Optional[int]:
        with self._lock:
            if not self._queue:
                self._idle.set()
                return None
            snap = self._queue.popleft()
        try:
            t0 = time.perf_counter()
            artifacts = {"model.h5": params_to_h5_bytes(snap.params)}
            if snap.opt_state is not None:
                artifacts["state.npz"] = state_to_npz_bytes(
                    snap.params, snap.opt_state, snap.step)
            t1 = time.perf_counter()
            self.seconds["serialize"] += t1 - t0
            obs_metrics.checkpoint_seconds.observe(t1 - t0,
                                                   phase="serialize")
            # between serialize and the atomic publication: an injected
            # crash here is "killed mid-checkpoint", registry untouched
            chaos.point("ckpt.write")
            t1 = time.perf_counter()
            manifest = self.registry.publish(
                artifacts, offsets=snap.offsets, metrics=snap.metrics,
                step=snap.step)
            t2 = time.perf_counter()
            self.seconds["fsync"] += t2 - t1
            obs_metrics.checkpoint_seconds.observe(t2 - t1, phase="fsync")
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            raise
        self.written += 1
        self.last_version = manifest.version
        try:
            if self.auto_promote:
                self.registry.promote(manifest.version)
            if self.commit_fn is not None:
                self.commit_fn(manifest)
        except Exception as e:  # noqa: BLE001 - both edges self-heal:
            # the next publish re-promotes, the next checkpoint
            # re-commits forward
            self.last_error = f"{type(e).__name__}: {e}"
            raise
        if snap.end_offsets:
            self.offsets_lag = sum(
                max(0, snap.end_offsets.get((t, p), o) - o)
                for t, p, o in snap.offsets)
            obs_metrics.model_offsets_lag.set(
                self.offsets_lag, component=self.registry.component)
        if self.keep_versions > 0:
            self.registry.prune(self.keep_versions)
        with self._lock:
            if not self._queue:
                self._idle.set()
        return manifest.version

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Block until every enqueued snapshot is committed (the
        synchronous edge for shutdown/tests)."""
        if self._thread is None or not self._thread.is_alive():
            while self.write_once() is not None:
                pass
            return True
        return self._idle.wait(timeout_s)

    # -------------------------------------------------------- lifecycle
    def unit_loop(self) -> Callable:
        """The writer body as a ``SupervisedUnit`` loop: a heartbeat a
        round, and a crash (injected or real) surfaces to the supervisor,
        which restarts a fresh incarnation under backoff; pending
        snapshots survive in the queue.  From here on ``start()`` spawns
        nothing."""
        self._external = True

        def loop(unit):
            while not unit.should_stop():
                unit.heartbeat()
                if self.write_once() is None:
                    self._kick.wait(0.05)
                    self._kick.clear()

        return loop

    def start(self) -> "AsyncCheckpointer":
        """Spawn an unsupervised writer thread (idempotent; a no-op once
        a supervisor runs ``unit_loop()``)."""
        from ..supervise.registry import register_thread

        if self._external or (self._thread is not None
                              and self._thread.is_alive()):
            return self
        self._stop.clear()

        def run():
            while not self._stop.is_set():
                try:
                    wrote = self.write_once()
                except Exception:  # noqa: BLE001 - a failed write must
                    # not kill the writer; the snapshot is gone (newest
                    # wins anyway), the error is surfaced on last_error
                    wrote = None
                if wrote is None:
                    self._kick.wait(0.05)
                    self._kick.clear()

        self._thread = register_thread(threading.Thread(
            target=run, daemon=True, name="iotml-ckpt-writer"))
        self._thread.start()
        return self

    def stop(self, flush: bool = True, timeout_s: float = 30.0) -> None:
        if flush:
            self.flush(timeout_s)
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
            self._thread = None


# --------------------------------------------------------- restore side
def restore_trainer(trainer, registry: ModelRegistry,
                    version: Optional[int] = None):
    """Warm-start a ``train.loop.Trainer`` from a committed version.

    Returns the manifest (its ``offsets`` are the resume cursors), or
    None when the registry is empty.  Params always load; optimizer
    moments load when the version carries ``state.npz`` AND its layout
    matches, else the optimizer restarts fresh (documented degradation,
    not an error — weights + offsets are the atomic unit).

    The default version is the NEWEST committed one — the training
    lineage's tip — never the ``serving`` channel: serving is
    deployment state (a rollback points it at an OLD version while the
    group's committed offsets keep following the newest manifest), so
    resuming from it would pair old weights with new cursors and leave
    records trained into no model."""
    if version is None:
        version = registry.latest()
    if version is None:
        return None
    m = registry.manifest(version)
    params = params_from_h5_bytes(registry.load_bytes(version, "model.h5"))
    trainer._ensure_state()
    if "state.npz" in m.artifacts:
        try:
            trainer.state = state_from_npz_bytes(
                registry.load_bytes(version, "state.npz"), trainer.state)
            return m
        except (ValueError, KeyError):
            pass  # another optimizer layout: fall through to weights only
    tmpl = trainer.state.params
    if set(params) != set(tmpl) or any(
            params[k].shape != tmpl[k].shape for k in tmpl):
        raise ValueError(
            f"version {version} weights do not match the trainer's "
            f"model architecture")
    trainer.state = TrainState(
        step=int(m.step), params=_to(params, trainer.device),
        opt_state=trainer.state.opt_state)
    return m
