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
``encoder1/kernel``; kernels [in, out]), ``o_0..o_16`` the plain
``optax.adam`` state (``count``, then ``mu`` and ``nu`` in the same
order), ``step`` the train step.

Not ported: the ``ckpt.write`` chaos point (ROADMAP A3), the metrics
registry's timings and gauges (A13: the phases are kept as plain
``seconds``) and the supervised writer loop (A14: ``start()`` runs a
plain daemon thread).
"""

from __future__ import annotations

import collections
import io
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.autoencoder import LAYERS
from ..models.h5_export import autoencoder_params_to_h5
from ..models.h5_import import autoencoder_params_from_h5
from ..models.convert import (adam_from_optax, adam_to_optax,
                              params_from_jax, params_to_jax)
from ..train.loop import TrainState
from ..train.optim import AdamState
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


def state_to_npz_bytes(params, opt_state: AdamState, step: int) -> bytes:
    """(params state_dict, ``AdamState``, step) → one .npz blob in the JAX
    package's positional leaf order (``p_<i>`` / ``o_<i>`` / ``step``)."""
    p_leaves = _leaves(params_to_jax(params))
    count, mu, nu = adam_to_optax(opt_state)
    o_leaves = [count] + _leaves(mu) + _leaves(nu)
    arrays = {f"p_{i}": a for i, a in enumerate(p_leaves)}
    arrays.update({f"o_{i}": a for i, a in enumerate(o_leaves)})
    arrays["step"] = np.asarray(int(step))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def state_from_npz_bytes(data: bytes, template_state):
    """Rebuild a ``TrainState`` from ``state_to_npz_bytes`` output (the
    port's or the JAX package's) onto a template with the same model,
    shape-checked leaf by leaf; the tensors land on the template's
    device.  A blob of another optimizer layout (the 23-leaf injectable
    Adam) fails the shape check with ``ValueError``, as in JAX."""
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
    o_shapes = [()] + p_shapes * 2
    p_leaves = [arrays[f"p_{i}"] for i in range(len(p_shapes))]
    o_leaves = [arrays[f"o_{i}"] for i in range(len(o_shapes))]
    for got, want in zip(p_leaves + o_leaves, p_shapes + o_shapes):
        if tuple(got.shape) != tuple(want):
            raise ValueError(
                f"checkpoint leaf shape {tuple(got.shape)} does not "
                f"match template {tuple(want)} — wrong model "
                f"architecture for this checkpoint")
    n = len(p_shapes)
    opt = adam_from_optax(o_leaves[0], _unleaves(o_leaves[1:1 + n], p_tmpl),
                          _unleaves(o_leaves[1 + n:], p_tmpl))
    device = next(iter(template_state.params.values())).device
    return TrainState(
        step=int(arrays["step"]),
        params=_to(params_from_jax(_unleaves(p_leaves, p_tmpl)), device),
        opt_state=AdamState(count=opt.count, mu=_to(opt.mu, device),
                            nu=_to(opt.nu, device)))


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


def host_state(state) -> Tuple[Dict[str, torch.Tensor], AdamState]:
    """(params, ``AdamState``) of ``state`` as CPU tensors, in ONE
    device-to-host copy into a buffer of their own: views of it, never of
    a device buffer that a later fit overwrites."""
    names = list(state.params)
    opt = state.opt_state
    parts = [tree[k] for tree in (state.params, opt.mu, opt.nu)
             for k in names]
    flat = torch.cat([t.detach().reshape(-1) for t in parts]).to("cpu")
    views, off = [], 0
    for t in parts:
        views.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    n = len(names)
    params = dict(zip(names, views[:n]))
    return params, AdamState(count=int(opt.count),
                             mu=dict(zip(names, views[n:2 * n])),
                             nu=dict(zip(names, views[2 * n:])))


class _Snapshot:
    __slots__ = ("params", "opt_state", "step", "offsets", "metrics")

    def __init__(self, params, opt_state, step, offsets, metrics):
        self.params = params
        self.opt_state = opt_state
        self.step = step
        self.offsets = offsets
        self.metrics = metrics


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
        self._idle = threading.Event()
        self._idle.set()
        self.written = 0
        self.dropped = 0
        self.last_error: Optional[str] = None
        self.last_version: Optional[int] = None
        #: cumulative wall seconds per phase: the device-to-host snapshot
        #: (train thread), serialize (h5 + npz) and fsync (the registry
        #: publish), both on the writer
        self.seconds = {"snapshot": 0.0, "serialize": 0.0, "fsync": 0.0}

    # ------------------------------------------------- train-thread side
    def snapshot(self, state, cursors: Sequence[Tuple[str, int, int]],
                 metrics: Optional[Dict[str, float]] = None,
                 force: bool = False) -> None:
        """Capture (device→host) and enqueue; returns immediately.

        ``cursors`` are the consumer positions AT THIS INSTANT — they
        ride the snapshot into the manifest, so the committed version
        names exactly the data this state was trained through.
        ``force`` bypasses the cadence throttle (shutdown wants the
        newest state archived)."""
        if not self.would_accept(force):
            self.coalesced += 1
            return
        self._last_accept = time.monotonic()
        t0 = time.perf_counter()
        params, opt_state = host_state(state)
        snap = _Snapshot(params, opt_state if self.save_opt_state else None,
                         int(state.step), [tuple(c) for c in cursors],
                         dict(metrics or {}))
        self.seconds["snapshot"] += time.perf_counter() - t0
        with self._lock:
            while len(self._queue) >= self.queue_depth:
                self._queue.popleft()
                self.dropped += 1
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
            manifest = self.registry.publish(
                artifacts, offsets=snap.offsets, metrics=snap.metrics,
                step=snap.step)
            self.seconds["serialize"] += t1 - t0
            self.seconds["fsync"] += time.perf_counter() - t1
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
    def start(self) -> "AsyncCheckpointer":
        """Spawn the writer thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
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

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="iotml-ckpt-writer")
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
