"""Host→device prefetch: overlap the stream decode with the device step
(``iotml.data.prefetch``'s twin).

A background thread drains the batch iterator (poll, decode, normalize,
batch: the host leg) into a small queue; the consuming thread stages each
batch's x, y and mask together onto one explicit device as it dequeues
it.  On a CUDA device the worker also copies the arrays into pinned host
tensors, and the consumer issues ``non_blocking`` copies from them on a
side stream and makes its own stream wait on that one: the transfer
overlaps the work already queued on the card, and the host does not wait
for it.  A pageable source is refused, never copied in silence.  On the
CPU the arrays are wrapped as they are.

With ``sharding=`` (a row sharding over a mesh's ``data`` axis) the
whole batch, x, y and mask, is padded and cut into one row block a
shard, and each block lands on its shard's device: the worker pins the
blocks bound for a card, one side stream a card copies them, and each
card's consuming stream waits on its side stream before the step reads
a shard.  The batch comes out as ``parallel.mesh.ShardedTensor``s.

The mesh paths feed through the prefetcher (``parallel/data_parallel.py``
cuts batches with it, ``parallel/streaming.py`` decodes each feed on its
thread), as in the JAX package; the single-device ``fit_compiled`` stages
a slice in one transfer, so no single-card path feeds through it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..utils.device import DeviceLike, resolve_device


class DevicePrefetcher:
    """Iterate device-resident batches with background staging.

    Args:
      batches: host batch iterable (``Batch``es).
      to_device: maps a host batch to device tensors; defaults to x, y
        (None when the batch has none) and mask on ``device``, returning
        ((x, y, mask), batch) so callers keep the batch's metadata.
      depth: queue depth; 2 is double buffering.  None reads
        ``IOTML_PREFETCH_DEPTH`` (``data.pipeline``, default 2).
      device: where the batches go (``cuda`` unless given).
      loop: the ``step_seconds`` / ``prefetch_occupancy`` loop label
        (train | score | online).
      sharding: a ``parallel.mesh.NamedSharding`` cutting rows over a
        mesh's 'data' axis; the batch's arrays land shard by shard on
        the mesh's devices (``device`` is then not read).
    """

    _END = object()

    def __init__(self, batches: Iterable, to_device: Optional[Callable] = None,
                 depth: Optional[int] = None, device: DeviceLike = None,
                 loop: str = "train", sharding=None):
        if depth is None:
            from .pipeline import prefetch_depth

            depth = prefetch_depth()
        self.loop = loop
        if depth < 1:
            # queue.Queue(maxsize=0) is UNBOUNDED: depth 0 would stage the
            # whole stream with no backpressure instead of disabling it
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.sharding = sharding
        self._shard_devices = None
        if sharding is not None:
            if to_device is not None:
                raise ValueError("DevicePrefetcher: to_device or "
                                 "sharding, not both")
            from ..parallel.mesh import data_devices

            self._shard_devices = data_devices(sharding.mesh)
            self.device = self._shard_devices[0]
            #: one side stream a card the shards go to
            self._streams = {d: torch.cuda.Stream(d)
                             for d in set(self._shard_devices)
                             if d.type == "cuda"}
        else:
            self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.batches = batches
        #: a caller's to_device gets the host batch itself
        self._custom = to_device is not None
        self.to_device = to_device or (
            self._sharded_to_device if sharding is not None
            else self._default_to_device)
        self._stream = torch.cuda.Stream(self.device) \
            if self._cuda and sharding is None else None
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        self._consumed = False
        from ..supervise.registry import register_thread

        self._thread = register_thread(threading.Thread(
            target=self._work, daemon=True, name="iotml-prefetch"))
        self._thread.start()

    @staticmethod
    def _arrays(batch) -> tuple:
        y = getattr(batch, "y", None)
        mask = getattr(batch, "mask", None)
        return batch.x, y, mask

    def _host(self, batch):
        """Worker side: on CUDA, the batch's arrays in pinned tensors
        (cut into shard blocks under a sharding)."""
        if self._custom:
            return batch
        if self.sharding is not None:
            return batch, tuple(None if a is None else self._blocks(a)
                                for a in self._arrays(batch))
        if not self._cuda:
            return batch, None
        pinned = tuple(None if a is None else
                       torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                       for a in self._arrays(batch))
        return batch, pinned

    def _default_to_device(self, item):
        batch, pinned = item
        if not self._cuda:
            return tuple(None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)) for a in self._arrays(batch)), batch
        consumer = torch.cuda.current_stream(self.device)
        # the side stream must not copy before the consumer's earlier
        # work on reused memory is ordered
        self._stream.wait_stream(consumer)
        out = []
        with torch.cuda.stream(self._stream):
            for t in pinned:
                if t is None:
                    out.append(None)
                    continue
                if not t.is_pinned():
                    raise RuntimeError("DevicePrefetcher: a non_blocking "
                                       "copy from pageable memory")
                d = t.to(self.device, non_blocking=True)
                # allocated on the side stream, used on the consumer's
                d.record_stream(consumer)
                out.append(d)
        consumer.wait_stream(self._stream)
        return tuple(out), batch

    def _blocks(self, a: np.ndarray) -> list:
        """``a`` padded and cut into one row block a shard; a block
        bound for a card is pinned."""
        from ..parallel.mesh import split_rows

        out = []
        for blk, dev in zip(split_rows(a, len(self._shard_devices)),
                            self._shard_devices):
            t = torch.from_numpy(np.ascontiguousarray(blk))
            out.append(t.pin_memory() if dev.type == "cuda" else t)
        return out

    def _sharded_to_device(self, item):
        """Each block onto its shard's device: non_blocking copies on
        the card's side stream, and each card's consuming stream waits
        on that side stream before the step reads a shard."""
        from ..parallel.mesh import ShardedTensor

        batch, arrays = item
        for dev, side in self._streams.items():
            # no copy may start before the consumer's earlier work on
            # reused memory is ordered
            side.wait_stream(torch.cuda.current_stream(dev))
        out = []
        for blocks in arrays:
            if blocks is None:
                out.append(None)
                continue
            shards = []
            for blk, dev in zip(blocks, self._shard_devices):
                if dev.type != "cuda":
                    shards.append(blk)
                    continue
                if not blk.is_pinned():
                    raise RuntimeError("DevicePrefetcher: a non_blocking "
                                       "copy from pageable memory")
                consumer = torch.cuda.current_stream(dev)
                with torch.cuda.stream(self._streams[dev]):
                    d = blk.to(dev, non_blocking=True)
                    d.record_stream(consumer)
                shards.append(d)
            out.append(ShardedTensor(shards, self.sharding))
        for dev, side in self._streams.items():
            torch.cuda.current_stream(dev).wait_stream(side)
        return tuple(out), batch

    def _put(self, item) -> bool:
        """put that gives up when the consumer closed; never blocks forever."""
        while not self._closed:
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        try:
            for b in self.batches:
                if not self._put(self._host(b)):
                    return  # consumer closed mid-stream
        except BaseException as e:  # surfaced on the consumer side
            self._err = e
        finally:
            self._put(self._END)

    def close(self):
        """Release the worker (called when iteration stops, an early
        break included); safe to call twice."""
        self._closed = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        if self._consumed:
            raise RuntimeError(
                "DevicePrefetcher is single-use: the background thread already "
                "drained its source; build a new one per pass")
        self._consumed = True
        depth = self.q.maxsize or 1
        try:
            while True:
                # host_wait is the time the loop starves on the host
                # pipeline; occupancy is the queue's fill at each dequeue
                # (~0 with a large host_wait: input-bound; ~1: device-bound)
                t0 = time.perf_counter()
                item = self.q.get()
                obs_metrics.step_seconds.observe(
                    time.perf_counter() - t0, loop=self.loop,
                    phase="host_wait")
                obs_metrics.prefetch_occupancy.set(
                    min(self.q.qsize() / depth, 1.0), loop=self.loop)
                if item is self._END:
                    if self._err is not None:
                        raise self._err
                    return
                yield self.to_device(item)
        finally:
            self.close()
