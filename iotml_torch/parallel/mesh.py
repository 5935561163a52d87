"""Device mesh (``iotml.parallel.mesh``'s twin), and the shard-map
runtime the model-parallel steps run on.

A ``Mesh`` is a numpy array of ``torch.device``s with one axis name per
dimension, ``('data', 'model')`` as a rule: the ``data`` axis carries
the Kafka-partition → device-shard assignment, the ``model`` axis is the
hook for wider models (``data_parallel.param_specs``).  ``.shape`` is
the ordered ``{axis: size}`` dict JAX's mesh has.

The devices are explicit.  ``make_mesh`` and ``auto_mesh`` take a
``devices=`` list; the default is every CUDA device this process sees,
so a mesh asked for on too few cards raises as JAX's does.  A device
may repeat: ``[cuda:0, cuda:0]`` is two logical shards on one card, and
the CPU tests pass eight ``torch.device("cpu")`` entries where the JAX
suite has eight virtual CPU devices.  Under ``torch.distributed`` a mesh
holds this process's devices only, and its first axis continues across
the processes: its global size is processes × local shards,
processes-major.

There is no SPMD compiler here, so a sharding is a plain spec object
(``NamedSharding(mesh, PartitionSpec(...))``) that says how an array is
cut, and ``ShardedTensor`` is an array held as its pieces, one tensor a
block on that block's device.  A spec entry names one axis, a tuple of
axes (one dimension cut over their product, major to minor, as
``P(('data', 'expert'))``), or None.

``shard_map(body, mesh, in_specs, out_specs)`` runs ``body`` once a
shard, as JAX's does, each on a thread of its own.  Only one shard runs
at a time: a shard runs until it calls a collective, then hands over to
the next; when the last has arrived the collective runs over every
group of the axis at once, and the shards go on again in order.  So the
order of every launch is fixed, and one process's shards need no lock.
Inside a body ``axis_index`` / ``axis_size`` and the three collectives
``ppermute``, ``all_to_all`` (JAX's ``split_axis`` / ``concat_axis`` /
``tiled=True``) and ``psum`` stand for ``jax.lax``'s; outside one they
raise NameError, as JAX's axis lookup does outside ``shard_map``.

Each collective is one ``torch.autograd.Function`` over the group's
shards in this process: shards of one process move by ``.to(device)``,
and across processes a ``ppermute`` rides ``batch_isend_irecv``, an
``all_to_all`` ``all_to_all_single`` and a ``psum`` ``all_reduce``.  The
backward of each is its transpose (the inverse permutation, the
all-to-all with the two axes swapped, a psum), so one ``backward``
through a sharded loss runs every shard's share.  Across processes each
collective's backward must run on every process, so every output of a
collective that crosses processes must reach each process's loss: the
ring's rotations, the next-step shift, the all-to-alls and the psums of
a loss do; the pipeline's schedule, whose last shift nothing reads, runs
within one process.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """``devices`` (an array, or nested lists, of ``torch.device``)
    laid out under ``axis_names``, one name a dimension."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")

    @property
    def process_axis(self) -> Optional[str]:
        """The axis that continues across processes: the first."""
        return self.axis_names[0] if self.axis_names else None

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names,
                                           self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {list(self.devices.flat)})"


def local_devices() -> List[torch.device]:
    """Every CUDA device this process sees, in index order."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (every visible CUDA device
    unless given); the device count must equal the mesh's size."""
    devices = list(devices) if devices is not None else local_devices()
    n = int(np.prod(shape)) if len(shape) else 1
    if n != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.empty(n, dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def auto_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'model') mesh over the first ``n_devices`` of
    ``devices`` (every visible CUDA device unless given)."""
    devices = list(devices) if devices is not None else local_devices()
    n = len(devices) if n_devices is None else n_devices
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), devices[:n])


def process_world() -> Tuple[int, int]:
    """(processes, this process's rank): (1, 0) without a process
    group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def axis_layout(mesh: Mesh, name: str) -> Tuple[int, int, int]:
    """(local shards, processes, rank) of axis ``name``: the axis's
    global size is their product, and this process's shards start at
    ``rank × local``."""
    local = mesh.shape[name]
    world, rank = process_world()
    if name == mesh.process_axis and world > 1:
        return local, world, rank
    return local, 1, 0


def global_axis_size(mesh: Mesh, name: str) -> int:
    local, procs, _ = axis_layout(mesh, name)
    return local * procs


class PartitionSpec(tuple):
    """Mesh axis, tuple of axes, or None per array dimension; trailing
    dimensions not named are whole.  ``PartitionSpec()`` is
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def spec_axes(entry) -> Tuple[str, ...]:
    """The axes one spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """How an array is cut over ``mesh``: ``spec`` names mesh axes (or
    None) for each leading dimension."""

    mesh: Mesh
    spec: PartitionSpec

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) \
            and other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Rows over 'data'; every other dimension whole."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_devices(mesh: Mesh, axis: str = "data") -> List[torch.device]:
    """The device that holds each ``axis`` shard, in axis order: the
    first device along every other axis (a row block is whole on it)."""
    i = mesh.axis_names.index(axis)
    arr = np.moveaxis(mesh.devices, i, 0).reshape(mesh.shape[axis], -1)
    return list(arr[:, 0])


def split_rows(a: np.ndarray, n: int) -> List[np.ndarray]:
    """``a`` zero-padded to a multiple of ``n`` rows and cut into ``n``
    contiguous row blocks (views where no padding was needed)."""
    b = a.shape[0]
    if b % n:
        a = np.concatenate([a, np.zeros((n - b % n,) + a.shape[1:],
                                        a.dtype)])
    return np.split(a, n)


def positions(mesh: Mesh) -> List[tuple]:
    """Every local mesh position (its coordinates), row-major: the
    order of ``mesh.devices.flat`` and of ``shard_map``'s shards."""
    return list(np.ndindex(*mesh.devices.shape))


def block_of(mesh: Mesh, spec: Sequence, coords: tuple) -> tuple:
    """The block of a ``spec``-cut array that the shard at ``coords``
    holds: one local block index a spec dimension (0 where whole); a
    dimension cut over several axes counts them major first."""
    out = []
    for entry in spec:
        b = 0
        for a in spec_axes(entry):
            i = mesh.axis_names.index(a)
            b = b * mesh.devices.shape[i] + coords[i]
        out.append(b)
    return tuple(out)


def is_replicated(spec: Sequence) -> bool:
    return not any(spec_axes(e) for e in spec)


def spec_blocks(mesh: Mesh, spec: Sequence) -> List[Tuple[tuple, tuple]]:
    """(block, coordinates of its first holder) for each block of a
    ``spec``-cut array, in block order: the holder sits at index 0 of
    every axis the spec leaves out."""
    seen = {}
    for c in positions(mesh):
        seen.setdefault(block_of(mesh, spec, c), c)
    return sorted(seen.items())


def _cut_counts(mesh: Mesh, spec: Sequence) -> List[int]:
    """Local blocks along each spec dimension."""
    return [int(np.prod([mesh.shape[a] for a in spec_axes(e)]))
            if spec_axes(e) else 1 for e in spec]


class ShardedTensor:
    """An array held as its pieces.  ``blocks[i]`` is the block
    ``shards[i]`` holds (one local block index a spec dimension, as
    ``block_of``); a replicated array holds one whole copy a device
    (block ``()``).  Without ``blocks`` the shards are the blocks of
    the one cut dimension in order, one each (rows for ``P('data')``); a
    block may have several pieces, one a device that holds it, when
    ``blocks`` says so."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 sharding: NamedSharding,
                 blocks: Optional[Sequence[tuple]] = None):
        self.shards = list(shards)
        self.sharding = sharding
        if blocks is None:
            blocks = self._default_blocks()
        self.blocks = [tuple(b) for b in blocks]
        if len(self.blocks) != len(self.shards):
            raise ValueError(f"{len(self.shards)} shards for "
                             f"{len(self.blocks)} blocks")

    def _default_blocks(self) -> List[tuple]:
        spec = self.sharding.spec
        n = len(self.shards)
        if is_replicated(spec):
            return [()] * n
        cut = [k for k, e in enumerate(spec) if spec_axes(e)]
        if len(cut) > 1:
            raise ValueError(f"a {spec!r} array names its pieces' blocks")
        return [tuple(i if k == cut[0] else 0 for k in range(len(spec)))
                for i in range(n)]

    def _firsts(self) -> List[Tuple[tuple, int]]:
        """(block, the index of its first piece), in block order."""
        seen = {}
        for i, b in enumerate(self.blocks):
            seen.setdefault(b, i)
        return sorted(seen.items())

    def _offsets(self) -> Tuple[tuple, List[dict]]:
        """The whole shape and, a dimension, each block index's offset."""
        spec = self.sharding.spec
        firsts = self._firsts()
        shape = list(self.shards[firsts[0][1]].shape)
        offsets: List[dict] = []
        for k in range(len(spec)):
            sizes = {}
            for b, i in firsts:
                sizes.setdefault(b[k], int(self.shards[i].shape[k]))
            at, off = 0, {}
            for idx in sorted(sizes):
                off[idx] = at
                at += sizes[idx]
            offsets.append(off)
            shape[k] = at
        return tuple(shape), offsets

    @property
    def shape(self) -> tuple:
        if is_replicated(self.sharding.spec):
            return tuple(self.shards[0].shape)
        return self._offsets()[0]

    def piece(self, block: tuple, device: torch.device) -> torch.Tensor:
        """``block``'s piece on ``device`` (moved there when no piece of
        it lives on that device)."""
        first = None
        for b, s in zip(self.blocks, self.shards):
            if b == tuple(block):
                if s.device == device:
                    return s
                first = s if first is None else first
        if first is None:
            raise KeyError(f"no block {block} in {self!r}")
        return first.to(device)

    def numpy(self) -> np.ndarray:
        """The whole array (this process's part of it) on the host: a
        device→host copy a block."""
        if is_replicated(self.sharding.spec):
            return self.shards[0].detach().cpu().numpy()
        shape, offsets = self._offsets()
        firsts = self._firsts()
        host = [(b, self.shards[i].detach().cpu().numpy())
                for b, i in firsts]
        out = np.empty(shape, host[0][1].dtype)
        for b, h in host:
            idx = tuple(slice(offsets[k][b[k]], offsets[k][b[k]]
                              + h.shape[k]) for k in range(len(b)))
            out[idx] = h
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, "
                f"spec={self.sharding.spec!r}, "
                f"devices={[s.device for s in self.shards]})")


def cut(x: torch.Tensor, mesh: Mesh, spec: Sequence, coords: tuple
        ) -> torch.Tensor:
    """The block of ``x`` (this process's part of the array) that the
    shard at ``coords`` holds, as a view: autograd runs through it."""
    for k, (n, b) in enumerate(zip(_cut_counts(mesh, spec),
                                   block_of(mesh, spec, coords))):
        if n > 1:
            if x.shape[k] % n:
                raise ValueError(f"dimension {k} of {tuple(x.shape)} does "
                                 f"not split into {n} blocks")
            step = x.shape[k] // n
            x = x.narrow(k, b * step, step)
    return x


# ---------------------------------------------------------------------
# collectives over one group of an axis
# ---------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The shards of one mesh-axis group in this process: their
    devices in axis order, the group's size across processes, and the
    processes it spans (this process's members start at ``rank ×
    len(devices)``)."""

    devices: Tuple[torch.device, ...]
    size: int
    processes: int = 1
    rank: int = 0

    @property
    def offset(self) -> int:
        return self.rank * len(self.devices)

    def owner(self, member: int) -> int:
        """The rank holding global member ``member``."""
        return member // len(self.devices)


def _p2p(group: AxisGroup, sends, recvs) -> None:
    """``sends``: (global member to, tensor); ``recvs``: (global member
    from, global member to, buffer).  One ``batch_isend_irecv``, each
    message tagged by its receiving member; sends in order of receiver,
    so peers post their halves alike."""
    dist = torch.distributed
    ops = [dist.P2POp(dist.isend, t.contiguous(), group.owner(to), tag=to)
           for to, t in sorted(sends, key=lambda s: s[0])]
    ops += [dist.P2POp(dist.irecv, buf, group.owner(frm), tag=to)
            for frm, to, buf in sorted(recvs, key=lambda r: r[1])]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _ppermute_raw(group: AxisGroup, perm, xs) -> List[torch.Tensor]:
    off, n_local = group.offset, len(xs)
    src_of = {int(d): int(s) for s, d in perm}
    dst_of = {int(s): int(d) for s, d in perm}
    local = range(off, off + n_local)
    out: List[Optional[torch.Tensor]] = [None] * n_local
    sends, recvs = [], []
    for j, dev in enumerate(group.devices):
        src = src_of.get(off + j)
        if src is None:  # JAX: a shard nothing is sent to gets zeros
            out[j] = torch.zeros_like(xs[j])
        elif src in local:
            out[j] = xs[src - off].to(dev, copy=True)
        else:
            out[j] = torch.empty(xs[j].shape, dtype=xs[j].dtype, device=dev)
            recvs.append((src, off + j, out[j]))
    for i in range(n_local):
        dst = dst_of.get(off + i)
        if dst is not None and dst not in local:
            sends.append((dst, xs[i]))
    _p2p(group, sends, recvs)
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, perm, *xs):
        ctx.group, ctx.perm = group, perm
        return tuple(_ppermute_raw(group, perm, xs))

    @staticmethod
    def backward(ctx, *cts):
        # the transpose of a permutation is its inverse
        inverse = [(d, s) for s, d in ctx.perm]
        return (None, None) + tuple(_ppermute_raw(ctx.group, inverse, cts))


def _all_to_all_raw(group: AxisGroup, xs, split_axis: int,
                    concat_axis: int) -> List[torch.Tensor]:
    n, n_local = group.size, len(xs)
    chunks = [x.chunk(n, dim=split_axis) for x in xs]
    if any(len(c) != n for c in chunks) or xs[0].shape[split_axis] % n:
        raise ValueError(f"dimension {split_axis} of {tuple(xs[0].shape)} "
                         f"does not split over {n} shards")
    if group.processes == 1:
        return [torch.cat([chunks[i][j].to(dev) for i in range(n_local)],
                          dim=concat_axis)
                for j, dev in enumerate(group.devices)]
    # one all_to_all_single: to rank q go, for each local source i, its
    # chunks for q's members in order; from rank q come, for each of its
    # members, the chunks for this process's members in order
    home = group.devices[0]
    piece = chunks[0][0]
    send = torch.cat([chunks[i][q * n_local + j].to(home).reshape(-1)
                      for q in range(group.processes)
                      for i in range(n_local) for j in range(n_local)])
    recv = torch.empty_like(send)
    torch.distributed.all_to_all_single(recv, send)
    got = recv.view(group.processes, n_local, n_local, -1)
    return [torch.cat([got[q, i, j].view(piece.shape).to(dev)
                       for q in range(group.processes)
                       for i in range(n_local)], dim=concat_axis)
            for j, dev in enumerate(group.devices)]


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, split_axis, concat_axis, *xs):
        ctx.args = (group, split_axis, concat_axis)
        return tuple(_all_to_all_raw(group, xs, split_axis, concat_axis))

    @staticmethod
    def backward(ctx, *cts):
        group, split_axis, concat_axis = ctx.args
        # the transpose swaps the axis that was split and the one joined
        return (None, None, None) + tuple(
            _all_to_all_raw(group, cts, concat_axis, split_axis))


def _psum_raw(group: AxisGroup, xs) -> List[torch.Tensor]:
    home = group.devices[0]
    total = xs[0].to(home, copy=True)
    for x in xs[1:]:  # in axis order: the sum's order is fixed
        total = total + x.to(home)
    if group.processes > 1:
        torch.distributed.all_reduce(total)
    return [total.to(dev, copy=True) for dev in group.devices]


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(_psum_raw(group, xs))

    @staticmethod
    def backward(ctx, *cts):
        return (None,) + tuple(_psum_raw(ctx.group, cts))


# ---------------------------------------------------------------------
# the shard-map runtime
# ---------------------------------------------------------------------

_local = threading.local()


class _Abort(Exception):
    """Another shard failed: unwind this one."""


@dataclasses.dataclass(frozen=True)
class _Shard:
    runner: "_Spmd"
    index: int
    coords: tuple
    device: torch.device


def _current(axis_name) -> _Shard:
    shard = getattr(_local, "shard", None)
    if shard is None:
        raise NameError(f"unbound axis name: {axis_name}")
    return shard


class _Spmd:
    """One ``shard_map`` call: a thread a shard, one running at a time
    (the turn), a rendezvous at each collective."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords = positions(mesh)
        self.n = len(self.coords)
        self.cv = threading.Condition()
        self.turn = 0
        self.pending: list = [None] * self.n
        self.results: list = [None] * self.n
        self.finished = [False] * self.n
        self.error: Optional[BaseException] = None

    def _fail(self, exc: BaseException) -> None:
        with self.cv:
            if self.error is None:
                self.error = exc
            self.cv.notify_all()

    def _wait_turn(self, i: int) -> None:
        while self.turn != i and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise _Abort()

    def _pass_turn(self, i: int) -> None:
        self.turn = i + 1
        self.cv.notify_all()

    def collective(self, i: int, key: tuple, x: torch.Tensor):
        """Shard ``i``'s part in the collective ``key``; its result."""
        with self.cv:
            self.pending[i] = (key, x)
            if i < self.n - 1:
                self._pass_turn(i)
            else:  # the last to arrive runs it (a failure ends the run)
                self._run_collective()
            self._wait_turn(i)
            return self.results[i]

    def _run_collective(self) -> None:
        keys = {p[0] for p in self.pending if p is not None}
        if len(keys) != 1 or any(self.finished) \
                or any(p is None for p in self.pending):
            raise RuntimeError(f"shards diverged: collectives {keys}, "
                               f"{sum(self.finished)} shards finished")
        (key,) = keys
        xs = [p[1] for p in self.pending]
        self.results = _execute(self.mesh, self.coords, key, xs)
        self.pending = [None] * self.n
        self.turn = 0
        self.cv.notify_all()

    def finish(self, i: int) -> None:
        with self.cv:
            self.finished[i] = True
            if any(p is not None for p in self.pending):
                raise RuntimeError("shards diverged: a shard finished while "
                                   "another waits in a collective")
            self._pass_turn(i)

    def run(self, fn: Callable[[int], object]) -> list:
        from ..supervise.registry import register_thread

        outs: list = [None] * self.n
        grad = torch.is_grad_enabled()

        def main(i: int) -> None:
            prev = getattr(_local, "shard", None)
            dev = self.mesh.devices[self.coords[i]]
            _local.shard = _Shard(self, i, self.coords[i], dev)
            try:
                if dev.type == "cuda" and dev.index is not None \
                        and self.n > 1:
                    # a native launch goes to the thread's current device
                    torch.cuda.set_device(dev)
                with self.cv:
                    self._wait_turn(i)
                with torch.set_grad_enabled(grad):
                    outs[i] = fn(i)
                self.finish(i)
            except _Abort:
                pass
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                self._fail(exc)
            finally:
                _local.shard = prev

        if self.n == 1:
            main(0)
        else:
            threads = [register_thread(threading.Thread(
                target=main, args=(i,), name=f"iotml-shard-{i}",
                daemon=True)) for i in range(self.n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if self.error is not None:
            raise self.error
        return outs


def _groups(mesh: Mesh, coords: List[tuple], axes: Tuple[str, ...]
            ) -> List[List[int]]:
    """Shard indices grouped along ``axes``: shards that agree on every
    other axis, each group in order along ``axes`` (major first)."""
    idx = [mesh.axis_names.index(a) for a in axes]
    rest = [k for k in range(len(mesh.axis_names)) if k not in idx]
    by: dict = {}
    for i, c in enumerate(coords):
        by.setdefault(tuple(c[k] for k in rest), []).append(i)
    return [sorted(members, key=lambda i: tuple(coords[i][k] for k in idx))
            for _, members in sorted(by.items())]


def _axis_group(mesh: Mesh, axes: Tuple[str, ...], devices) -> AxisGroup:
    size, procs, rank = 1, 1, 0
    for a in axes:
        local, p, r = axis_layout(mesh, a)
        size *= local * p
        if p > 1:
            procs, rank = p, r
    return AxisGroup(tuple(devices), size, procs, rank)


def _execute(mesh: Mesh, coords: List[tuple], key: tuple, xs) -> list:
    kind, axes, args = key
    out: list = [None] * len(xs)
    for members in _groups(mesh, coords, axes):
        group = _axis_group(mesh, axes,
                            [mesh.devices[coords[i]] for i in members])
        ins = [xs[i] for i in members]
        if kind == "ppermute":
            res = _PPermute.apply(group, args, *ins)
        elif kind == "all_to_all":
            res = _AllToAll.apply(group, *args, *ins)
        else:
            res = _PSum.apply(group, *ins)
        for i, r in zip(members, res):
            out[i] = r
    return out


def axis_index(axis_name: str) -> int:
    """This shard's global index along ``axis_name``."""
    shard = _current(axis_name)
    mesh = shard.runner.mesh
    local, _, rank = axis_layout(mesh, axis_name)
    return rank * local + shard.coords[mesh.axis_names.index(axis_name)]


def axis_size(axis_name) -> int:
    """The global size of ``axis_name`` (a tuple: their product)."""
    shard = _current(axis_name)
    return int(np.prod([global_axis_size(shard.runner.mesh, a)
                        for a in spec_axes(axis_name)]))


def shard_device() -> torch.device:
    """The device this shard runs on."""
    return _current("(device)").device


def _collective(kind: str, x: torch.Tensor, axis_name, args):
    shard = _current(axis_name)
    axes = spec_axes(axis_name)
    for a in axes:
        if a not in shard.runner.mesh.axis_names:
            raise NameError(f"unbound axis name: {a}")
    return shard.runner.collective(shard.index, (kind, axes, args), x)


def ppermute(x: torch.Tensor, axis_name: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: shard ``src`` sends ``x`` to shard ``dst``
    for each ``(src, dst)`` in ``perm`` (global indices along the axis);
    a shard nothing is sent to gets zeros."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _collective("ppermute", x, axis_name, perm)


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int, tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``x`` split along
    ``split_axis`` into one chunk a shard of the axis, chunk ``j`` sent
    to shard ``j``, and the chunks received joined along
    ``concat_axis`` in the senders' order."""
    if not tiled:
        raise ValueError("all_to_all is tiled only (tiled=True)")
    return _collective("all_to_all", x, axis_name,
                       (int(split_axis), int(concat_axis)))


def psum(x: torch.Tensor, axis_name) -> torch.Tensor:
    """``jax.lax.psum`` over one axis or a tuple of axes: the sum over
    the group, in a fixed order, on every member."""
    return _collective("psum", x, axis_name, None)


def run_shards(mesh: Mesh, fn: Callable[[int], object]) -> list:
    """``fn(i)`` for each shard ``i`` of ``mesh`` (row-major over
    ``positions(mesh)``) as one SPMD program; the results in shard
    order."""
    return _Spmd(mesh).run(fn)


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _local_arg(mesh: Mesh, spec, arg, coords, device):
    def one(x):
        if isinstance(x, ShardedTensor):
            return x.piece(block_of(mesh, x.sharding.spec, coords), device)
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if not isinstance(x, torch.Tensor):
            return x
        return cut(x, mesh, spec, coords).to(device)

    return _map_tree(one, arg)


def shard_map(body: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """``jax.shard_map``: a function of whole arrays (tensors, numpy
    arrays, ``ShardedTensor``s, or dicts of them; this process's part
    under ``torch.distributed``) that cuts each by its spec, runs
    ``body`` on every shard's blocks and gathers the outputs: a
    replicated output (``P()``) is shard 0's, a cut one a
    ``ShardedTensor`` of one piece a block."""
    single = isinstance(out_specs, PartitionSpec) \
        or not isinstance(out_specs, tuple)
    outs_spec = (out_specs,) if single else out_specs

    def fn(*args):
        coords = positions(mesh)

        def shard(i):
            dev = mesh.devices[coords[i]]
            local = [_local_arg(mesh, s, a, coords[i], dev)
                     for s, a in zip(in_specs, args)]
            return body(*local)

        results = run_shards(mesh, shard)
        gathered = []
        for k, spec in enumerate(outs_spec):
            per = [r if single else r[k] for r in results]
            if is_replicated(spec):
                gathered.append(per[0])
                continue
            first = spec_blocks(mesh, spec)
            gathered.append(ShardedTensor(
                [per[coords.index(c)] for _, c in first],
                NamedSharding(mesh, PartitionSpec(*spec)),
                [b for b, _ in first]))
        return gathered[0] if single else tuple(gathered)

    return fn
