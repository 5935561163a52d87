"""Device mesh (``iotml.parallel.mesh``'s twin).

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
holds this process's devices only; the data axis of a multi-process job
is processes × local shards.

There is no SPMD compiler here, so a sharding is a plain spec object
(``NamedSharding(mesh, PartitionSpec(...))``) that says how an array is
cut, and ``ShardedTensor`` is an array held as its pieces, one tensor a
shard on that shard's device.  The sharded steps are written out shard
by shard (``parallel.data_parallel``); JAX's ``shard_map`` version shim
has no counterpart.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import List, Optional, Sequence

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


class PartitionSpec(tuple):
    """Mesh axis (or None) per array dimension; trailing dimensions not
    named are whole.  ``PartitionSpec()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """How an array is cut over ``mesh``: ``spec`` names a mesh axis
    (or None) for each leading dimension."""

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


class ShardedTensor:
    """An array held as its pieces: ``shards[i]`` is the ``i``-th block
    along the sharded axis (rows for ``P('data')``), on its device; a
    replicated array holds one whole copy a device."""

    def __init__(self, shards: Sequence[torch.Tensor],
                 sharding: NamedSharding):
        self.shards = list(shards)
        self.sharding = sharding

    @property
    def shape(self) -> tuple:
        first = tuple(self.shards[0].shape)
        if not self.sharding.spec or self.sharding.spec[0] is None:
            return first
        return (sum(int(s.shape[0]) for s in self.shards),) + first[1:]

    def numpy(self) -> np.ndarray:
        """The whole array on the host (a device→host copy a shard)."""
        host = [s.detach().cpu().numpy() for s in self.shards]
        if not self.sharding.spec or self.sharding.spec[0] is None:
            return host[0]
        return np.concatenate(host)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, "
                f"spec={self.sharding.spec!r}, "
                f"devices={[s.device for s in self.shards]})")
