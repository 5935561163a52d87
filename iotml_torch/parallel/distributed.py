"""Multi-process join and the static partition→process split
(``iotml.parallel.distributed``'s twin).

Two planes, as in the JAX package:

- the data plane: each process runs its own stream consumers over its
  share of the topic's partitions (``assign_partitions``), the
  consumer-group model of the reference's pods, but deterministic, so
  offset checkpoints stay process-stable across restarts;
- the collective plane: ``initialize`` joins ``torch.distributed`` from
  the variables the multi-host deploy manifest sets on every pod
  (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), and
  the sharded step (``parallel.data_parallel``) sums its gradients
  across the processes with one ``all_reduce``.

The backend is chosen explicitly: ``nccl`` for CUDA devices, ``gloo``
for the CPU, or what the caller names.  A failed join raises; nothing
falls back to another backend.  NCCL refuses two ranks on one GPU
("Duplicate GPU detected"), so ranks that share a card pass
``backend="gloo"``, which reduces CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch

from ..utils.device import DeviceLike, resolve_device

#: seconds a rendezvous (and every collective after it) waits for its
#: peers before it raises, so a lost peer fails instead of hanging
DEFAULT_TIMEOUT_S = 120.0


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None, device: DeviceLike = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group; returns False (and joins nothing) for a
    single process.

    ``coordinator`` is ``host:port`` of rank 0's rendezvous store; each
    argument left None falls back to its environment variable
    (``JAX_COORDINATOR``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).
    ``backend`` None picks ``nccl`` when ``device`` (``cuda`` unless
    given) is a CUDA device and ``gloo`` otherwise; under ``nccl`` the
    process's current CUDA device becomes ``rank_device(device)``."""
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if num_processes in (None, 1) and not coordinator:
        return False
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            f"a multi-process join needs a coordinator, a process count "
            f"and a process id (JAX_COORDINATOR / JAX_NUM_PROCESSES / "
            f"JAX_PROCESS_ID), got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} out of range "
                         f"0..{num_processes - 1}")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device: DeviceLike = None) -> torch.device:
    """The device this process's shards run on: ``device`` (``cuda``
    unless given).  A CUDA device given without an index takes
    ``LOCAL_RANK % device_count`` when the launcher sets ``LOCAL_RANK``
    (one rank per card on a node), else the current CUDA device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        idx = (int(local) % torch.cuda.device_count() if local is not None
               else torch.cuda.current_device())
        dev = torch.device("cuda", idx)
    return dev


def process_count() -> int:
    """Processes in the joined group (1 when none was joined)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def assign_partitions(n_partitions: int, n_hosts: int,
                      host_id: int) -> List[int]:
    """Static partition→process assignment (round-robin): disjoint and
    exhaustive for every (partitions, processes)."""
    if not 0 <= host_id < n_hosts:
        raise ValueError(f"host_id {host_id} out of range 0..{n_hosts - 1}")
    return [p for p in range(n_partitions) if p % n_hosts == host_id]


def consumer_specs(topic: str, partitions: List[int],
                   offset: int = 0) -> List[str]:
    """Subscription specs for this process's partitions (the
    reference's ``topic:partition:offset`` format)."""
    return [f"{topic}:{p}:{offset}" for p in partitions]
