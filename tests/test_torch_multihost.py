"""The port's multi-process rehearsal
(``iotml_torch.parallel.multihost_worker``): OS processes joined by
``torch.distributed`` over gloo on the CPU, each consuming only its
``assign_partitions`` share of a topic from a ``KafkaWireServer`` and
driving a ``ShardedTrainer`` over its local CPU shards, so each step's
gradient sum crosses the processes (``tests/test_multihost.py``'s
rehearsal on the port).

Every rank must agree on the loss trajectory exactly, and the
trajectory is the single-process fit over 8 shards of the ranks'
concatenated batches within rtol 1e-4 (``tests/test_parallel.py``'s
bound).  The 2-process case runs in tier 1 with a 120 s limit; the
4-process case is marked slow, as JAX's is.
"""

import json
import re

import numpy as np
import pytest
import torch

from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.parallel.data_parallel import ShardedTrainer
from iotml_torch.parallel.distributed import assign_partitions, \
    consumer_specs
from iotml_torch.parallel.mesh import make_mesh
from iotml_torch.parallel.multihost_worker import spawn_rehearsal
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer

#: the rendezvous and collective limit, and the whole rehearsal's
TIMEOUT_S = 120.0


def _broker(n_partitions):
    broker = Broker()
    FleetGenerator(FleetScenario(num_cars=40, failure_rate=0.02)).publish(
        broker, "SENSOR", n_ticks=60, partitions=n_partitions)
    return broker


def _single_process_losses(broker, n_procs, n_partitions, shards, steps):
    """One process, n_procs × shards CPU shards, each step's batch the
    ranks' batches concatenated in rank order."""
    per_rank = []
    for pid in range(n_procs):
        parts = assign_partitions(n_partitions, n_procs, pid)
        consumer = StreamConsumer(broker, consumer_specs("SENSOR", parts),
                                  group=f"single-{pid}")
        per_rank.append(list(SensorBatches(consumer, batch_size=32,
                                           only_normal=True,
                                           pad_tail=False)))
    n = n_procs * shards
    tr = ShardedTrainer(CAR_AUTOENCODER, make_mesh(
        (n,), ("data",), devices=[torch.device("cpu")] * n))
    losses = []
    for i in range(steps):
        bs = [r[i % len(r)] for r in per_rank]
        x = np.concatenate([b.x for b in bs])
        mask = np.concatenate([b.mask for b in bs])
        losses.append(float(tr.step(x, x, mask)["loss"]))
    return losses


def _check(procs, outs, n_procs, shards):
    traj = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} exited {p.returncode}:\n{out}"
        assert f"MULTIHOST pid={pid}/{n_procs} devices={n_procs * shards}" \
            in out, out
        assert re.search(r"loss [\d.]+->[\d.]+ rate=[\d.]+ rows=\d+ ok", out)
        line = next(ln for ln in out.splitlines()
                    if ln.startswith("MULTIHOST-LOSSES "))
        traj.append(json.loads(line.split(" ", 1)[1]))
    # every rank applied the same summed gradients: equal trajectories
    assert all(t == traj[0] for t in traj), traj
    return traj[0]


def test_two_process_gloo_training_matches_one_process():
    broker = _broker(4)
    procs, outs = spawn_rehearsal(steps=6, timeout=TIMEOUT_S,
                                  n_partitions=4, n_procs=2, shards=4,
                                  device="cpu", broker=broker)
    losses = _check(procs, outs, 2, 4)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(
        losses, _single_process_losses(broker, 2, 4, 4, 6), rtol=1e-4)


@pytest.mark.slow
def test_four_process_gloo_training_matches_one_process():
    broker = _broker(4)
    procs, outs = spawn_rehearsal(steps=4, timeout=TIMEOUT_S,
                                  n_partitions=4, n_procs=4, shards=2,
                                  device="cpu", broker=broker)
    losses = _check(procs, outs, 4, 2)
    np.testing.assert_allclose(
        losses, _single_process_losses(broker, 4, 4, 2, 4), rtol=1e-4)
