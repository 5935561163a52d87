"""Card-only checks of the data-parallel path: two logical shards on
``cuda:0`` held against the same work on the CPU.  Every test is marked
``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_parallel.py

- ``ShardedTrainer.fit`` on ``[cuda:0, cuda:0]`` (batch 100, 2 epochs)
  against the same fit on two CPU shards and against the single-device
  ``Trainer.fit`` on the card: losses and params rtol 1e-4 / atol 1e-6;
- ``OnlineLearner(mesh=, chip_monitors=)``: two windows, the global and
  per-device losses against a CPU learner's, rtol 1e-5;
- two ranks on the one card (gloo, CUDA tensors; NCCL refuses two ranks
  on one GPU): equal trajectories, within rtol 1e-4 of a one-process
  CPU fit of the ranks' batches.
"""

import numpy as np
import pytest
import torch
from test_torch_multihost import _broker, _check, _single_process_losses

from iotml_torch.data.dataset import Batch
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.online.detectors import DriftMonitor
from iotml_torch.online.learner import OnlineLearner
from iotml_torch.parallel.data_parallel import ShardedTrainer
from iotml_torch.parallel.mesh import make_mesh
from iotml_torch.parallel.multihost_worker import spawn_rehearsal
from iotml_torch.stream.broker import Broker
from iotml_torch.train.loop import Trainer

TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _batches(n=6, rows=100, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.uniform(-1, 1, (rows, 18)).astype(np.float32)
        nv = rows - 13 if i == n - 1 else rows
        x[nv:] = 0.0
        out.append(Batch(x=x, n_valid=nv, first_index=rows * i))
    return out


def _mesh(device, n=2):
    return make_mesh((n,), ("data",), devices=[device] * n)


@pytest.mark.cuda
def test_sharded_fit_on_two_card_shards_matches_the_cpu(card):
    fits = {}
    for dev in (card, torch.device("cpu")):
        st = ShardedTrainer(CAR_AUTOENCODER, _mesh(dev))
        fits[dev.type] = (st.fit(_batches(), epochs=2), st.state)
    (h, state), (ch, cstate) = fits["cuda"], fits["cpu"]
    np.testing.assert_allclose(h["loss"], ch["loss"], **TOL)
    for k, v in cstate.params.items():
        np.testing.assert_allclose(state.params[k].cpu().numpy(),
                                   v.numpy(), **TOL, err_msg=k)
    assert all(v.device == card for v in state.params.values())
    # the single-device fit on the card, on the same batches
    tr = Trainer(CAR_AUTOENCODER, device=card)
    th = tr.fit(_batches(), epochs=2, verbose=False)
    np.testing.assert_allclose(h["loss"], th["loss"], **TOL)
    for k, v in tr.state.params.items():
        np.testing.assert_allclose(state.params[k].cpu().numpy(),
                                   v.cpu().numpy(), **TOL, err_msg=k)


@pytest.mark.cuda
def test_online_mesh_chip_losses_match_the_cpu(card):
    rng = np.random.default_rng(1)
    wins = [rng.normal(0, 0.1, (100, 18)).astype(np.float32)
            for _ in range(2)]
    wins[1][50:] += 3.0
    out = {}
    for dev in (card, torch.device("cpu")):
        lr = OnlineLearner(Broker(), "T", mesh=_mesh(dev),
                           device_normalize=True, window=100,
                           chip_monitors=[DriftMonitor() for _ in range(2)])
        got = []
        for i, x in enumerate(wins):
            loss = lr._update(Batch(x=x, n_valid=100, first_index=100 * i))
            got.append((loss, np.asarray(lr.last_chip_losses)))
        out[dev.type] = got
    for (loss, chips), (c_loss, c_chips) in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(loss, c_loss, rtol=1e-5)
        np.testing.assert_allclose(chips, c_chips, rtol=1e-5)


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_match_the_cpu(card):
    broker = _broker(4)
    procs, outs = spawn_rehearsal(steps=6, timeout=300.0, n_partitions=4,
                                  n_procs=2, shards=2, device="cuda:0",
                                  backend="gloo", broker=broker)
    losses = _check(procs, outs, 2, 2)
    np.testing.assert_allclose(
        losses, _single_process_losses(broker, 2, 4, 2, 6), rtol=1e-4)
