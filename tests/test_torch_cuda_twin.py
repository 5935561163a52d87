"""Card-only checks of the twin's device work: the fused fit kernel (B1)
at the joined layout's shape, (F, E, H) = (38, 14, 7), where
``fit_design`` gives "elements", against its plain version; and the
scorer's feature-store join on ``cuda`` against the same scorer on the
CPU.  Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_twin.py

Tolerances: the fit at the JAX suite's fused-vs-scanned bounds
(tests/test_fused_train.py): losses rtol 2e-4 / atol 1e-6, params and
moments rtol 5e-3 / atol 2e-5; the scorer's payloads (parsed) atol 2e-6
on the card vs the CPU, its per-row errors rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import AutoencoderSpec
from iotml_torch.ops import fused_train
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.loop import Trainer
from iotml_torch.twin import TwinFeatureStore, TwinService

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)
IN = "SENSOR_DATA_S_AVRO"
F = 18


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _twin_fleet(cars=200, ticks=10):
    b = Broker()
    FleetGenerator(FleetScenario(num_cars=cars, seed=7)).publish(
        b, IN, n_ticks=ticks, partitions=2)
    svc = TwinService(b)
    while svc.pump_once():
        pass
    return b, svc, TwinFeatureStore(svc)


def _joined_batches(b, fs, group):
    batches = SensorBatches(StreamConsumer(b, [f"{IN}:{p}:0"
                                               for p in range(2)],
                                           group=group),
                            batch_size=100, keep_keys=True)
    out = []
    for bt in batches:
        x = np.concatenate([bt.x, fs.matrix(bt.keys, bt.x.shape[0])],
                           axis=1).astype(np.float32)
        out.append((x, bt.mask))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("epochs", [1, 5])
def test_b1_elements_at_the_joined_shape_matches_plain(epochs,
                                                       cuda_device):
    b, _, fs = _twin_fleet()
    rows = _joined_batches(b, fs, "fit")
    xs = torch.from_numpy(np.stack([x for x, _ in rows])).to(cuda_device)
    masks = torch.from_numpy(np.stack([m for _, m in rows])).to(cuda_device)
    assert tuple(xs.shape[1:]) == (100, F + fs.dim)
    tr = Trainer(AutoencoderSpec(input_dim=F + fs.dim), seed=3,
                 device=cuda_device)
    tr._ensure_state()
    assert fused_train.fit_design(100, F + fs.dim, 14, 7) == "elements"
    before = fused_train.fused_fit.launches_by_design["elements"]
    k_state, k_loss, k_acc = fused_train.fused_fit(tr.state, xs, masks,
                                                   epochs)
    torch.cuda.synchronize()
    assert fused_train.fused_fit.launches_by_design["elements"] == \
        before + 1
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        tr.state, xs, masks, epochs)
    torch.testing.assert_close(k_loss.cpu(), p_loss.cpu(), **LOSS_TOL)
    torch.testing.assert_close(k_acc.cpu(), p_acc.cpu(), **LOSS_TOL)
    for k in p_state.params:
        torch.testing.assert_close(k_state.params[k], p_state.params[k],
                                   **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.mu[k],
                                   p_state.opt_state.mu[k], **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.nu[k],
                                   p_state.opt_state.nu[k], **PARAM_TOL)


def _parse(msg: bytes):
    parts = msg.decode().split("|")
    return np.array(parts[0].strip("[]").split(), np.float64), parts[1:]


@pytest.mark.cuda
def test_joined_scorer_on_the_card_matches_the_cpu(cuda_device):
    b, _, fs = _twin_fleet()
    tr = Trainer(AutoencoderSpec(input_dim=F + fs.dim), seed=5,
                 device="cpu")
    tr._ensure_state()
    runs = {}
    for dev in ("cpu", cuda_device):
        batches = SensorBatches(
            StreamConsumer(b, [f"{IN}:{p}:0" for p in range(2)],
                           group=f"score-{dev}"),
            batch_size=100, keep_keys=True)
        out = OutputSequence()
        sc = StreamScorer(AutoencoderSpec(input_dim=F + fs.dim),
                          tr.state.params, batches, out, feature_store=fs,
                          verdict_mask=np.ones(F, bool), threshold=0.05,
                          device=dev)
        assert sc.score_available() == 2000
        runs[str(dev)] = [m for _, m in out.published]
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    assert len(cpu) == len(card) == 2000
    for c, g in zip(cpu, card):
        c_vals, c_tail = _parse(c)
        g_vals, g_tail = _parse(g)
        assert c_vals.shape == (F + fs.dim,)
        np.testing.assert_allclose(g_vals, c_vals, rtol=0, atol=2e-6)
        np.testing.assert_allclose(float(g_tail[1]), float(c_tail[1]),
                                   rtol=1e-5, atol=1e-6)
