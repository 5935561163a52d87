"""Card-only checks of the gateway's device work: the scorer joining
through ``GatewayClient`` on ``cuda`` against the same scorer on the CPU,
across a shard kill and promotion; and two B1 "elements" fits at the
joined shape, one from rows joined through the gateway and one from rows
joined through a local ``TwinFeatureStore``, bit-equal.  Every test is
marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_gateway.py

Tolerances: the scorer's payloads (parsed) atol 2e-6 on the card vs the
CPU, its per-row errors rtol 1e-5; the two fits bit for bit (the same
bits in, one deterministic kernel).
"""

import time

import numpy as np
import pytest
import torch

from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gateway import GatewayClient, GatewayCluster
from iotml_torch.gateway.drill import sources_committed
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import AutoencoderSpec
from iotml_torch.ops import fused_train
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.loop import Trainer
from iotml_torch.twin import TwinFeatureStore, TwinService

IN = "SENSOR_DATA_S_AVRO"
F = 18
PARTS = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _await(cond, what, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        if time.monotonic() >= deadline:
            raise TimeoutError(f"{what} not reached in {timeout_s}s")
        time.sleep(0.02)


@pytest.fixture
def gateway():
    """A broker of 200 cars x 10 ticks served by 2 shards with standbys,
    and a local reference store over the same records."""
    b = Broker()
    published = FleetGenerator(FleetScenario(num_cars=200, seed=7)).publish(
        b, IN, n_ticks=10, partitions=PARTS)
    cluster = GatewayCluster(b, n_shards=2).start()
    client = GatewayClient(cluster)
    try:
        _await(lambda: client.aggregate()["records"] == published,
               "shards drained")
        _await(lambda: sources_committed(cluster), "sources committed")
        _await(lambda: all(s.lag() == 0 for s in cluster.standbys.values()),
               "standbys caught up")
        ref = TwinService(b, group="cuda-gw-ref", changelog=False)
        while ref.pump_once():
            pass
        yield b, cluster, client, TwinFeatureStore(ref)
    finally:
        client.close()
        cluster.stop()


def _batches(b, group):
    return SensorBatches(StreamConsumer(b, [f"{IN}:{p}:0"
                                            for p in range(PARTS)],
                                        group=group),
                         batch_size=100, keep_keys=True)


def _parse(msg: bytes):
    parts = msg.decode().split("|")
    return np.array(parts[0].strip("[]").split(), np.float64), parts[1:]


@pytest.mark.cuda
def test_gateway_joined_scorer_on_the_card_matches_the_cpu(cuda_device,
                                                           gateway):
    b, cluster, client, fs = gateway
    spec = AutoencoderSpec(input_dim=F + client.dim)
    tr = Trainer(spec, seed=5, device="cpu")
    tr._ensure_state()
    runs = {}
    for dev in ("cpu", cuda_device):
        out = OutputSequence()
        sc = StreamScorer(spec, tr.state.params, _batches(b, f"gw-{dev}"),
                          out, feature_store=client,
                          verdict_mask=np.ones(F, bool), threshold=0.05,
                          device=dev)
        sc.max_super_batches = 5
        n = sc.score_available(max_rows=1000)
        assert 0 < n < 2000
        if dev != "cpu":
            # the card's drain crosses a shard kill and promotion
            cluster.kill_shard(0)
            cluster.promote(0)
        n += sc.score_available()
        assert n == 2000
        runs[str(dev)] = [m for _, m in out.published]
    cpu, card = runs["cpu"], runs[str(cuda_device)]
    assert len(cpu) == len(card) == 2000
    for c, g in zip(cpu, card):
        c_vals, c_tail = _parse(c)
        g_vals, g_tail = _parse(g)
        assert c_vals.shape == (F + client.dim,)
        np.testing.assert_allclose(g_vals, c_vals, rtol=0, atol=2e-6)
        np.testing.assert_allclose(float(g_tail[1]), float(c_tail[1]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_two_elements_fits_through_either_store_are_bit_equal(cuda_device,
                                                               gateway):
    b, _, client, fs = gateway
    joined = {}
    for name, store in (("gateway", client), ("local", fs)):
        rows = [(np.concatenate([bt.x, store.matrix(bt.keys, bt.x.shape[0])],
                                axis=1).astype(np.float32), bt.mask)
                for bt in _batches(b, f"fit-{name}")]
        joined[name] = (
            torch.from_numpy(np.stack([x for x, _ in rows])).to(cuda_device),
            torch.from_numpy(np.stack([m for _, m in rows])).to(cuda_device))
    torch.testing.assert_close(joined["gateway"][0], joined["local"][0],
                               rtol=0, atol=0)
    assert fused_train.fit_design(100, F + client.dim, 14, 7) == "elements"
    tr = Trainer(AutoencoderSpec(input_dim=F + client.dim), seed=3,
                 device=cuda_device)
    tr._ensure_state()
    before = fused_train.fused_fit.launches_by_design["elements"]
    states = {name: fused_train.fused_fit(tr.state, xs, masks, 5)
              for name, (xs, masks) in joined.items()}
    torch.cuda.synchronize()
    assert fused_train.fused_fit.launches_by_design["elements"] == \
        before + 2
    (g_state, g_loss, _), (l_state, l_loss, _) = \
        states["gateway"], states["local"]
    assert torch.equal(g_loss, l_loss)
    for k in g_state.params:
        assert torch.equal(g_state.params[k], l_state.params[k]), k
        assert torch.equal(g_state.opt_state.mu[k], l_state.opt_state.mu[k])
        assert torch.equal(g_state.opt_state.nu[k], l_state.opt_state.nu[k])
