"""Card-only checks of the durable store's path: B1 (the fused fit kernel,
through its "rows" design) on batches read back from a durable log that a
crash-simulating remount recovered, and from a tiered log whose hot tier
no longer holds the head, each against its plain version on the card.
Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_store.py

Tolerances are the JAX suite's fused-vs-scanned bounds
(tests/test_fused_train.py): losses rtol 2e-4 / atol 1e-6, params and
moments rtol 5e-3 / atol 2e-5.  The two logs' batches are exactly equal,
so their kernel outputs are equal bit for bit.
"""

import numpy as np
import pytest
import torch

from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.ops import fused_train
from iotml_torch.store import StorePolicy, TierPolicy
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train.loop import Trainer

TOPIC, PARTS = "SENSOR_DATA_S_AVRO", 10
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _publish(d: str) -> None:
    """Four ticks of 2,000 cars into a durable broker; a torn tail on one
    partition's active segment, the mount dropped without close()."""
    gen = FleetGenerator(FleetScenario(num_cars=2000, interval_s=10))
    codec = native.NativeCodec(KSQL_CAR_SCHEMA)
    b = Broker(store_dir=d, store_policy=StorePolicy(segment_bytes=1 << 14))
    b.create_topic(TOPIC, partitions=PARTS)
    for _ in range(4):
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        b.produce_many(TOPIC, [(gen.scenario.car_id(i).encode(), m, ts)
                               for i, m in enumerate(msgs)])
    b.store.log_for(TOPIC, 2).simulate_torn_write()
    b.store.flush()


def _batches(broker, group):
    specs = [f"{TOPIC}:{p}:0" for p in range(PARTS)]
    bs = list(next(SensorBatches(StreamConsumer(broker, specs, group=group),
                                 batch_size=100, take=50,
                                 only_normal=True).epochs(1)))
    assert len(bs) == 50
    return bs


def _fit(bs):
    trainer = Trainer(CAR_AUTOENCODER)
    trainer._ensure_state()
    st = trainer.state
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    before = fused_train.fused_fit.launches
    rows = fused_train.fused_fit.launches_by_design["rows"]
    out = fused_train.fused_fit(st, xs, masks, 5)
    assert fused_train.fused_fit.launches == before + 1
    assert fused_train.fused_fit.launches_by_design["rows"] == rows + 1
    plain = fused_train.fused_fit_reference(st, xs, masks, 5)
    (k_state, k_loss, k_acc), (p_state, p_loss, p_acc) = out, plain
    torch.testing.assert_close(k_loss, p_loss, **LOSS_TOL)
    torch.testing.assert_close(k_acc, p_acc, **LOSS_TOL)
    for k in PARAM_NAMES:
        for got, want in ((k_state.params, p_state.params),
                          (k_state.opt_state.mu, p_state.opt_state.mu),
                          (k_state.opt_state.nu, p_state.opt_state.nu)):
            torch.testing.assert_close(got[k], want[k], **PARAM_TOL)
    return out


@pytest.mark.cuda
def test_b1_on_a_recovered_and_a_tiered_log(cuda_device, tmp_path):
    d = str(tmp_path / "store")
    _publish(d)
    b = Broker(store_dir=d)  # the same process's remount recovers
    try:
        assert b.store.recovered_truncated_bytes() > 0
        local = _batches(b, "fit")
        k_local = _fit(local)
    finally:
        b.close()
    tb = Broker(store_dir=d, store_policy=StorePolicy(segment_bytes=1 << 14),
                tier=TierPolicy(uri=str(tmp_path / "bucket"),
                                local_hot_bytes=1 << 14))
    try:
        stats = tb.run_tiering()
        assert stats and all(s["evicted"] > 0 for s in stats.values())
        assert all(tb.store.log_for(TOPIC, p).local_base_offset > 0
                   for p in range(PARTS))
        tiered = _batches(tb, "fit")
    finally:
        tb.close()
    for x, y in zip(tiered, local):
        assert np.array_equal(x.x, y.x) and np.array_equal(x.mask, y.mask)
    k_tiered = _fit(tiered)
    assert torch.equal(k_tiered[1], k_local[1])
    for k in PARAM_NAMES:
        assert torch.equal(k_tiered[0].params[k], k_local[0].params[k])
