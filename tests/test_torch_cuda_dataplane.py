"""Card-only checks of the columnar frame ring's path: B1 (the fused fit
kernel, through its "rows" design) on batches the ring decoded from a
durable log and from RAW_FETCH over the wire, equal bit for bit to the
batches of the per-record leg over the same records, and the kernel
against its plain version on the card.  Every test is marked ``cuda``
and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_dataplane.py

Tolerances are the JAX suite's fused-vs-scanned bounds
(tests/test_fused_train.py): losses rtol 2e-4 / atol 1e-6, params and
moments rtol 5e-3 / atol 2e-5.  Equal batches give kernel outputs equal
bit for bit.
"""

import numpy as np
import pytest
import torch

from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.data import pipeline
from iotml_torch.data.dataset import SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.ops import fused_train
from iotml_torch.stream import native
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.kafka_wire import KafkaWireBroker, KafkaWireServer
from iotml_torch.train.loop import Trainer

TOPIC, PARTS = "SENSOR_DATA_S_AVRO", 10
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _publish(broker) -> None:
    """Four ticks of 2,000 cars as the reference topic holds them."""
    gen = FleetGenerator(FleetScenario(num_cars=2000, interval_s=10))
    codec = native.NativeCodec(KSQL_CAR_SCHEMA)
    broker.create_topic(TOPIC, partitions=PARTS)
    for _ in range(4):
        cols = gen.step_columns()
        msgs = codec.encode_batch(
            gen.sensor_matrix(cols),
            cols["failure_occurred"].astype("S16")[:, None], schema_id=1)
        ts = int(gen.t * 1000)
        broker.produce_many(TOPIC, [(gen.scenario.car_id(i).encode(), m, ts)
                                    for i, m in enumerate(msgs)])


def _batches(broker, group):
    specs = [f"{TOPIC}:{p}:0" for p in range(PARTS)]
    sb = SensorBatches(StreamConsumer(broker, specs, group=group),
                       batch_size=100, take=50, only_normal=True)
    bs = list(next(sb.epochs(1)))
    assert len(bs) == 50
    return bs, sb


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


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.x, y.x) and np.array_equal(x.mask, y.mask)


@pytest.mark.cuda
def test_b1_on_ring_batches_from_a_durable_log(cuda_device, tmp_path):
    """The ring's batches from a durable log equal the per-record leg's
    over an in-memory broker of the same records, and B1 fits them as
    its plain version does, bit for bit between the two."""
    durable, memory = Broker(store_dir=str(tmp_path / "store")), Broker()
    try:
        for b in (durable, memory):
            _publish(b)
        rows0 = native.stats["frame_decode_rows"]
        ring, sb = _batches(durable, "ring")
        assert isinstance(sb._ring, pipeline.DecodeRing)
        assert native.stats["frame_decode_rows"] > rows0
        records, sb2 = _batches(memory, "records")
        assert sb2._ring is None
        _same(ring, records)
        a, b = _fit(ring), _fit(records)
        for k in PARAM_NAMES:
            assert torch.equal(a[0].params[k], b[0].params[k])
    finally:
        durable.close()


@pytest.mark.cuda
def test_b1_on_ring_batches_over_raw_fetch(cuda_device, tmp_path):
    """The ring over RAW_FETCH (the pure client on the port's server
    over a durable broker) gives the durable log's own batches, and B1
    fits them as its plain version does."""
    durable = Broker(store_dir=str(tmp_path / "store"))
    try:
        _publish(durable)
        local, _ = _batches(durable, "local")
        with KafkaWireServer(durable) as srv:
            client = KafkaWireBroker(f"127.0.0.1:{srv.port}")
            try:
                wire, sb = _batches(client, "wire")
            finally:
                client.close()
        assert isinstance(sb._ring, pipeline.DecodeRing)
        _same(wire, local)
        _fit(wire)
    finally:
        durable.close()
