"""Card-only checks of the observability plane: the prefetcher's pinned,
non-blocking staging on a side stream, the profiler helper's busy share
on a known kernel, and a traced fit that is still one launch of the fit
kernel (B1).  Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_obs.py

Tolerance: none; staged values equal the host batches bit for bit, and
counts (launches, e2e closes) are exact.
"""

import numpy as np
import pytest
import torch

from iotml_torch.data.dataset import Batch, SensorBatches
from iotml_torch.data.prefetch import DevicePrefetcher
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.obs import profile, tracing
from iotml_torch.ops import fused_train
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train.loop import Trainer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _host_batches(n=12, b=256, seed=0):
    rng = np.random.default_rng(seed)
    return [Batch(x=rng.standard_normal((b, 18)).astype(np.float32),
                  n_valid=b - i, first_index=i * b,
                  y=rng.standard_normal((b, 18)).astype(np.float32))
            for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_stages_pinned_non_blocking_in_order(cuda_device, depth):
    host = _host_batches()
    got = []
    # a busy consumer stream: staged copies must still land in order
    for (x, y, mask), b in DevicePrefetcher(iter(host), depth=depth,
                                            device=cuda_device):
        assert x.is_cuda and y.is_cuda and mask.is_cuda
        torch.matmul(x, x.T)  # work queued behind the copy on this stream
        got.append((x.cpu().numpy(), y.cpu().numpy(), mask.cpu().numpy(),
                    b.first_index))
    assert len(got) == len(host)
    for (x, y, mask, first), b in zip(got, host):
        np.testing.assert_array_equal(x, b.x)
        np.testing.assert_array_equal(y, b.y)
        np.testing.assert_array_equal(mask, b.mask)
        assert first == b.first_index


@pytest.mark.cuda
def test_prefetcher_pins_on_the_worker_and_refuses_pageable(cuda_device):
    pf = DevicePrefetcher(iter(_host_batches(2)), device=cuda_device)
    batch, pinned = pf._host(_host_batches(1)[0])
    assert all(t.is_pinned() for t in pinned)
    pageable = tuple(torch.from_numpy(np.array(a))
                     for a in (batch.x, batch.y, batch.mask))
    with pytest.raises(RuntimeError, match="pageable"):
        pf._default_to_device((batch, pageable))
    list(pf)


@pytest.mark.cuda
def test_busy_share_of_a_known_kernel(cuda_device, tmp_path):
    a = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()
    with profile.trace(str(tmp_path)) as cap:
        for _ in range(8):
            a = a @ a
            a = a / a.norm()
    s = cap.summary(top=5)
    assert s["device_ops"] >= 16 and s["device_ms"] > 0
    assert s["device_ms"] <= s["device_sum_ms"] + 1e-9
    assert 0.0 < s["busy_share"] <= 1.0
    assert s["top"] and s["top"][0]["ms"] > 0
    assert profile.trace_files(str(tmp_path)) == [cap.path]


@pytest.mark.cuda
def test_traced_fit_is_one_b1_launch(cuda_device):
    tracing.reset()
    tracing.configure(enabled=True, sample=1.0)
    try:
        broker = Broker()
        FleetGenerator(FleetScenario(num_cars=100, seed=1)).publish(
            broker, "T", n_ticks=20)
        batches = SensorBatches(StreamConsumer(broker, ["T:0:0"],
                                               group="fit"), batch_size=100)
        before = fused_train.fused_fit.launches
        h = Trainer(CAR_AUTOENCODER, device=cuda_device).fit_compiled(
            batches, epochs=3)
        assert fused_train.fused_fit.launches - before == 1
        assert np.all(np.isfinite(h["loss"])) and len(h["loss"]) == 3
        assert tracing.flush()["e2e"] == 2000
    finally:
        tracing.configure(enabled=False)
        tracing.reset()
