"""The port's device prefetcher (``iotml_torch.data.prefetch``) on the CPU:
the five cases of ``tests/test_prefetch.py`` against the port (order,
error propagation, early break, single use, depth below one), its
``host_wait`` and occupancy metrics, the ``IOTML_PREFETCH_DEPTH`` knob
(``data.pipeline``) against the JAX package's, and the device rule.

Tolerance: none; batch order, values, metadata and counts are exact.
"""

import numpy as np
import pytest
import torch

from iotml.data import pipeline as j_pipeline
from iotml_torch.data import pipeline
from iotml_torch.data.dataset import Batch
from iotml_torch.data.prefetch import DevicePrefetcher
from iotml_torch.obs import metrics as obs_metrics


def _batches(n=6, b=16):
    for i in range(n):
        yield Batch(x=np.full((b, 18), float(i), np.float32), n_valid=b,
                    first_index=i * b)


def test_prefetch_delivers_all_in_order():
    got = []
    for (x, y, mask), b in DevicePrefetcher(_batches(6), device="cpu"):
        assert y is None and isinstance(x, torch.Tensor)
        assert int(mask.sum()) == b.n_valid
        got.append((float(x[0, 0]), b.first_index))
    assert got == [(float(i), i * 16) for i in range(6)]


def test_prefetch_propagates_source_error():
    def bad():
        yield from _batches(2)
        raise RuntimeError("stream died")

    it = iter(DevicePrefetcher(bad(), device="cpu"))
    next(it), next(it)
    with pytest.raises(RuntimeError, match="stream died"):
        next(it)


def test_prefetch_early_break_releases_worker():
    pf = DevicePrefetcher(_batches(100), depth=2, device="cpu")
    for i, _item in enumerate(pf):
        if i == 1:
            break
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


def test_prefetch_is_single_use():
    pf = DevicePrefetcher(_batches(2), device="cpu")
    list(pf)
    with pytest.raises(RuntimeError, match="single-use"):
        list(pf)


def test_depth_below_one_rejected():
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher([], depth=0, device="cpu")


def test_y_and_mask_staged_with_x_and_a_custom_to_device():
    b = Batch(x=np.ones((4, 3), np.float32), n_valid=3, first_index=0,
              y=np.full((4, 3), 2.0, np.float32))
    (x, y, mask), _ = next(iter(DevicePrefetcher([b], device="cpu")))
    assert y.tolist() == [[2.0] * 3] * 4 and mask.tolist() == [1, 1, 1, 0]
    seen = list(DevicePrefetcher([b], to_device=lambda bb: bb.n_valid,
                                 device="cpu"))
    assert seen == [3]


def test_host_wait_and_occupancy_are_observed():
    key = (("loop", "score"), ("phase", "host_wait"))
    before = obs_metrics.step_seconds._ns.get(key, 0)
    assert len(list(DevicePrefetcher(_batches(5), device="cpu",
                                     loop="score"))) == 5
    # one observation a dequeue, the end marker's included
    assert obs_metrics.step_seconds._ns[key] - before == 6
    occ = obs_metrics.prefetch_occupancy.value(loop="score")
    assert 0.0 <= occ <= 1.0


@pytest.mark.parametrize("raw,want", [(None, 2), ("", 2), ("5", 5),
                                      ("0", ValueError), ("x", ValueError)])
def test_prefetch_depth_knob_equals_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv("IOTML_PREFETCH_DEPTH", raising=False)
    else:
        monkeypatch.setenv("IOTML_PREFETCH_DEPTH", raw)
    for mod in (pipeline, j_pipeline):
        if want is ValueError:
            with pytest.raises(ValueError, match="IOTML_PREFETCH_DEPTH"):
                mod.prefetch_depth()
        else:
            assert mod.prefetch_depth() == want
    if want is ValueError:
        with pytest.raises(ValueError):
            DevicePrefetcher([], device="cpu")
    else:
        assert DevicePrefetcher([], device="cpu").q.maxsize == want


def test_set_knobs_validates_before_publishing(monkeypatch):
    monkeypatch.delenv("IOTML_PREFETCH_DEPTH", raising=False)
    with pytest.raises(ValueError):
        pipeline.set_knobs(prefetch_depth=0)
    assert pipeline.prefetch_depth() == 2
    pipeline.set_knobs(prefetch_depth=4)
    assert pipeline.prefetch_depth() == 4
    # the mesh knobs, as JAX's: validated, published, read back
    for name in ("IOTML_MESH_DATA", "IOTML_DEVICE_NORMALIZE"):
        monkeypatch.setenv(name, "")
    for mod in (pipeline, j_pipeline):
        with pytest.raises(ValueError):
            mod.set_knobs(mesh_data=-1)
        assert mod.mesh_data() == 0 and mod.device_normalize() is False
        mod.set_knobs(mesh_data=2, device_normalize=True)
        assert mod.mesh_data() == 2 and mod.device_normalize() is True
        mod.set_knobs(mesh_data=0, device_normalize=False)
    assert not hasattr(pipeline, "UNPORTED_KNOBS")
    with pytest.raises(TypeError):
        pipeline.set_knobs(nonsense=1)
    # the ring's and the raw produce plane's knobs are ported: each
    # validated before any is published
    for name in ("IOTML_DECODE_RING_BUFFERS", "IOTML_RAW_BATCH_BYTES",
                 "IOTML_PRODUCE_BATCH_BYTES", "IOTML_RAW_PRODUCE"):
        monkeypatch.setenv(name, "")
    with pytest.raises(ValueError):
        pipeline.set_knobs(decode_ring_buffers=8, raw_batch_bytes=4095)
    assert pipeline.decode_ring_buffers() == 4
    pipeline.set_knobs(decode_ring_buffers=8, raw_batch_bytes=65536,
                       produce_batch_bytes=8192, raw_produce="OFF")
    assert (pipeline.decode_ring_buffers(), pipeline.raw_batch_bytes(),
            pipeline.produce_batch_bytes(), pipeline.raw_produce_mode()) \
        == (8, 65536, 8192, "off")


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher([])
