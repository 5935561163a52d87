"""The port's MNIST ingestion smoke test (``iotml_torch.data.mnist_stream``,
``iotml_torch.models.mnist``, ``iotml_torch.cli.mnist_smoke``) against the
JAX package's on the CPU.

Tolerances:
- the synthetic images and labels, the IDX reader, the produced messages
  and offsets and every zipped batch: exact (the same numpy code);
- both models' forwards against flax: rtol 1e-5 (float32 sums in another
  order; atol 1e-5 for logits near 0);
- ``classifier_fit`` against JAX's scanned fit from the same initial
  params over 2 epochs at n = 640: losses and accuracies rtol 1e-4.
"""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.cli import mnist_smoke as j_cli
from iotml.data import mnist_stream as j_ms
from iotml.models import mnist as j_models
from iotml.stream.broker import Broker as JBroker
from iotml_torch.cli import mnist_smoke as t_cli
from iotml_torch.data import mnist_stream as t_ms
from iotml_torch.models import mnist as t_models
from iotml_torch.models.convert import (mnist_params_from_jax,
                                        mnist_params_to_jax)
from iotml_torch.stream.broker import Broker

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("n,seed", [(100, 3), (2000, 0)])
def test_synth_mnist_matches_jax(n, seed):
    for got, want in zip(t_ms.synth_mnist(n, seed=seed),
                         j_ms.synth_mnist(n, seed=seed)):
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def _write_idx(tmp_path, images, labels, img_magic=2051, lab_magic=2049):
    ip, lp = str(tmp_path / "img.idx"), str(tmp_path / "lab.idx")
    with open(ip, "wb") as fh:
        fh.write(struct.pack(">IIII", img_magic, *images.shape))
        fh.write(images.tobytes())
    with open(lp, "wb") as fh:
        fh.write(struct.pack(">II", lab_magic, len(labels)))
        fh.write(labels.tobytes())
    return ip, lp


def test_load_mnist_idx_matches_jax(tmp_path):
    images, labels = t_ms.synth_mnist(37, seed=9)
    ip, lp = _write_idx(tmp_path, images, labels)
    for got, want in zip(t_ms.load_mnist_idx(ip, lp),
                         j_ms.load_mnist_idx(ip, lp)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t_ms.load_mnist_idx(ip, lp)[0], images)


@pytest.mark.parametrize("bad", [dict(img_magic=1), dict(lab_magic=7),
                                 dict(short=True)])
def test_load_mnist_idx_refuses_like_jax(tmp_path, bad):
    images, labels = t_ms.synth_mnist(10)
    if bad.pop("short", False):
        labels = labels[:9]
    ip, lp = _write_idx(tmp_path, images, labels, **bad)
    with pytest.raises(ValueError) as got:
        t_ms.load_mnist_idx(ip, lp)
    with pytest.raises(ValueError) as want:
        j_ms.load_mnist_idx(ip, lp)
    assert str(got.value) == str(want.value)


def test_produce_mnist_matches_jax():
    images, labels = t_ms.synth_mnist(70, seed=2)
    tb, jb = Broker(), JBroker()
    assert t_ms.produce_mnist(tb, images, labels) == \
        j_ms.produce_mnist(jb, images, labels) == 70
    for topic in ("xx", "yy"):
        assert tb.end_offset(topic, 0) == jb.end_offset(topic, 0) == 70
        assert [(m.offset, m.value) for m in tb.fetch(topic, 0, 0, 100)] == \
            [(m.offset, m.value) for m in jb.fetch(topic, 0, 0, 100)]


@pytest.mark.parametrize("n,batch_size,take", [(100, 32, None),
                                               (2100, 32, None),
                                               (2100, 50, 7), (64, 32, None)])
def test_mnist_batches_match_jax(n, batch_size, take):
    images, labels = t_ms.synth_mnist(n, seed=1)
    tb, jb = Broker(), JBroker()
    t_ms.produce_mnist(tb, images, labels)
    j_ms.produce_mnist(jb, images, labels)
    got = list(t_ms.MnistBatches(tb, batch_size=batch_size, take=take))
    want = list(j_ms.MnistBatches(jb, batch_size=batch_size, take=take))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert g.x.dtype == np.float32 and g.y.dtype == np.int32
    assert sum(len(list(ep)) for ep in
               t_ms.MnistBatches(tb, batch_size=batch_size,
                                 take=take).epochs(2)) == 2 * len(want)


def test_mnist_batches_refuse_a_short_image_like_jax():
    tb, jb = Broker(), JBroker()
    for b in (tb, jb):
        b.create_topic("xx")
        b.create_topic("yy")
        b.produce("xx", bytes(783))
        b.produce("yy", bytes([3]))
    with pytest.raises(ValueError) as got:
        list(t_ms.MnistBatches(tb))
    with pytest.raises(ValueError) as want:
        list(j_ms.MnistBatches(jb))
    assert str(got.value) == str(want.value)


def _jax_init(model, seed=0):
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, 28, 28), jnp.float32))["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("name", ["MNISTClassifier", "MNISTBaseline"])
def test_forward_matches_flax(name):
    jmodel = getattr(j_models, name)()
    params = _jax_init(jmodel, seed=4)
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (9, 28, 28)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, x))
    module = getattr(t_models, name)(device="cpu")
    sd = mnist_params_from_jax(params)
    assert set(sd) == set(module.state_dict())
    module.load_state_dict(sd)
    module.train()  # the train flag, not the module's mode, rules dropout
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD_TOL)
    jax.tree.map(np.testing.assert_array_equal, mnist_params_to_jax(sd),
                 params)


def test_baseline_dropout_fires_only_when_asked():
    module = t_models.MNISTBaseline(device="cpu")
    x = torch.full((4, 28, 28), 200.0)
    with torch.no_grad():
        assert torch.equal(module(x), module(x))
        torch.manual_seed(0)
        assert not torch.equal(module(x, train=True), module(x))


@pytest.mark.parametrize("name", ["MNISTClassifier", "MNISTBaseline"])
def test_classifier_fit_matches_jax(name):
    images, labels = t_ms.synth_mnist(640, seed=5)
    x = images.astype(np.float32)
    jmodel = getattr(j_models, name)()
    want = j_cli.classifier_fit(jmodel, x, labels, 32, 2)
    module = getattr(t_models, name)(device="cpu")
    module.load_state_dict(mnist_params_from_jax(_jax_init(jmodel)))
    got = t_cli.classifier_fit(module, x, labels, 32, 2)
    assert got["records"] == want["records"] == 640
    np.testing.assert_allclose(got["loss"], want["loss"], **FIT_TOL)
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], **FIT_TOL)
    assert got["loss"][-1] < got["loss"][0]


def test_classifier_fit_drops_the_tail():
    images, labels = t_ms.synth_mnist(70, seed=5)
    got = t_cli.classifier_fit(t_models.MNISTClassifier(device="cpu"),
                               images.astype(np.float32), labels, 32, 1)
    assert got["records"] == 64 and len(got["loss"]) == 1


def test_run_keeps_ingestion_intact(capsys):
    out = t_cli.run(["--n", "600", "--epochs", "3"], device="cpu")
    assert out["ingestion_intact"] is True
    assert out["produced"] == out["streamed_records"] == 600
    for path in ("streamed", "control"):
        assert out[path]["loss"][-1] < out[path]["loss"][0]
    assert out["streamed"]["accuracy"][-1] > 0.5
    assert '"ingestion_intact": true' in capsys.readouterr().out
