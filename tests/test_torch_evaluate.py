"""The port's evaluation library (``iotml_torch.evaluate``) against the JAX
package's on the CPU.

Tolerances:
- ``reconstruction_errors``: rtol 1e-5 against JAX's at the creditcard
  and cardata widths (the same converted params; float32 forwards whose
  sums run in another order), below, at and above one chunk of 8,192
  rows (the last chunk padded);
- the curves, AUC, AP, the confusion counts and ``AnomalyReport``:
  exact (the same numpy code on the same scores);
- ``write_report``'s JSON and SVG: byte-equal (matplotlib's SVG made
  reproducible the documented way: a fixed ``svg.hashsalt`` and
  ``SOURCE_DATE_EPOCH``).
"""

import jax
import numpy as np
import pytest
import torch

from iotml import evaluate as j_eval
from iotml.evaluate import report as j_report
from iotml.models.autoencoder import DenseAutoencoder as JDenseAutoencoder
from iotml_torch import evaluate as t_eval
from iotml_torch.evaluate import report as t_report
from iotml_torch.models.autoencoder import AutoencoderSpec
from iotml_torch.models.convert import params_from_jax

ERR_TOL = dict(rtol=1e-5, atol=0.0)


def _jax_params(F, seed=0):
    model = JDenseAutoencoder(input_dim=F)
    params = model.init(jax.random.PRNGKey(seed),
                        np.zeros((1, F), np.float32))["params"]
    return model, jax.tree.map(np.asarray, params)


def _scores(n=2000, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.1).astype(np.int32)
    scores = rng.gamma(2.0, 1.0, n) + 3.0 * labels
    if ties:
        scores[::7] = np.round(scores[::7], 1)  # tied thresholds
    return scores.astype(np.float32), labels


@pytest.mark.parametrize("F", [30, 18])
@pytest.mark.parametrize("n", [1000, 8192, 9000])
def test_reconstruction_errors_match_jax(F, n):
    model, params = _jax_params(F)
    x = np.random.default_rng(n).normal(0, 1.5, (n, F)).astype(np.float32)
    want = j_eval.reconstruction_errors(model, params, x)
    got = t_eval.reconstruction_errors(AutoencoderSpec(input_dim=F),
                                       params_from_jax(params), x,
                                       device="cpu")
    assert got.dtype == np.float32 and got.shape == (n,)
    np.testing.assert_allclose(got, want, **ERR_TOL)


def test_reconstruction_errors_pads_only_past_one_chunk(monkeypatch):
    """The chunks' shapes: JAX's rule (pad the last chunk to the chunk
    size only when the set is larger than one chunk)."""
    seen = []
    real = t_eval.anomaly._recon_err

    def spy(module, params, x):
        seen.append(tuple(x.shape))
        return real(module, params, x)

    monkeypatch.setattr(t_eval.anomaly, "_recon_err", spy)
    _, params = _jax_params(18)
    sd = params_from_jax(params)
    spec = AutoencoderSpec(input_dim=18)
    t_eval.reconstruction_errors(spec, sd, np.zeros((50, 18), np.float32),
                                 batch_size=64, device="cpu")
    t_eval.reconstruction_errors(spec, sd, np.zeros((150, 18), np.float32),
                                 batch_size=64, device="cpu")
    assert seen == [(50, 18), (64, 18), (64, 18), (64, 18)]


@pytest.mark.parametrize("ties", [True, False])
def test_curves_auc_ap_match_jax_exactly(ties):
    scores, labels = _scores(ties=ties)
    for name in ("roc_curve", "precision_recall_curve"):
        for got, want in zip(getattr(t_eval, name)(scores, labels),
                             getattr(j_eval, name)(scores, labels)):
            np.testing.assert_array_equal(got, want, err_msg=name)
    fpr, tpr, _ = t_eval.roc_curve(scores, labels)
    assert t_eval.auc(fpr, tpr) == j_eval.auc(fpr, tpr)
    assert t_eval.average_precision(scores, labels) == \
        j_eval.average_precision(scores, labels)
    for thr in (0.5, 3.0, 5.0, 100.0):
        assert t_eval.confusion_at_threshold(scores, labels, thr) == \
            j_eval.confusion_at_threshold(scores, labels, thr)


def test_degenerate_labels_match_jax():
    scores = np.linspace(0, 1, 20).astype(np.float32)
    for labels in (np.zeros(20, int), np.ones(20, int)):
        assert t_eval.average_precision(scores, labels) == \
            j_eval.average_precision(scores, labels)
        for got, want in zip(t_eval.roc_curve(scores, labels),
                             j_eval.roc_curve(scores, labels)):
            np.testing.assert_array_equal(got, want)


def test_evaluate_detector_report_matches_jax():
    model, params = _jax_params(30)
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3000, 30)).astype(np.float32)
    labels = (rng.random(3000) < 0.05).astype(np.int32)
    x[labels == 1] += 4.0
    want = j_eval.evaluate_detector(model, params, x, labels, threshold=1.5)
    got = t_eval.evaluate_detector(AutoencoderSpec(input_dim=30),
                                   params_from_jax(params), x, labels,
                                   threshold=1.5, device="cpu")
    np.testing.assert_allclose(got.mean_error_normal, want.mean_error_normal,
                               **ERR_TOL)
    # the report from the same scores: exact
    scores = t_eval.reconstruction_errors(AutoencoderSpec(input_dim=30),
                                          params_from_jax(params), x,
                                          device="cpu")
    same = j_eval.evaluate_detector(model, params, x, labels, threshold=1.5,
                                    scores=scores)
    assert t_eval.evaluate_detector(None, None, x, labels, threshold=1.5,
                                    scores=scores).as_dict() == same.as_dict()
    assert got.summary().split()[0] == same.summary().split()[0] == "n=3000"


def test_write_report_files_are_byte_equal(tmp_path, monkeypatch):
    import matplotlib

    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    monkeypatch.setitem(matplotlib.rcParams, "svg.hashsalt", "iotml")
    scores, labels = _scores(n=1500, seed=3)
    rep = j_eval.evaluate_detector(None, None, None, labels, scores=scores)
    paths = {}
    for tag, mod in (("jax", j_report), ("port", t_report)):
        paths[tag] = mod.write_report(rep, scores, labels,
                                      str(tmp_path / tag))
    for kind in ("json", "svg"):
        with open(paths["jax"][kind], "rb") as a, \
                open(paths["port"][kind], "rb") as b:
            assert a.read() == b.read(), kind
    assert paths["port"]["uploaded"] is None


def test_downsample_matches_jax():
    xs = np.arange(1000.0)
    for n in (10, 256, 999, 1000):
        for got, want in zip(t_report._downsample(xs, xs * 2, n),
                             j_report._downsample(xs, xs * 2, n)):
            np.testing.assert_array_equal(got, want)


def test_reconstruction_errors_take_numpy_params():
    """Params as numpy arrays (a flax tree converted and left on the
    host) score the same as tensors."""
    _, params = _jax_params(18)
    sd = params_from_jax(params)
    x = np.random.default_rng(1).normal(size=(40, 18)).astype(np.float32)
    a = t_eval.reconstruction_errors(AutoencoderSpec(), sd, x, device="cpu")
    b = t_eval.reconstruction_errors(
        AutoencoderSpec(), {k: v.numpy() for k, v in sd.items()}, x,
        device="cpu")
    np.testing.assert_array_equal(a, b)
    assert torch.is_tensor(sd["encoder0.weight"])
