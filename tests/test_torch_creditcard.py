"""The port's creditcard job (``iotml_torch.data.creditcard``,
``iotml_torch.cli.creditcard``) against the JAX package's on the CPU.

Tolerances:
- the synthetic CSV's bytes, the produced messages and offsets, the
  decoded columns, the scaler's moments and transforms and every batch
  (rows, labels, counts, padding): exact (the same numpy code);
- the job at JAX's own test size (``synth:600 --epochs 8``) from the same
  initial params: losses rtol 2e-4 / atol 1e-6 and params rtol 5e-3 /
  atol 2e-5, the JAX suite's fit bounds (the port's plain fit against
  JAX's Pallas kernel in interpret mode); the report from the port's
  scores equal to JAX's functions applied to those scores; AUC > 0.9 as
  the JAX suite asserts.
"""

import json

import jax
import numpy as np
import pytest

from iotml.cli import creditcard as j_cli
from iotml.data import creditcard as j_cc
from iotml import evaluate as j_eval
from iotml.models.autoencoder import DenseAutoencoder as JDenseAutoencoder
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.train import loop as j_loop
from iotml_torch.cli import creditcard as t_cli
from iotml_torch.data import creditcard as t_cc
from iotml_torch.evaluate import anomaly as t_anomaly
from iotml_torch.models.autoencoder import PARAM_NAMES
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.train import loop as t_loop

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cc") / "cc.csv")
    frauds = t_cc.synth_creditcard_csv(path, n_rows=500, fraud_rate=0.1,
                                       seed=4)
    return path, frauds


def test_synth_csv_bytes_match_jax(tmp_path, csv_path):
    path, frauds = csv_path
    want = str(tmp_path / "j.csv")
    assert j_cc.synth_creditcard_csv(want, n_rows=500, fraud_rate=0.1,
                                     seed=4) == frauds > 0
    with open(path, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()
    assert t_cc.COLUMNS == j_cc.COLUMNS and \
        t_cc.SCALED_COLUMNS == j_cc.SCALED_COLUMNS


@pytest.mark.parametrize("limit", [None, 123])
def test_produce_csv_lines_match_jax(csv_path, limit):
    path, _ = csv_path
    tb, jb = Broker(), JBroker()
    n = t_cc.produce_csv_lines(tb, "cc", path, limit=limit)
    assert n == j_cc.produce_csv_lines(jb, "cc", path, limit=limit) == \
        (limit or 500)
    assert tb.end_offset("cc", 0) == jb.end_offset("cc", 0) == n
    got = [(m.offset, m.value) for m in tb.fetch("cc", 0, 0, n + 1)]
    want = [(m.offset, m.value) for m in jb.fetch("cc", 0, 0, n + 1)]
    assert got == want


def test_decode_csv_batch_matches_jax(csv_path):
    path, _ = csv_path
    with open(path) as fh:
        lines = fh.read().splitlines()[1:]
    values = [ln.encode() if i % 2 else ln for i, ln in enumerate(lines)]
    for got, want in zip(t_cc.decode_csv_batch(values),
                         j_cc.decode_csv_batch(values)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_standard_scaler_matches_jax():
    rng = np.random.default_rng(2)
    chunks = [rng.normal(3.0, 2.0, (n, 30)) for n in (7, 1, 0, 40, 13)]
    for cols in (None, t_cc.SCALED_COLUMNS):
        t, j = t_cc.StandardScaler(cols), j_cc.StandardScaler(cols)
        for c in chunks:
            t.partial_fit(c)
            j.partial_fit(c)
            assert t.n == j.n
            np.testing.assert_array_equal(t.mean, j.mean)
            np.testing.assert_array_equal(t.m2, j.m2)
            if t.n:
                np.testing.assert_array_equal(t.std, j.std)
                np.testing.assert_array_equal(t.transform(chunks[0]),
                                              j.transform(chunks[0]))
        n = t.n
        t.freeze().partial_fit(chunks[3])
        j.freeze().partial_fit(chunks[3])
        assert t.n == j.n == n  # frozen: transform-only
        np.testing.assert_array_equal(
            t_cc.StandardScaler(cols).fit_transform(chunks[3]),
            j_cc.StandardScaler(cols).fit_transform(chunks[3]))


@pytest.mark.parametrize("only_normal", [False, True])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("pad_tail", [True, False])
def test_creditcard_batches_match_jax(csv_path, only_normal, scale, pad_tail):
    path, _ = csv_path
    tb, jb = Broker(), JBroker()
    t_cc.produce_csv_lines(tb, "cc", path)
    j_cc.produce_csv_lines(jb, "cc", path)
    ts = t_cc.StandardScaler(t_cc.SCALED_COLUMNS) if scale else None
    js = j_cc.StandardScaler(j_cc.SCALED_COLUMNS) if scale else None
    got_it = t_cc.CreditcardBatches(
        StreamConsumer(tb, ["cc:0:0"], group="g"), batch_size=32,
        only_normal=only_normal, scaler=ts, pad_tail=pad_tail)
    want_it = j_cc.CreditcardBatches(
        JStreamConsumer(jb, ["cc:0:0"], group="g"), batch_size=32,
        only_normal=only_normal, scaler=js, pad_tail=pad_tail)
    for got_ep, want_ep in zip(got_it.epochs(2), want_it.epochs(2)):
        got, want = list(got_ep), list(want_ep)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
            np.testing.assert_array_equal(g.x, w.x)
            np.testing.assert_array_equal(g.labels, w.labels)
            assert g.x.shape == (32, 30)
        if pad_tail and got[-1].n_valid < 32:
            assert (got[-1].x[got[-1].n_valid:] == 0).all()
    if scale:
        np.testing.assert_array_equal(ts.mean, js.mean)


@pytest.fixture(scope="module")
def jobs():
    """JAX's job and the port's, ``synth:600 --epochs 8``, the port's
    trainer started from JAX's initial params."""
    j_trainers, t_trainers, t_scores = [], [], []

    class JTrainer(j_loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            j_trainers.append(self)

    init_model = JDenseAutoencoder(input_dim=30)
    init = j_loop.TrainState.create(init_model, jax.random.PRNGKey(0),
                                    np.zeros((1, 30), np.float32))

    class Carried(t_loop.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            t_trainers.append(self)

        def _ensure_state(self):
            if self.state is None:
                adam = init.opt_state[0]
                self.state = t_loop.TrainState(
                    step=0,
                    params=params_from_jax(jax.tree.map(np.asarray,
                                                        init.params)),
                    opt_state=adam_from_optax(
                        adam.count, jax.tree.map(np.asarray, adam.mu),
                        jax.tree.map(np.asarray, adam.nu)))
            super()._ensure_state()

    real_errors = t_anomaly.reconstruction_errors

    def spy_errors(*a, **kw):
        t_scores.append(real_errors(*a, **kw))
        return t_scores[-1]

    argv = ["synth:600", "--epochs", "8"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_loop, "Trainer", JTrainer)
        want = j_cli.run(argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_cli, "Trainer", Carried)
        mp.setattr(t_anomaly, "reconstruction_errors", spy_errors)
        got = t_cli.run(argv, device="cpu")
    return {"want": want, "got": got, "j": j_trainers[0],
            "t": t_trainers[0], "scores": t_scores[0]}


def test_job_fit_matches_jax(jobs):
    got, want = jobs["got"], jobs["want"]
    assert got["records"] == want["records"] == 600
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               **LOSS_TOL)
    assert jobs["t"].state.step == int(jobs["j"].state.step) > 8
    want_p = params_from_jax(jax.tree.map(np.asarray,
                                          jobs["j"].state.params))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(jobs["t"].state.params[k].numpy(),
                                   want_p[k].numpy(), err_msg=k,
                                   **PARAM_TOL)


def test_job_report_is_jax_functions_of_the_port_scores(jobs):
    """The port's report is JAX's evaluation of the port's scores, and the
    detector separates the synthetic frauds as the JAX suite asks."""
    got = jobs["got"]["report"]
    scores = jobs["scores"]
    assert got["n"] == len(scores) == 600
    labels = _eval_labels()
    want = j_eval.evaluate_detector(None, None, None, labels,
                                    threshold=5.0, scores=scores)
    assert got == want.as_dict()
    assert got["roc_auc"] > 0.9
    assert got["mean_error_anomaly"] > got["mean_error_normal"]
    assert abs(got["roc_auc"] - jobs["want"]["report"]["roc_auc"]) < 1e-2


def _eval_labels():
    """The eval stream's labels: the job's synthetic file, decoded."""
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".csv")
    os.close(fd)
    try:
        j_cc.synth_creditcard_csv(path, n_rows=600)
        with open(path) as fh:
            return j_cc.decode_csv_batch(fh.read().splitlines()[1:])[1]
    finally:
        os.unlink(path)


def test_job_prints_its_result(capsys):
    out = t_cli.run(["synth:64", "--epochs", "1", "--no-scale"],
                    device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(out))
    assert printed["records"] == 64 and printed["report"]["n"] == 64


def test_job_reads_a_csv_file(tmp_path):
    path = str(tmp_path / "creditcard.csv")
    t_cc.synth_creditcard_csv(path, n_rows=100, seed=1)
    out = t_cli.run([path, "--epochs", "1"], device="cpu")
    assert out["records"] == 100
