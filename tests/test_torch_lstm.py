"""The port's LSTM path (``iotml_torch.models.lstm``, the windowed
``SensorBatches``, the supervised ``Trainer`` and the windowed scorer)
against the JAX package's on the CPU.

Tolerances:
- windowed batches (windows, targets, counts, indices) and a parameter
  round trip through ``models.convert``: exact;
- the forward against flax: rtol = atol = 1e-5 (float32 sums in another
  order);
- every parameter's grad: rtol 1e-4 / atol 1e-6, the JAX suite's grad
  bound;
- ``fit_compiled(supervised=True)`` against JAX's scanned fit from the
  same params: losses rtol 2e-4 / atol 1e-6, params rtol 5e-3 / atol
  2e-5, the JAX suite's fit bounds;
- the windowed scorer: errors rtol 1e-5; payloads parsed as floats within
  atol 1e-6 (``np.array2string`` of two float32 forwards an ulp apart
  can differ in a last digit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.data.dataset import Batch as JBatch
from iotml.data.dataset import SensorBatches as JSensorBatches
from iotml.gen.simulator import FleetGenerator as JFleetGenerator
from iotml.gen.simulator import FleetScenario as JFleetScenario
from iotml.models.lstm import LSTMSeq2Seq as JLSTM
from iotml.serve import scorer as j_scorer
from iotml.stream.broker import Broker as JBroker
from iotml.stream.consumer import StreamConsumer as JStreamConsumer
from iotml.stream.producer import OutputSequence as JOutputSequence
from iotml.train import loop as j_loop
from iotml_torch.data.dataset import Batch, RowSource, SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.convert import (lstm_adam_from_optax,
                                        lstm_adam_to_optax,
                                        lstm_params_from_jax,
                                        lstm_params_to_jax)
from iotml_torch.models.lstm import GATES, LSTMSpec
from iotml_torch.serve import scorer as t_scorer
from iotml_torch.stream.broker import Broker
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train import loop as t_loop
from iotml_torch.train.checkpoint import CheckpointManager

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


def _fleets(num_cars=100, ticks=60):
    """The same fleet on the JAX broker, the port's broker and the port's
    row source (6,000 records: more than one 4,096-record poll)."""
    jb, tb = JBroker(), Broker()
    scen = dict(num_cars=num_cars, failure_rate=0.02)
    JFleetGenerator(JFleetScenario(**scen)).publish(jb, "T", n_ticks=ticks)
    FleetGenerator(FleetScenario(**scen)).publish(tb, "T", n_ticks=ticks)
    source = RowSource.from_fleet(FleetGenerator(FleetScenario(**scen)),
                                  ticks)
    return jb, tb, source


def _assert_same_windows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.n_valid, g.first_index) == (w.n_valid, w.first_index)
        assert g.x.dtype == w.x.dtype == np.float32
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        np.testing.assert_array_equal(g.mask, w.mask)


@pytest.mark.parametrize("kw", [
    {"window": 1, "batch_size": 64, "take": 15},             # the CLI's train
    {"window": 1, "batch_size": 64, "skip": 15, "take": 3},  # its predict
    {"window": 4, "batch_size": 64},                         # to the end
    {"window": 4, "batch_size": 100, "skip": 7, "take": 9},
    {"window": 4, "batch_size": 37, "pad_tail": False},
    {"window": 3, "batch_size": 50, "only_normal": True, "take": 40},
])
def test_windowed_batches_match_jax(kw):
    """Across chunk joints on both sides: JAX's polls cut at 700 rows,
    the port's at 4,096 (its broker) or wherever ``take`` cuts a row
    source's reads."""
    jb, tb, source = _fleets()
    want = list(JSensorBatches(JStreamConsumer(jb, ["T:0:0"]),
                               poll_chunk=700, **kw))
    for src in (StreamConsumer(tb, ["T:0:0"]), source):
        _assert_same_windows(list(SensorBatches(src, **kw)), want)


def test_windowed_batches_epochs_rewind_like_jax():
    jb, tb, _ = _fleets(ticks=20)
    want = JSensorBatches(JStreamConsumer(jb, ["T:0:0"]), window=2,
                          batch_size=64, take=10)
    got = SensorBatches(StreamConsumer(tb, ["T:0:0"]), window=2,
                        batch_size=64, take=10)
    for g, w in zip(got.epochs(3), want.epochs(3)):
        _assert_same_windows(list(g), list(w))


def _jax_model(T, look_back, seed=1, jitter=0.1):
    """A flax LSTM's params with every leaf moved off its init (biases too:
    a misplaced bias must show)."""
    model = JLSTM(features=18, look_back=look_back)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, T, 18)))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: np.asarray(a) + jitter * rng.normal(size=a.shape)
        .astype(np.float32), params)
    return model, params


def _x(B, T, seed=0):
    return np.random.default_rng(seed).normal(0, 0.6, (B, T, 18)) \
        .astype(np.float32)


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("look_back", [1, 3])
def test_forward_matches_flax(T, look_back):
    model, params = _jax_model(T, look_back)
    x = _x(7, T)
    want = np.asarray(model.apply({"params": params}, x))
    module = LSTMSpec(look_back=look_back).build("cpu")
    got = torch.func.functional_call(module, lstm_params_from_jax(params),
                                     (torch.from_numpy(x),))
    assert got.shape == (7, look_back, 18)
    np.testing.assert_allclose(got.detach().numpy(), want, **FWD_TOL)


@pytest.mark.parametrize("gate", ["f", "g", "o"])
def test_a_swapped_gate_fails_the_forward_check(gate):
    """The forward check sees a gate swapped with i (kernels and bias)."""
    model, params = _jax_model(4, 1)
    x = _x(7, 4)
    want = np.asarray(model.apply({"params": params}, x))
    sd = lstm_params_from_jax(params)
    for kind in ("i", "h"):
        for leaf in ("weight", "bias"):
            a, b = f"enc0.{kind}i.{leaf}", f"enc0.{kind}{gate}.{leaf}"
            if a in sd:
                sd[a], sd[b] = sd[b], sd[a]
    got = torch.func.functional_call(LSTMSpec().build("cpu"), sd,
                                     (torch.from_numpy(x),))
    assert not np.allclose(got.detach().numpy(), want, **FWD_TOL)


def test_the_cell_is_relu_not_tanh():
    """torch.nn.LSTM's tanh cell computes another function: the port's
    cell must not agree with it on the same weights."""
    model, params = _jax_model(4, 1)
    sd = lstm_params_from_jax(params)
    lstm = torch.nn.LSTM(18, 32, batch_first=True)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.cat([sd[f"enc0.i{g}.weight"]
                                           for g in GATES]))
        lstm.weight_hh_l0.copy_(torch.cat([sd[f"enc0.h{g}.weight"]
                                           for g in GATES]))
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.copy_(torch.cat([sd[f"enc0.h{g}.bias"]
                                         for g in GATES]))
    module = LSTMSpec().build("cpu")
    module.load_state_dict(sd)
    x = torch.from_numpy(_x(5, 4, seed=3))
    with torch.no_grad():
        ours = module.enc0(x)
        theirs = lstm(x)[0]
    assert not torch.allclose(ours, theirs, atol=1e-3)


def test_grads_match_jax():
    model, params = _jax_model(4, 1)
    x = _x(16, 4, seed=5)
    y = _x(16, 1, seed=6)
    mask = np.ones(16, np.float32)
    mask[11:] = 0.0
    j_loss = j_loop.make_loss_fn(model, supervised=True)
    (jl, _), jg = jax.value_and_grad(j_loss, has_aux=True)(params, x, y, mask)
    module = LSTMSpec().build("cpu")
    sd = {k: v.requires_grad_(True)
          for k, v in lstm_params_from_jax(params).items()}
    tl, _ = t_loop.make_loss_fn(module, supervised=True)(
        sd, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    grads = torch.autograd.grad(tl, list(sd.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    want = lstm_params_from_jax(jax.tree.map(np.asarray, jg))
    for (k, _), g in zip(sd.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k,
                                   **GRAD_TOL)


def test_params_and_adam_round_trip_exactly(tmp_path):
    model, params = _jax_model(1, 1)
    sd = lstm_params_from_jax(params)
    assert set(sd) == set(LSTMSpec().build("cpu").state_dict())
    back = lstm_params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params))
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))
    # a tree keyed enc0 .. dec1 ({name: {"cell": ...}}) reads the same
    named = {"head": params["head"],
             **{name: {"cell": params[f"OptimizedLSTMCell_{i}"]}
                for i, name in enumerate(("enc0", "enc1", "dec0", "dec1"))}}
    for k, v in lstm_params_from_jax(named).items():
        assert torch.equal(v, sd[k])
    # Adam moments, and the npz + JSON checkpoint of the whole state
    state = t_loop.TrainState(step=7, params=sd,
                              opt_state=lstm_adam_from_optax(
                                  np.int32(7), params, params))
    count, mu, nu = lstm_adam_to_optax(state.opt_state)
    assert int(count) == 7
    jax.tree.map(np.testing.assert_array_equal, mu, back)
    path = CheckpointManager(str(tmp_path)).save(state, cursors=[("T", 0, 9)])
    got = CheckpointManager.load_dir(path)
    assert got["step"] == 7 and got["cursors"] == [("T", 0, 9)]
    for k in sd:
        assert torch.equal(got["params"][k], sd[k])
        assert torch.equal(got["opt_state"].nu[k], sd[k])


def _fit_batches(S=5, B=16, T=4, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in range(S):
        x = rng.normal(0, 0.6, (B, T, 18)).astype(np.float32)
        y = rng.normal(0, 0.6, (B, 1, 18)).astype(np.float32)
        n = B if s < S - 1 else B // 2
        x[n:], y[n:] = 0.0, 0.0
        out.append((x, y, n, s * B))
    return out


def test_fit_compiled_supervised_matches_jax_scanned_fit(monkeypatch):
    data = _fit_batches()
    jmodel = JLSTM(features=18, look_back=1)
    jtr = j_loop.Trainer(jmodel, supervised=True)
    jtr._ensure_state(data[0][0])
    adam = jtr.state.opt_state[0]
    params = jax.tree.map(np.asarray, jtr.state.params)
    init = t_loop.TrainState(
        step=0, params=lstm_params_from_jax(params),
        opt_state=lstm_adam_from_optax(adam.count,
                                       jax.tree.map(np.asarray, adam.mu),
                                       jax.tree.map(np.asarray, adam.nu)))
    j_hist = jtr.fit_compiled([JBatch(x=x, n_valid=n, first_index=i, y=y)
                               for x, y, n, i in data], epochs=3)
    ttr = t_loop.Trainer(LSTMSpec(), supervised=True, device="cpu")
    ttr.state = init
    from iotml_torch.ops import fused_train

    def no_kernel(*a, **kw):
        raise AssertionError("a supervised fit reached the fused kernel")

    monkeypatch.setattr(fused_train, "fused_fit", no_kernel)
    t_hist = ttr.fit_compiled([Batch(x=x, n_valid=n, first_index=i, y=y)
                               for x, y, n, i in data], epochs=3)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], **LOSS_TOL)
    np.testing.assert_allclose(t_hist["accuracy"], j_hist["accuracy"],
                               **LOSS_TOL)
    assert t_hist["records"] == j_hist["records"] == [72] * 3
    assert ttr.state.step == int(jtr.state.step) == 15
    want = lstm_params_from_jax(jax.tree.map(np.asarray, jtr.state.params))
    for k, v in ttr.state.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   **PARAM_TOL)
    # predict: the eval step is the forward in both modes
    out = ttr.predict([Batch(x=data[0][0], n_valid=16, first_index=0)])
    assert out[0].shape == (16, 1, 18)


def _parse(msg):
    text = msg.decode() if isinstance(msg, bytes) else msg
    parts = text.split("|")
    return (np.array(parts[0].replace("[", " ").replace("]", " ").split(),
                     np.float64), parts[1:])


@pytest.mark.parametrize("T,threshold", [(1, None), (1, 0.2), (4, 0.2)])
def test_windowed_scorer_matches_jax(T, threshold, monkeypatch):
    """Errors are (prediction − input window)² averaged over every
    non-batch axis, as JAX scores them; payloads are the [1, F] blocks'
    ``np.array2string``."""
    jb, _, source = _fleets(ticks=30)
    model, params = _jax_model(T, 1, jitter=0.05)
    kw = dict(window=T, batch_size=64, skip=2, take=30)
    seen_j = []
    real_eval = j_loop.make_eval_step

    def spy_eval(m, supervised=False):
        ev = real_eval(m, supervised)

        def run(p, x):
            out = ev(p, x)
            seen_j.append((np.asarray(x), np.asarray(out)))
            return out

        return run

    monkeypatch.setattr(j_scorer, "make_eval_step", spy_eval)
    jb.create_topic("P")
    jsc = j_scorer.StreamScorer(model, params, JSensorBatches(
        JStreamConsumer(jb, ["T:0:0"]), **kw),
        JOutputSequence(jb, "P", partition=0), threshold=threshold)
    jsc.max_super_batches = 8
    assert jsc.score_available() == 30 * 64
    want_msgs = [m.value for m in jb.fetch("P", 0, 0, 1 << 20)]

    seen_t = []
    real_rows = t_scorer.row_errors

    def spy_rows(preds, xs, mask=None):
        seen_t.append(real_rows(preds, xs, mask))
        return seen_t[-1]

    monkeypatch.setattr(t_scorer, "row_errors", spy_rows)
    out = OutputSequence()
    tsc = t_scorer.StreamScorer(LSTMSpec(), lstm_params_from_jax(params),
                                SensorBatches(source, **kw), out,
                                threshold=threshold, device="cpu")
    tsc.max_super_batches = 8
    assert tsc.score_available() == 30 * 64
    assert [i for i, _ in out.published] == list(range(30 * 64))
    got_msgs = [m for _, m in out.published]

    want_err = np.concatenate([
        np.square(p.reshape((-1,) + p.shape[1:])[:len(x)] - x)
        .mean(axis=(1, 2)) for x, p in seen_j])
    got_err = np.concatenate([e.reshape(-1) for e in seen_t])
    np.testing.assert_allclose(got_err, want_err[:len(got_err)], rtol=1e-5)
    assert len(got_msgs) == len(want_msgs) == 30 * 64
    for g, w in zip(got_msgs, want_msgs):
        gv, gs = _parse(g)
        wv, ws = _parse(w)
        assert (g.decode() if isinstance(g, bytes) else g).startswith("[[")
        assert gv.shape == (18,)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
        if threshold is not None:
            assert gs[0] == ws[0]
            np.testing.assert_allclose(float(gs[1]), float(ws[1]),
                                       rtol=0, atol=1e-6)
