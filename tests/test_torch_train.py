"""The port's training path held against the JAX package.

Both sides start from the same params (JAX's, carried across as numpy)
and see the same batches (numpy from a seed).  Tolerances are the JAX
suite's own (tests/test_fused_train.py), because the two frameworks sum
float32 products in different orders and Adam carries the difference
forward: losses and accuracies rtol 2e-4 / atol 1e-6; params rtol 5e-3 /
atol 2e-5; resume continuity rtol 1e-4 / atol 1e-7.  One Adam step and
the loss/accuracy functions have no such drift: rtol 1e-6.

On the CPU ``fused_fit`` runs the plain version; the JAX side runs the
Pallas kernel in interpret mode.  The kernel itself is checked on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iotml.models.autoencoder import DenseAutoencoder as JDenseAutoencoder
from iotml.ops.fused_train import fused_fit as j_fused_fit
from iotml.train import loop as j_loop
from iotml_torch.data.dataset import Batch
from iotml_torch.models.autoencoder import (CAR_AUTOENCODER, PARAM_NAMES,
                                            AutoencoderSpec)
from iotml_torch.models.convert import adam_from_optax, params_from_jax
from iotml_torch.ops import _build, fused_train
from iotml_torch.train import loop as t_loop
from iotml_torch.train.optim import Adam, AdamState

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


def _data(S=6, B=32, F=18, seed=0, ragged=True, fractional=False):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (S, B, F)).astype(np.float32)
    xs[:, :, ::5] = 0.0  # zeroed columns make Keras accuracy non-zero
    masks = np.ones((S, B), np.float32)
    if ragged:
        masks[-1, B // 2:] = 0.0
        xs[-1, B // 2:] = 0.0
    if fractional:
        masks = (masks * rng.uniform(0.25, 1.0, masks.shape)).astype(
            np.float32)
    return xs, masks


def _jax_state(F=18, activity_l1=1e-7, seed=0):
    model = JDenseAutoencoder(input_dim=F, activity_l1=activity_l1)
    return model, j_loop.TrainState.create(
        model, jax.random.PRNGKey(seed), np.zeros((1, F), np.float32))


def _carry(jstate) -> t_loop.TrainState:
    """A JAX TrainState, whole, as the port's (read before donation)."""
    adam = jstate.opt_state[0]
    return t_loop.TrainState(
        step=int(jstate.step),
        params=params_from_jax(jax.tree.map(np.asarray, jstate.params)),
        opt_state=adam_from_optax(adam.count,
                                  jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu)))


def _assert_params_close(t_params, j_tree, **tol):
    got = params_from_jax(jax.tree.map(np.asarray, j_tree))
    for k in PARAM_NAMES:
        np.testing.assert_allclose(t_params[k].detach().numpy(),
                                   got[k].numpy(), err_msg=k, **tol)


# ---------------------------------------------------------- loss, accuracy
def test_masked_mse_and_keras_accuracy_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(-1, 1, (16, 18)).astype(np.float32)
    target = pred.copy()
    target[:, 3:] = rng.uniform(-1, 1, (16, 15))  # 3 equal columns
    for mask in (np.ones(16, np.float32),
                 np.r_[np.ones(9), np.zeros(7)].astype(np.float32),
                 rng.uniform(0.25, 1.0, 16).astype(np.float32),
                 np.zeros(16, np.float32)):
        args_t = [torch.from_numpy(a) for a in (pred, target, mask)]
        for t_fn, j_fn in ((t_loop._masked_mse, j_loop._masked_mse),
                           (t_loop._keras_accuracy, j_loop._keras_accuracy)):
            np.testing.assert_allclose(float(t_fn(*args_t)),
                                       float(j_fn(pred, target, mask)),
                                       rtol=1e-6, atol=0)


# -------------------------------------------------------------------- Adam
@pytest.mark.parametrize("steps,param_atol", [(1, 0.0), (10, 1e-6)])
def test_adam_steps_match_optax(steps, param_atol):
    """One step: rtol 1e-6.  Over more steps b^t itself differs by an ulp
    between float32 pow implementations (XLA's differs between its own
    eager and jitted paths too), and 1 - b2^t ≈ 1e-3·t cancels, so an
    update may move ~1e-4 relative: params get atol 1e-6 over 10 steps
    of ~1e-3; the moments, which never see b^t, stay at rtol 1e-6."""
    rng = np.random.default_rng(2)
    _, jstate = _jax_state()
    tree = jax.tree.map(np.asarray, jstate.params)
    opt = optax.adam(1e-3)
    j_params, j_opt = tree, opt.init(tree)
    t_params = params_from_jax(tree)
    adam = Adam(1e-3)
    t_opt = adam.init(t_params)
    for _ in range(steps):
        grads = jax.tree.map(
            lambda a: rng.normal(0, 0.1, a.shape).astype(np.float32), tree)
        updates, j_opt = opt.update(grads, j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_params, t_opt = adam.update(params_from_jax(grads), t_opt, t_params)
    assert t_opt.count == int(j_opt[0].count) == steps
    _assert_params_close(t_params, j_params, rtol=1e-6, atol=param_atol)
    for t_tree, j_tree in ((t_opt.mu, j_opt[0].mu), (t_opt.nu, j_opt[0].nu)):
        _assert_params_close(t_tree, j_tree, rtol=1e-6, atol=0)


# -------------------------------------------------------- autograd loop
@pytest.mark.parametrize("F", [18, 30])
def test_autograd_step_loop_matches_jax_scanned_fit(F):
    xs, masks = _data(F=F)
    jmodel, jstate = _jax_state(F)
    carried = _carry(jstate)
    scanned = j_loop.make_scanned_fit(jmodel, jstate.tx)
    j_out, (j_loss, j_acc) = scanned(jstate, jnp.asarray(xs), jnp.asarray(xs),
                                     jnp.asarray(masks), 4)
    model = AutoencoderSpec(input_dim=F).build("cpu")
    fit = t_loop.make_scanned_fit(model, Adam(1e-3))
    x_t, m_t = torch.from_numpy(xs), torch.from_numpy(masks)
    t_out, (t_loss, t_acc) = fit(carried, x_t, x_t, m_t, 4)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), **LOSS_TOL)
    assert float(np.asarray(j_acc)[0]) > 0
    _assert_params_close(t_out.params, j_out.params, **PARAM_TOL)
    assert t_out.step == int(j_out.step) == 24
    assert t_out.opt_state.count == 24


# ------------------------------------------------------- fused, plain version
@pytest.mark.parametrize("F", [18, 30])
@pytest.mark.parametrize("fractional", [False, True])
def test_fused_reference_matches_jax_fused(F, fractional):
    xs, masks = _data(F=F, S=4, fractional=fractional, seed=F)
    _, jstate = _jax_state(F)
    carried = _carry(jstate)
    j_out, j_loss, j_acc = j_fused_fit(jstate, xs, masks, epochs=3)
    t_out, t_loss, t_acc = fused_train.fused_fit(
        carried, torch.from_numpy(xs), torch.from_numpy(masks), 3)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(t_acc.numpy(), np.asarray(j_acc), **LOSS_TOL)
    _assert_params_close(t_out.params, j_out.params, **PARAM_TOL)
    adam = j_out.opt_state[0]
    _assert_params_close(t_out.opt_state.mu, adam.mu, **PARAM_TOL)
    _assert_params_close(t_out.opt_state.nu, adam.nu, **PARAM_TOL)
    assert t_out.step == int(j_out.step) == 12
    assert t_out.opt_state.count == int(adam.count) == 12


def test_fused_reference_resumes_like_jax():
    """2 + 2 epochs == 4: Adam's count and bias correction continue."""
    xs, masks = _data(ragged=False)
    x_t, m_t = torch.from_numpy(xs), torch.from_numpy(masks)
    _, jstate = _jax_state()
    start = _carry(jstate)
    once, l_once, _ = fused_train.fused_fit(start, x_t, m_t, 4)
    half, l_a, _ = fused_train.fused_fit(start, x_t, m_t, 2)
    twice, l_b, _ = fused_train.fused_fit(half, x_t, m_t, 2)
    np.testing.assert_allclose(torch.cat([l_a, l_b]).numpy(), l_once.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(twice.params["encoder0.weight"].numpy(),
                               once.params["encoder0.weight"].numpy(),
                               rtol=1e-3, atol=1e-6)
    _, j_once, _ = j_fused_fit(jstate, xs, masks, epochs=4)
    np.testing.assert_allclose(l_once.numpy(), np.asarray(j_once), **LOSS_TOL)


def test_fused_respects_custom_activity_l1():
    """Trainer forwards the model's activity_l1 into the fused fit."""
    xs, masks = _data(ragged=False)
    jmodel, jstate = _jax_state(activity_l1=1e-1)
    carried = _carry(jstate)
    scanned = j_loop.make_scanned_fit(jmodel, jstate.tx)
    _, (j_loss, _) = scanned(jstate, jnp.asarray(xs), jnp.asarray(xs),
                             jnp.asarray(masks), 2)
    tr = t_loop.Trainer(AutoencoderSpec(input_dim=18, activity_l1=1e-1),
                        device="cpu")
    tr.state = carried
    bs = [Batch(x=xs[i], n_valid=xs.shape[1], first_index=i)
          for i in range(xs.shape[0])]
    h = tr.fit_compiled(bs, epochs=2, fused="always")
    np.testing.assert_allclose(h["loss"], np.asarray(j_loss), **LOSS_TOL)


# ------------------------------------------------------- the fused= contract
def _batches(xs, masks=None):
    return [Batch(x=xs[i], n_valid=int(masks[i].sum()) if masks is not None
                  else xs.shape[1], first_index=i * xs.shape[1])
            for i in range(xs.shape[0])]


def _counting_fused(monkeypatch):
    calls = []
    real = fused_train.fused_fit

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(fused_train, "fused_fit", spy)
    return calls


def test_fit_compiled_auto_takes_fused_and_matches_never(monkeypatch):
    xs, masks = _data(S=5)
    calls = _counting_fused(monkeypatch)
    h_auto = t_loop.Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(
        _batches(xs, masks), epochs=3)
    assert len(calls) == 1
    h_never = t_loop.Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(
        _batches(xs, masks), epochs=3, fused="never")
    assert len(calls) == 1
    np.testing.assert_allclose(h_auto["loss"], h_never["loss"], **LOSS_TOL)
    np.testing.assert_allclose(h_auto["accuracy"], h_never["accuracy"],
                               **LOSS_TOL)
    assert h_auto["records"] == h_never["records"] == [5 * 32 - 16] * 3
    assert h_auto["loss"][-1] < h_auto["loss"][0]
    for h in (h_auto, h_never):
        assert h["host_pipeline_s"] >= 0 and h["device_compute_s"] > 0


def test_fit_compiled_matches_jax_trainer():
    """Same slice, same initial params: the port's Trainer (fused, plain
    version) against the JAX Trainer (fused, interpret mode)."""
    xs, masks = _data(S=4)
    jtr = j_loop.Trainer(JDenseAutoencoder(input_dim=18))
    from iotml.data.dataset import Batch as JBatch
    jbs = [JBatch(x=b.x, n_valid=b.n_valid, first_index=b.first_index)
           for b in _batches(xs, masks)]
    jtr._ensure_state(xs[0])
    ttr = t_loop.Trainer(CAR_AUTOENCODER, device="cpu")
    ttr.state = _carry(jtr.state)
    j_hist = jtr.fit_compiled(jbs, epochs=2)
    t_hist = ttr.fit_compiled(_batches(xs, masks), epochs=2)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], **LOSS_TOL)
    np.testing.assert_allclose(t_hist["accuracy"], j_hist["accuracy"],
                               **LOSS_TOL)
    assert t_hist["records"] == j_hist["records"]
    _assert_params_close(ttr.state.params, jtr.state.params, **PARAM_TOL)


def test_fused_always_raises_when_unsupported():
    xs, _ = _data(S=2, ragged=False)
    custom = t_loop.Trainer(CAR_AUTOENCODER, tx=Adam(1e-3), device="cpu")
    with pytest.raises(ValueError):
        custom.fit_compiled(_batches(xs), epochs=1, fused="always")
    supervised = t_loop.Trainer(CAR_AUTOENCODER, supervised=True,
                                device="cpu")
    with pytest.raises(ValueError):
        supervised.fit_compiled(_batches(xs), epochs=1, fused="always")
    with pytest.raises(ValueError):
        custom.fit_compiled(_batches(xs), epochs=1, fused="sometimes")
    # a caller-supplied optimizer still trains, through the step loop
    assert len(custom.fit_compiled(_batches(xs), epochs=1)["loss"]) == 1


def test_auto_takes_step_loop_when_a_step_exceeds_shared_memory(monkeypatch):
    xs, _ = _data(S=3, ragged=False)
    tr = t_loop.Trainer(CAR_AUTOENCODER, device="cpu")
    monkeypatch.setattr(fused_train, "fused_fit",
                        mock.Mock(side_effect=AssertionError("fused used")))
    monkeypatch.setattr(fused_train, "fits", lambda params, B, device: False)
    h = tr.fit_compiled(_batches(xs), epochs=1)
    assert len(h["loss"]) == 1
    with pytest.raises(ValueError):
        tr.fit_compiled(_batches(xs), epochs=1, fused="always")


def test_supported_rejects_other_contracts():
    st = t_loop.TrainState.create(CAR_AUTOENCODER.build("cpu"), Adam())
    assert fused_train.supported(st, supervised=False)
    assert not fused_train.supported(st, supervised=True)
    assert not fused_train.supported(
        t_loop.TrainState(step=0, params=st.params, opt_state=None), False)
    partial = {k: v for k, v in st.params.items() if k != "decoder1.bias"}
    assert not fused_train.supported(
        t_loop.TrainState(step=0, params=partial,
                          opt_state=AdamState(0, partial, partial)), False)
    assert not fused_train.supported(object(), False)


def test_shared_memory_gate(monkeypatch):
    """The footprint is the kernel's to know (tests/test_torch_cuda.py
    checks it on the card); the plain version, which CPU tensors take,
    has no shared-memory limit and needs no built kernel."""
    monkeypatch.setattr(_build, "load", mock.Mock(
        side_effect=AssertionError("kernel library loaded")))
    st = t_loop.TrainState.create(CAR_AUTOENCODER.build("cpu"), Adam())
    assert fused_train.fits(st.params, 100, "cpu")
    assert fused_train.fits(st.params, 100_000, torch.device("cpu"))


def test_fused_fit_never_runs_the_plain_version_off_cpu(monkeypatch):
    """Only CPU tensors take the plain version; any other device launches
    the kernel or raises."""
    monkeypatch.setattr(fused_train, "fused_fit_reference",
                        mock.Mock(side_effect=AssertionError("plain used")))
    st = t_loop.TrainState.create(CAR_AUTOENCODER.build("cpu"), Adam())
    xs = torch.zeros((2, 8, 18), device="meta")
    masks = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_train.fused_fit(st, xs, masks, 1)


@pytest.mark.parametrize("B, F", [(100, 18), (1, 18), (128, 18), (256, 18),
                                  (100, 30), (1, 30), (128, 30), (256, 30)])
def test_fit_design_takes_rows_at_the_main_path_shapes(B, F):
    """The cardata (F=18) and creditcard (F=30) autoencoders at batches
    of 1..256: a thread per row."""
    assert fused_train.fit_design(B, F, 14, 7) == "rows"


@pytest.mark.parametrize("B, F, E, H", [
    (257, 18, 14, 7), (300, 18, 14, 7), (0, 18, 14, 7), (300, 30, 14, 7),
    (100, 18, 16, 7), (100, 18, 14, 8), (100, 12, 14, 7), (64, 29, 14, 7)])
def test_fit_design_takes_elements_elsewhere(B, F, E, H):
    assert fused_train.fit_design(B, F, E, H) == "elements"


def test_fused_fit_checks_the_design_on_the_cpu(monkeypatch):
    """A design is checked before the device is looked at; on the CPU
    either one runs the plain version and counts no launch."""
    monkeypatch.setattr(_build, "load", mock.Mock(
        side_effect=AssertionError("kernel library loaded")))
    st = t_loop.TrainState.create(CAR_AUTOENCODER.build("cpu"), Adam())
    xs, masks = _data(S=2, B=8)
    x_t, m_t = torch.from_numpy(xs), torch.from_numpy(masks)
    before = (fused_train.fused_fit.launches,
              dict(fused_train.fused_fit.launches_by_design))
    auto = fused_train.fused_fit(st, x_t, m_t, 1)
    for design in fused_train.DESIGNS:
        out = fused_train.fused_fit(st, x_t, m_t, 1, design=design)
        assert torch.equal(out[1], auto[1])
    assert (fused_train.fused_fit.launches,
            fused_train.fused_fit.launches_by_design) == before
    with pytest.raises(ValueError, match="design must be one of"):
        fused_train.fused_fit(st, x_t, m_t, 1, design="tiles")
    wide = torch.zeros((1, 300, 18))
    with pytest.raises(ValueError, match="rows design does not take"):
        fused_train.fused_fit(st, wide, torch.ones((1, 300)), 1,
                              design="rows")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    assert _build.library_path("fused_train").name.startswith(
        "libfused_train-")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("fused_train")
    assert not (tmp_path / "lock").exists()


# ---------------------------------------------------------- Trainer surface
def test_fit_step_loop_matches_fit_compiled():
    xs, masks = _data(S=3)
    h_loop = t_loop.Trainer(CAR_AUTOENCODER, device="cpu").fit(
        _batches(xs, masks), epochs=2)
    h_comp = t_loop.Trainer(CAR_AUTOENCODER, device="cpu").fit_compiled(
        _batches(xs, masks), epochs=2, fused="never")
    np.testing.assert_allclose(h_loop["loss"], h_comp["loss"], rtol=1e-6)
    assert h_loop["records"] == h_comp["records"]


def test_fit_delegates_to_fit_compiled_for_cached_batches():
    from iotml_torch.data.dataset import RowSource, SensorBatches
    from iotml_torch.gen.simulator import FleetGenerator, FleetScenario

    src = RowSource.from_fleet(FleetGenerator(FleetScenario(num_cars=20)), 10)
    batches = SensorBatches(src, batch_size=50, only_normal=True, cache=True)
    tr = t_loop.Trainer(CAR_AUTOENCODER, device="cpu")
    with mock.patch.object(tr, "fit_compiled",
                           wraps=tr.fit_compiled) as spy:
        h = tr.fit(batches, epochs=2)
    spy.assert_called_once()
    assert len(h["loss"]) == 2 and "device_compute_s" in h


def test_predict_matches_jax_predict():
    xs, masks = _data(S=2)
    jtr = j_loop.Trainer(JDenseAutoencoder(input_dim=18))
    jtr._ensure_state(xs[0])
    ttr = t_loop.Trainer(CAR_AUTOENCODER, device="cpu")
    ttr.state = _carry(jtr.state)
    from iotml.data.dataset import Batch as JBatch
    seen = []

    class Callback:
        def on_predict_batch_end(self, b, out):
            seen.append((b.first_index, tuple(out.shape)))

    got = ttr.predict(_batches(xs, masks), callbacks=[Callback()])
    want = jtr.predict([JBatch(x=b.x, n_valid=b.n_valid,
                               first_index=b.first_index)
                        for b in _batches(xs, masks)])
    assert seen == [(0, (32, 18)), (32, (32, 18))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_trainer_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t_loop.Trainer(CAR_AUTOENCODER)
