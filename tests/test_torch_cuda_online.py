"""Card-only checks of the online learner's device work: the fused fit
kernel (B1) at the refit's shapes, carrying the injectable-rate Adam's
inner state and a boosted rate, against its plain version; the
injectable Adam's step and a refit on ``cuda`` against the CPU.  Every
test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_online.py

Tolerances are the JAX suite's fused-vs-scanned bounds
(tests/test_fused_train.py): losses rtol 2e-4 / atol 1e-6, params and
moments rtol 5e-3 / atol 2e-5.
"""

import numpy as np
import pytest
import torch

from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES
from iotml_torch.online.learner import AdaptationPolicy, OnlineLearner
from iotml_torch.ops import fused_train
from iotml_torch.stream.broker import Broker
from iotml_torch.train.loop import Trainer, TrainState, make_raw_train_step
from iotml_torch.train.optim import InjectableAdam, set_learning_rate

LOSS_TOL = dict(rtol=2e-4, atol=1e-6)
PARAM_TOL = dict(rtol=5e-3, atol=2e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _windows(S, B, seed):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (S, B, 18)).astype(np.float32)
    masks = (rng.random((S, B)) < 0.95).astype(np.float32)
    return xs, masks


def _stepped_state(device, seed, steps=5, lr=5e-3):
    """An injectable-Adam state a few steps in, with a boosted rate: the
    moments and counts a refit starts from."""
    tx = InjectableAdam(1e-3)
    tr = Trainer(CAR_AUTOENCODER, seed=seed, tx=tx, device=device)
    tr._ensure_state()
    xs, masks = _windows(steps, 50, seed + 100)
    st = tr.state
    for x, m in zip(xs, masks):
        st, _ = tr._step(st, torch.from_numpy(x).to(device),
                         torch.from_numpy(x).to(device),
                         torch.from_numpy(m).to(device))
    return tr, TrainState(st.step, st.params,
                          set_learning_rate(st.opt_state, lr))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [50, 100])
@pytest.mark.parametrize("S", [1, 31, 32])
@pytest.mark.parametrize("epochs", [1, 2])
def test_b1_at_refit_shapes_matches_plain_version(B, S, epochs,
                                                  cuda_device):
    _tr, st = _stepped_state(cuda_device, seed=B + S)
    opt = st.opt_state
    fit_state = TrainState(st.step, st.params, opt.inner)
    lr = float(opt.hyperparams["learning_rate"])
    xs, masks = _windows(S, B, seed=S * B + epochs)
    x_d = torch.from_numpy(xs).to(cuda_device)
    m_d = torch.from_numpy(masks).to(cuda_device)
    before = fused_train.fused_fit.launches
    assert fused_train.fit_design(B, 18, 14, 7) == "rows"
    k_state, k_loss, k_acc = fused_train.fused_fit(
        fit_state, x_d, m_d, epochs, lr=lr, l1=CAR_AUTOENCODER.activity_l1)
    torch.cuda.synchronize()
    assert fused_train.fused_fit.launches == before + 1
    p_state, p_loss, p_acc = fused_train.fused_fit_reference(
        fit_state, x_d, m_d, epochs, lr, CAR_AUTOENCODER.activity_l1)
    torch.testing.assert_close(k_loss, p_loss, **LOSS_TOL)
    torch.testing.assert_close(k_acc, p_acc, **LOSS_TOL)
    for k in PARAM_NAMES:
        torch.testing.assert_close(k_state.params[k], p_state.params[k],
                                   **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.mu[k],
                                   p_state.opt_state.mu[k], **PARAM_TOL)
        torch.testing.assert_close(k_state.opt_state.nu[k],
                                   p_state.opt_state.nu[k], **PARAM_TOL)
    assert k_state.opt_state.count == opt.inner.count + epochs * S
    assert k_state.step == st.step + epochs * S


@pytest.mark.cuda
def test_injectable_adam_step_on_the_card_matches_the_cpu(cuda_device):
    tr_c, st_c = _stepped_state(cuda_device, seed=3, steps=0)
    tr_h, st_h = _stepped_state("cpu", seed=3, steps=0)
    step_c = make_raw_train_step(tr_c.model, InjectableAdam(1e-3))
    step_h = make_raw_train_step(tr_h.model, InjectableAdam(1e-3))
    xs, masks = _windows(10, 100, seed=11)
    for i, (x, m) in enumerate(zip(xs, masks)):
        lr = 5e-3 if 3 <= i < 7 else 1e-3
        st_c = TrainState(st_c.step, st_c.params,
                          set_learning_rate(st_c.opt_state, lr))
        st_h = TrainState(st_h.step, st_h.params,
                          set_learning_rate(st_h.opt_state, lr))
        xc, mc = torch.from_numpy(x), torch.from_numpy(m)
        st_c, met_c = step_c(st_c, xc.to(cuda_device), xc.to(cuda_device),
                             mc.to(cuda_device))
        st_h, met_h = step_h(st_h, xc, xc, mc)
        torch.testing.assert_close(met_c["loss"].cpu(), met_h["loss"],
                                   **LOSS_TOL)
        for k in PARAM_NAMES:
            torch.testing.assert_close(st_c.params[k].cpu(), st_h.params[k],
                                       rtol=0, atol=1e-6)
    assert st_c.opt_state.count == st_h.opt_state.count == 10
    assert st_c.opt_state.hyperparams["learning_rate"].device.type == "cpu"


@pytest.mark.cuda
def test_learner_refit_on_the_card_launches_b1_and_matches_the_cpu(
        cuda_device):
    """The same learner state and buffer refit on the card (two B1
    launches) and on the CPU (the plain version)."""
    learners = {}
    for dev in (cuda_device, torch.device("cpu")):
        lrn = OnlineLearner(Broker(), "T", window=100, device=dev,
                            policy=AdaptationPolicy(action="refit"))
        _tr, st = _stepped_state(dev, seed=5)
        lrn.trainer._ensure_state()
        lrn.trainer.state = st
        xs, masks = _windows(32, 100, seed=9)
        for x, m in zip(xs, masks):
            lrn.buffer.append((torch.from_numpy(x).to(dev),
                               torch.from_numpy(m).to(dev), int(m.sum())))
        learners[dev.type] = lrn
    before = fused_train.fused_fit.launches
    learners["cuda"]._refit()
    assert fused_train.fused_fit.launches == before + 2
    learners["cpu"]._refit()
    assert fused_train.fused_fit.launches == before + 2
    c, h = learners["cuda"], learners["cpu"]
    np.testing.assert_allclose(c.last_loss, h.last_loss, **LOSS_TOL)
    for k in PARAM_NAMES:
        torch.testing.assert_close(c.trainer.state.params[k].cpu(),
                                   h.trainer.state.params[k], **PARAM_TOL)
    assert c.records_trained == h.records_trained
    assert c.trainer.state.opt_state.count == \
        h.trainer.state.opt_state.count
