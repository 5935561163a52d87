"""Card-only checks of the port's build guard (iotml_torch.analysis
.tracecheck): the two guarded hot loops on the card build and load
nothing after their warm-up, ``Trainer.fit_compiled`` launches B1 once
a call and ``OnlineLearner._update`` never, and a real per-call library
load inside a warmed loop fails it.  Every test is marked ``cuda`` and
skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest, with
the guard armed by the port's plugin:

    IOTML_TRACECHECK=1 python -m pytest --noconftest -p no:cacheprovider \\
        -p iotml_torch.analysis.pytest_plugin tests/test_torch_cuda_analysis.py

Tolerance: none; build counts and launch counts are exact.
"""

import os

import numpy as np
import pytest
import torch

from iotml_torch.analysis import tracecheck
from iotml_torch.data.dataset import Batch
from iotml_torch.models.autoencoder import CAR_AUTOENCODER
from iotml_torch.online.learner import OnlineLearner
from iotml_torch.ops import _build, fused_train
from iotml_torch.stream.broker import Broker
from iotml_torch.train.loop import Trainer


@pytest.fixture
def guarded():
    """The guard over the hot loops: the session's when the plugin armed
    it (IOTML_TRACECHECK=1), else installed here and removed after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    session = bool(os.environ.get("IOTML_TRACECHECK"))
    if not session:
        tracecheck.install_runtime_guard()
    tracecheck.reset_warm()
    try:
        yield tracecheck.RecompileGuard
    finally:
        if not session:
            tracecheck.uninstall_runtime_guard()


def _batches(n=20, b=100, seed=0):
    rng = np.random.default_rng(seed)
    return [Batch(x=rng.uniform(-1, 1, (b, 18)).astype(np.float32),
                  n_valid=b, first_index=i * b) for i in range(n)]


@pytest.mark.cuda
def test_fit_compiled_warm_calls_build_nothing_and_launch_b1_once(guarded):
    bs = _batches()
    trainer = Trainer(CAR_AUTOENCODER)  # the card
    launches = []
    builds = []
    for _ in range(3):
        before_l = fused_train.fused_fit.launches
        before_b = guarded.compiles()
        hist = trainer.fit_compiled(bs, epochs=2)
        torch.cuda.synchronize()
        launches.append(fused_train.fused_fit.launches - before_l)
        builds.append(guarded.compiles() - before_b)
        assert all(np.isfinite(hist["loss"]))
    assert launches == [1, 1, 1]
    assert builds[1:] == [0, 0]


@pytest.mark.cuda
def test_online_update_warm_calls_build_nothing_and_launch_nothing(guarded):
    learner = OnlineLearner(Broker(), "ANALYSIS_ONLINE", window=100)
    windows = _batches(n=3, seed=1)
    before_l = fused_train.fused_fit.launches
    builds = []
    for w in windows:
        before_b = guarded.compiles()
        assert np.isfinite(learner._update(w))
        builds.append(guarded.compiles() - before_b)
    assert fused_train.fused_fit.launches == before_l
    assert builds[1:] == [0, 0]


@pytest.mark.cuda
def test_a_per_call_load_in_a_warmed_loop_fails_it(guarded):
    """Forgetting the loaded B1 library before each call makes every
    call load it again: the guard fails the second call."""
    bs = _batches(n=4)

    class Reloading(Trainer):
        def fit_compiled(self, batches, epochs=1, fused="auto"):
            _build._LOADED.pop("fused_train", None)
            return super().fit_compiled(batches, epochs, fused)

    Reloading.fit_compiled = tracecheck.guard_hot_loop(
        Reloading.fit_compiled, "Reloading.fit_compiled")
    trainer = Reloading(CAR_AUTOENCODER)
    trainer.fit_compiled(bs, epochs=1)  # warm-up: may load
    with pytest.raises(tracecheck.RecompileError):
        trainer.fit_compiled(bs, epochs=1)
