"""The port's SensorFormer training step held against
``iotml.parallel.seq_parallel``.

Small models (features 18, d_model 32, 2 heads, 1-2 layers) on B=4
histories of T=32/40 steps, made by numpy from a seed; the flax params
(and, for the step, the whole optax ``TrainState``) come across through
``models.convert``.  The port's ``attn_mode="flash"`` runs the plain
forward and backward on CPU tensors; the JAX side runs its Pallas flash
kernels in interpret mode (``flash_interpret``) or dense attention.

Tolerances:
- the next-step loss: rtol 1e-5 (one float32 mean, sums in another
  order);
- every parameter's gradient: rtol 1e-4 / atol 1e-6, the bound of the
  JAX suite's SGD-delta gradient check (tests/test_transformer_sp.py:91);
- Adam moments after a few Adam steps: rtol 1e-4 / atol 1e-6;
- params after them: rtol 1e-4 / atol 1e-5 a step.  Adam moves every
  param by about lr = 1e-3 a step whatever the gradient's size, by
  mu/sqrt(nu), which divides away the gradient's scale; so a gradient's
  float error relative to its own size shows up in the step, and 1e-5 a
  step is 1% of one.  Where a param's gradients so far are below 1e-6
  RMS (JAX's second moment says so) they are float noise, and Adam's step
  is about -lr·sign(noise) (the warning of
  tests/test_transformer_sp.py:70-73): there the two sides may step apart
  by up to 2·lr a step.  The key part of each ``qkv`` bias is such a
  case: a constant added to every key adds one constant to each row of
  scores, which the softmax ignores, so its gradient is 0 in exact
  arithmetic.  Fewer than 1% of the parameters with any gradient take
  that bound; the unused position rows have gradients exactly 0 on both
  sides and stay put.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iotml.models.transformer import SensorFormer as JSensorFormer
from iotml.parallel import seq_parallel as j_sp
from iotml.parallel.mesh import make_mesh
from iotml_torch.models.convert import (sensorformer_adam_from_optax,
                                        sensorformer_adam_to_optax,
                                        sensorformer_params_from_jax,
                                        sensorformer_params_to_jax)
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops.attention import flash_attention
from iotml_torch.parallel import seq_parallel as t_sp
from iotml_torch.train.loop import TrainState
from iotml_torch.train.optim import B2 as optax_b2, Adam

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MOMENT_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_RTOL, PARAM_ATOL_PER_STEP = 1e-4, 1e-5
HEADS = 2
LR = 1e-3
#: gradients below this RMS are float noise to Adam (see the docstring)
NOISE_RMS = 1e-6


def _cfg(layers):
    return dict(features=18, d_model=32, num_heads=HEADS, num_layers=layers)


def _x(B=4, T=40, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, 18)).astype(
        np.float32)


def _port(layers, tree, attn_mode="flash"):
    model = SensorFormer(**_cfg(layers), attn_mode=attn_mode, device="cpu")
    model.load_state_dict(sensorformer_params_from_jax(tree))
    return model


def _leaves(tree):
    """(path, numpy leaf) pairs of a flax tree or a port state_dict."""
    if any("." in k for k in tree):
        tree = sensorformer_params_to_jax(tree, HEADS)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, what, **tol):
    """A port state_dict against a flax param tree, leaf by leaf."""
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, w, err_msg=f"{what} {path}", **tol)


@pytest.mark.parametrize("jax_mode", ["flash_interpret", "dense"])
@pytest.mark.parametrize("layers,T", [(1, 32), (2, 40)])
def test_loss_and_grads_match_jax(jax_mode, layers, T):
    x = _x(T=T, seed=layers)
    j_model = JSensorFormer(**_cfg(layers), attn_mode=jax_mode)
    tree = jax.tree.map(np.asarray, j_model.init(
        jax.random.PRNGKey(layers), jnp.asarray(x))["params"])
    want_loss, want_grads = jax.value_and_grad(
        lambda p: j_sp.sp_next_step_loss_reference(j_model, p,
                                                   jnp.asarray(x)))(tree)
    model = _port(layers, tree)
    before = dict(flash_attention.launches)
    loss, grads = t_sp.loss_and_grads(model, model.state_dict(),
                                      torch.from_numpy(x))
    assert flash_attention.launches == before  # CPU: no kernel
    assert set(grads) == set(model.state_dict())
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    with torch.no_grad():
        plain = t_sp.sp_next_step_loss_reference(model, torch.from_numpy(x))
    np.testing.assert_allclose(float(plain), float(want_loss), **LOSS_TOL)
    _assert_tree_close(grads, jax.tree.map(np.asarray, want_grads), "grad",
                       **GRAD_TOL)


def _jax_sp_run(x, steps):
    """JAX make_sp_train_step on a one-device ('data', 'seq') mesh with
    the Pallas kernels interpreted: the initial TrainState, then per step
    the loss, the params and the optax Adam state, all numpy."""
    mesh = make_mesh((1, 1), ("data", "seq"), devices=jax.devices()[:1])
    model = JSensorFormer(**_cfg(2), attn_mode="flash_interpret")
    init, step, put_x = j_sp.make_sp_train_step(model, optax.adam(LR),
                                                mesh)
    state = init(jax.random.PRNGKey(0), x)
    start = jax.device_get(state)  # read before the step donates it
    runs = []
    for _ in range(steps):
        state, metrics = step(state, put_x(x))
        runs.append((float(metrics["loss"]), jax.device_get(state.params),
                     jax.device_get(state.opt_state[0])))
    return start, runs


def _carry(jstate) -> TrainState:
    """A JAX SensorFormer TrainState, whole, as the port's."""
    adam = jstate.opt_state[0]
    return TrainState(
        step=int(jstate.step),
        params=sensorformer_params_from_jax(jstate.params),
        opt_state=sensorformer_adam_from_optax(adam.count, adam.mu, adam.nu))


def _assert_params_close(got, want, adam, step: int, noisy: dict):
    """Params after ``step`` Adam steps within rtol 1e-4 / atol 1e-5 a
    step, except where the
    gradients at this step or an earlier one were below 1e-6 RMS (the
    ``noisy`` masks, updated here): there within 2·lr a step."""
    floor = NOISE_RMS ** 2 * (1 - optax_b2 ** step)
    loose = live = 0
    for (path, g), (_, w), (_, nu) in zip(_leaves(got), _leaves(want),
                                          _leaves(adam.nu)):
        tiny = noisy[path] = noisy.get(path, False) | (nu < floor)
        loose += int((tiny & (nu > 0)).sum())
        live += int((nu > 0).sum())
        np.testing.assert_allclose(g[tiny], w[tiny], rtol=0,
                                   atol=2 * LR * step,
                                   err_msg=f"step {step} {path} (noise)")
        np.testing.assert_allclose(g[~tiny], w[~tiny], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_PER_STEP * step,
                                   err_msg=f"step {step} {path}")
    assert loose < 0.01 * live, (loose, live)


def test_train_step_matches_jax_make_sp_train_step():
    x = _x(T=40, seed=7)
    start, runs = _jax_sp_run(x, steps=3)
    model = _port(2, start.params)
    init, step, put_x = t_sp.make_sp_train_step(model, Adam(LR))
    state = _carry(start)
    noisy = {}
    for i, (want_loss, want_params, want_adam) in enumerate(runs, 1):
        state, metrics = step(state, put_x(x))
        np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                                   **LOSS_TOL)
        _assert_params_close(state.params, want_params, want_adam, i, noisy)
    assert state.step == len(runs) == state.opt_state.count
    count, mu, nu = sensorformer_adam_to_optax(state.opt_state, HEADS)
    assert int(count) == int(want_adam.count)
    _assert_tree_close(mu, want_adam.mu, "mu", **MOMENT_TOL)
    _assert_tree_close(nu, want_adam.nu, "nu", **MOMENT_TOL)


def test_loss_falls_over_steps():
    x = torch.from_numpy(_x(T=32, seed=2))
    model = SensorFormer(**_cfg(2), attn_mode="flash", device="cpu",
                         generator=torch.Generator().manual_seed(4))
    init, step, put_x = t_sp.make_sp_train_step(model, Adam(1e-3))
    state = init()
    assert state.step == 0 and state.opt_state.count == 0
    weights = dict(model.state_dict())
    losses = []
    for _ in range(6):
        state, metrics = step(state, put_x(x))
        assert metrics["loss"].dim() == 0
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    # the step is functional: the module's weights stay as they were
    assert all(torch.equal(weights[k], v)
               for k, v in model.state_dict().items())


def test_adam_state_round_trips_with_optax():
    x = _x(B=2, T=8)
    j_model = JSensorFormer(**_cfg(1))
    tree = j_model.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    tx = optax.adam(1e-3)
    opt = tx.init(tree)
    grads = jax.tree.map(lambda a: jnp.full_like(a, 0.25), tree)
    _, opt = tx.update(grads, opt, tree)
    adam = jax.device_get(opt[0])
    ported = sensorformer_adam_from_optax(adam.count, adam.mu, adam.nu)
    assert ported.count == 1
    assert set(ported.mu) == set(_port(1, jax.device_get(tree))
                                 .state_dict())
    count, mu, nu = sensorformer_adam_to_optax(ported, HEADS)
    assert count == np.asarray(adam.count) and count.dtype == np.int32
    for back, want in ((mu, adam.mu), (nu, adam.nu)):
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
        for (_, b), (_, w) in zip(flat_b, flat_w):
            np.testing.assert_array_equal(b, np.asarray(w))


def test_multi_device_mesh_raises_not_implemented():
    model = SensorFormer(**_cfg(1), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        t_sp.make_sp_train_step(model, Adam(), mesh=["cpu", "cpu"])
    init, step, put_x = t_sp.make_sp_train_step(model, Adam(),
                                                mesh=["cpu"])
    x = put_x(_x(B=1, T=8).astype(np.float64))
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    state, metrics = step(init(), x)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
