"""The port's SensorFormer training step held against
``iotml.parallel.seq_parallel``.

Small models (features 18, d_model 32, 2 heads, 1-2 layers) on B=4
histories of T=32/40 steps, made by numpy from a seed; the flax params
(and, for the step, the whole optax ``TrainState``) come across through
``models.convert``.  The port's ``attn_mode="flash"`` runs the plain
forward and backward on CPU tensors; the JAX side runs its Pallas flash
kernels in interpret mode (``flash_interpret``) or dense attention.

The multi-device step runs on eight ``torch.device("cpu")`` shards of a
``('data', 'seq')`` mesh against JAX's ``make_sp_train_step`` on its
eight virtual devices (``tests/test_transformer_sp.py``'s cases), with
``attn_mode="ring"`` on both sides.

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
from iotml_torch.parallel.mesh import make_mesh as make_torch_mesh
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
    """Once a refusal (ROADMAP A11); now a parity case: a (1, 2) CPU
    mesh with a ring model gives the one-device step's loss and grads,
    and only a multi-device sequence that is not a ``Mesh`` is refused."""
    model = SensorFormer(**_cfg(1), device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        t_sp.make_sp_train_step(model, Adam(), mesh=["cpu", "cpu"])
    x = _x(B=2, T=16, seed=9)
    ring = SensorFormer(**_cfg(1), attn_mode="ring", device="cpu")
    ring.load_state_dict(model.state_dict())
    mesh = make_cpu_mesh((1, 2), ("data", "seq"))
    init, step, put_x = t_sp.make_sp_train_step(ring, Adam(), mesh)
    metrics, grads = step.value_and_grad(init(), put_x(x))
    want_loss, want_grads = t_sp.loss_and_grads(
        model, model.state_dict(), torch.from_numpy(x))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss),
                               **LOSS_TOL)
    for k, g in want_grads.items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                   err_msg=k, **GRAD_TOL)
    init, step, put_x = t_sp.make_sp_train_step(model, Adam(),
                                                mesh=["cpu"])
    x = put_x(_x(B=1, T=8).astype(np.float64))
    assert x.dtype == torch.float32 and x.device.type == "cpu"
    state, metrics = step(init(), x)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))


# ---------------------------------------------------------------------
# the multi-device step: tests/test_transformer_sp.py's cases on both
# packages, JAX's eight virtual devices against eight CPU shards
# ---------------------------------------------------------------------

def make_cpu_mesh(shape, names):
    return make_torch_mesh(shape, names,
                           devices=[torch.device("cpu")] * int(np.prod(shape)))


class _Sgd:
    """``optax.sgd``: p + (-lr)·g, no state."""

    def __init__(self, lr):
        self.lr = lr

    def init(self, params):
        return ()

    def update(self, grads, state, params):
        return {k: params[k] + (-self.lr) * g for k, g in grads.items()}, \
            state


def _jax_ring_run(x, tx, steps, layers=2, seed=0):
    """JAX make_sp_train_step on its (2, 4) mesh: the initial params,
    then per step the loss, the params and the optimizer state."""
    mesh = make_mesh((2, 4), ("data", "seq"))
    model = JSensorFormer(**_cfg(layers), attn_mode="ring", ring_axis="seq")
    init, step, put_x = j_sp.make_sp_train_step(model, tx, mesh)
    state = init(jax.random.PRNGKey(seed), x)
    start = jax.device_get(state.params)
    runs = []
    for _ in range(steps):
        state, metrics = step(state, put_x(x))
        runs.append((float(metrics["loss"]), jax.device_get(state.params),
                     jax.device_get(state.opt_state)))
    return start, runs


def _port_ring(layers, tree):
    return _port(layers, tree, attn_mode="ring")


def _host(params):
    return {k: torch.from_numpy(v.numpy()) for k, v in params.items()}


def test_sp_step_on_a_2x4_mesh_matches_jax_and_the_dense_oracle():
    """tests/test_transformer_sp.py:test_sp_gradients_match_dense_oracle
    on both packages: with SGD the param delta is −lr·grad, so the
    post-step params compare the sharded gradients (rtol 1e-4 / atol
    1e-6); the loss rel 1e-5."""
    x = _x(B=4, T=32, seed=5)
    start, runs = _jax_ring_run(x, optax.sgd(0.1), steps=1, layers=1,
                                seed=2)
    (want_loss, want_params, _), = runs
    dense = JSensorFormer(**_cfg(1))
    oracle = float(j_sp.sp_next_step_loss_reference(dense, start,
                                                    jnp.asarray(x)))
    model = _port_ring(1, start)
    init, step, put_x = t_sp.make_sp_train_step(
        model, _Sgd(0.1), make_cpu_mesh((2, 4), ("data", "seq")))
    state, metrics = step(init(), put_x(x))
    assert float(metrics["loss"]) == pytest.approx(want_loss, rel=1e-5)
    assert float(metrics["loss"]) == pytest.approx(oracle, rel=1e-5)
    _assert_tree_close(_host(state.params), want_params, "sgd params",
                       rtol=1e-4, atol=1e-6)


def test_sp_step_on_a_2x4_mesh_matches_jax_adam_steps():
    x = _x(B=4, T=32, seed=0)
    start, runs = _jax_ring_run(x, optax.adam(LR), steps=3)
    model = _port_ring(2, start)
    init, step, put_x = t_sp.make_sp_train_step(
        model, Adam(LR), make_cpu_mesh((2, 4), ("data", "seq")))
    state, xs = init(), put_x(x)
    assert len(xs.shards) == 8 and xs.shape == x.shape
    assert [tuple(s.shape) for s in xs.shards] == [(2, 8, 18)] * 8
    np.testing.assert_array_equal(xs.numpy(), x)
    noisy = {}
    losses = []
    for i, (want_loss, want_params, want_opt) in enumerate(runs, 1):
        state, metrics = step(state, xs)
        losses.append(float(metrics["loss"]))
        np.testing.assert_allclose(losses[-1], want_loss, **LOSS_TOL)
        _assert_params_close(_host(state.params), want_params, want_opt[0],
                             i, noisy)
    assert losses[-1] < losses[0] and state.step == 3


def test_sp_mesh_grads_equal_the_one_device_step():
    """The sharded step's gradients (``step.value_and_grad``) against
    ``loss_and_grads`` of the one-device flash and dense models."""
    x = _x(B=4, T=40, seed=11)
    one = SensorFormer(**_cfg(2), attn_mode="flash", device="cpu",
                       generator=torch.Generator().manual_seed(8))
    ring = SensorFormer(**_cfg(2), attn_mode="ring", device="cpu")
    ring.load_state_dict(one.state_dict())
    init, step, put_x = t_sp.make_sp_train_step(
        ring, Adam(), make_cpu_mesh((2, 4), ("data", "seq")))
    metrics, grads = step.value_and_grad(init(), put_x(x))
    for mode in ("flash", "dense"):
        ref = SensorFormer(**_cfg(2), attn_mode=mode, device="cpu")
        ref.load_state_dict(one.state_dict())
        loss, want = t_sp.loss_and_grads(ref, ref.state_dict(),
                                         torch.from_numpy(x))
        np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                                   **LOSS_TOL)
        for k, g in want.items():
            np.testing.assert_allclose(grads[k].numpy(), g.numpy(),
                                       err_msg=f"{mode} {k}", **GRAD_TOL)


def test_shift_in_next_and_mask_match_jax():
    from iotml.parallel.mesh import shard_map as j_shard_map
    from jax.sharding import PartitionSpec as JP

    from iotml_torch.parallel.mesh import P, shard_map

    x = _x(B=2, T=32, seed=4)
    j_mesh = make_mesh((2, 4), ("data", "seq"))
    j_fn = j_shard_map(
        lambda a: (j_sp.shift_in_next(a, "seq"),
                   jnp.broadcast_to(j_sp.next_step_mask(a.shape[1], "seq"),
                                    a.shape[:2])),
        mesh=j_mesh, in_specs=(JP("data", "seq"),),
        out_specs=(JP("data", "seq"), JP("data", "seq")), check_vma=False)
    want_x, want_m = map(np.asarray, j_fn(jnp.asarray(x)))
    fn = shard_map(
        lambda a: (t_sp.shift_in_next(a, "seq"),
                   t_sp.next_step_mask(a.shape[1], "seq")
                   .expand(a.shape[:2])),
        make_cpu_mesh((2, 4), ("data", "seq")), in_specs=(P("data", "seq"),),
        out_specs=(P("data", "seq"), P("data", "seq")))
    got_x, got_m = fn(x)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    live = want_m.astype(bool)
    np.testing.assert_array_equal(got_x.numpy()[live], want_x[live])
    np.testing.assert_array_equal(got_x.numpy()[:, :-1], x[:, 1:])


def test_sp_mesh_refuses_as_jax():
    model = SensorFormer(**_cfg(1), attn_mode="ring", device="cpu",
                         max_len=16)
    init, step, put_x = t_sp.make_sp_train_step(
        model, Adam(), make_cpu_mesh((1, 4), ("data", "seq")))
    with pytest.raises(ValueError, match="exceeds model.max_len=16"):
        step(init(), put_x(_x(B=1, T=32)))
    with pytest.raises(ValueError, match="attn_mode='ring'"):
        t_sp.make_sp_train_step(SensorFormer(**_cfg(1), device="cpu"),
                                Adam(), make_cpu_mesh((1, 4),
                                                      ("data", "seq")))
