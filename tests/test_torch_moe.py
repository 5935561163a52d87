"""The port's mixture-of-experts SensorFormer (``iotml_torch.models.moe``)
and expert parallelism (``iotml_torch.parallel.expert_parallel``) held
against the JAX package's on the CPU: ``tests/test_moe.py``'s cases on
both packages, JAX's eight virtual devices against eight
``torch.device("cpu")`` shards, from the same numpy draws and the
converted flax init.

Tolerances: routed experts, capacity drops and kept-token sets equal; the
FFN's and the model's outputs and aux rtol = atol 1e-5 (f32 products in
another order); the param round trip exact; the EP step's mse rtol 1e-4
(tests/test_moe.py's bound) and its gradients against the one-device
model on each row block rtol 1e-4 / atol 1e-6; params after Adam steps
rtol 1e-4 / atol 1e-5 a step, except where a leaf's gradients are below
1e-6 RMS (float noise that Adam turns into ±lr steps: the key part of
the ``qkv`` bias, whose exact gradient is 0): there 2·lr a step, as in
tests/test_torch_seq_parallel.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from iotml.models.moe import MoEFFN as JMoEFFN
from iotml.models.moe import MoESensorFormer as JMoESensorFormer
from iotml.parallel import expert_parallel as j_ep
from iotml.parallel.mesh import make_mesh as j_make_mesh
from iotml_torch.models import MoEBlock, MoEFFN, MoESensorFormer
from iotml_torch.models.convert import (moe_sensorformer_adam_from_optax,
                                        moe_sensorformer_adam_to_optax,
                                        moe_sensorformer_params_from_jax,
                                        moe_sensorformer_params_to_jax)
from iotml_torch.parallel import expert_parallel as t_ep
from iotml_torch.parallel.mesh import P, make_mesh
from iotml_torch.parallel.sharded_step import host_params
from iotml_torch.train.optim import B2 as optax_b2, Adam

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
MSE_TOL = dict(rtol=1e-4, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_RTOL, PARAM_ATOL_PER_STEP = 1e-4, 1e-5
NOISE_RMS = 1e-6
LR = 1e-3
CPU = torch.device("cpu")


def _x(B=4, T=16, F=18, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, F)).astype(
        np.float32)


def _ffn_pair(d, E, cf, x, seed=0):
    j = JMoEFFN(d_model=d, num_experts=E, capacity_factor=cf)
    p = jax.device_get(j.init(jax.random.PRNGKey(seed), x)["params"])
    t = MoEFFN(d, E, capacity_factor=cf, gen=torch.Generator(), device=CPU)
    t.load_state_dict({"router.weight": torch.from_numpy(
        np.ascontiguousarray(p["router"]["kernel"].T)),
        **{k: torch.from_numpy(np.array(p[k]))
           for k in ("w1", "b1", "w2", "b2")}})
    return j, p, t


@pytest.mark.parametrize("E,cf,N", [(4, 1.25, 32), (4, 4.0, 32),
                                    (8, 1.25, 200), (2, 0.5, 64)])
def test_moe_ffn_matches_jax(E, cf, N):
    x = np.random.default_rng(E + N).normal(size=(N, 16)).astype(np.float32)
    j, p, t = _ffn_pair(16, E, cf, x)
    want_out, want_aux = j.apply({"params": p}, x)
    logits = x @ np.asarray(p["router"]["kernel"])
    with torch.no_grad():
        out, aux = t(torch.from_numpy(x))
        routed = torch.argmax(torch.softmax(
            t.router(torch.from_numpy(x)), -1), -1).numpy()
    np.testing.assert_array_equal(routed, np.argmax(logits, -1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **OUT_TOL)
    # a dropped token's output is exactly 0 on both sides, and only there
    C = max(1, int(cf * N / E))
    counts = np.bincount(routed, minlength=E)
    assert int(t.dropped) == int(np.maximum(counts - C, 0).sum())
    zero = ~np.any(out.numpy() != 0, axis=-1)
    np.testing.assert_array_equal(zero, ~np.any(np.asarray(want_out) != 0,
                                                axis=-1))
    assert int(zero.sum()) == int(t.dropped)


def test_moe_capacity_drops_are_residual_passthrough():
    # capacity_factor tiny -> most tokens dropped -> their FFN output is 0
    x = np.random.default_rng(1).normal(size=(64, 8)).astype(np.float32)
    j, p, t = _ffn_pair(8, 2, 0.01, x)
    with torch.no_grad():
        out, _ = t(torch.from_numpy(x))
    # C = max(1, 0.01·64/2) = 1 slot an expert -> at most 2 nonzero rows
    assert int(np.any(out.numpy() != 0, axis=-1).sum()) <= 2
    assert int(t.dropped) >= 62
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j.apply({"params": p}, x)[0]),
                               **OUT_TOL)


def _pair(cfg, x, seed=0, **port):
    j = JMoESensorFormer(**cfg)
    tree = jax.device_get(j.init(jax.random.PRNGKey(seed),
                                 jnp.asarray(x))["params"])
    t = MoESensorFormer(**cfg, device="cpu", **port)
    t.load_state_dict(moe_sensorformer_params_from_jax(tree))
    return j, tree, t


def test_moe_sensorformer_forward_matches_jax():
    cfg = dict(features=18, d_model=32, num_heads=2, num_layers=2,
               num_experts=4)
    x = _x()
    j, tree, t = _pair(cfg, x)
    want_pred, want_aux = j.apply({"params": tree}, jnp.asarray(x))
    with torch.no_grad():
        pred, aux = t(torch.from_numpy(x))
    assert pred.shape == x.shape and np.isfinite(float(aux))
    assert isinstance(t.block1, MoEBlock) and isinstance(t.block1.moe, MoEFFN)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred),
                               **OUT_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **OUT_TOL)
    flash = MoESensorFormer(**cfg, attn_mode="flash", device="cpu")
    flash.load_state_dict(t.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(flash(torch.from_numpy(x))[0].numpy(),
                                   pred.numpy(), rtol=2e-4, atol=2e-4)


def test_moe_params_and_adam_state_round_trip_exactly():
    cfg = dict(features=6, d_model=16, num_heads=2, num_layers=2,
               num_experts=4)
    x = _x(B=2, T=8, F=6)
    j, tree, t = _pair(cfg, x)
    state = moe_sensorformer_params_from_jax(tree)
    assert set(state) == set(MoESensorFormer(**cfg, device="cpu")
                             .state_dict())
    assert state["block1.moe.w1"].shape == (4, 16, 64)
    assert state["block0.moe.router.weight"].shape == (4, 16)
    back = moe_sensorformer_params_to_jax(state, num_heads=2)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)
    tx = optax.adam(1e-3)
    opt = tx.init(tree)
    _, opt = tx.update(jax.tree.map(lambda a: jnp.full_like(a, 0.5), tree),
                       opt, tree)
    adam = jax.device_get(opt[0])
    ported = moe_sensorformer_adam_from_optax(adam.count, adam.mu, adam.nu)
    count, mu, nu = moe_sensorformer_adam_to_optax(ported, 2)
    assert int(count) == 1 and count.dtype == np.int32
    for got, want in ((mu, adam.mu), (nu, adam.nu)):
        for (_, g), (_, w) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                  jax.tree_util.tree_flatten_with_path(want)[0]):
            np.testing.assert_array_equal(g, np.asarray(w))


def test_expert_param_specs_target_only_expert_weights():
    cfg = dict(features=6, d_model=16, num_heads=2, num_layers=1,
               num_experts=4)
    j, tree, t = _pair(cfg, _x(B=2, T=8, F=6))
    specs = t_ep.expert_param_specs(t.state_dict())
    j_specs = j_ep.expert_param_specs(tree)
    assert specs["block0.moe.w1"] == P("expert")
    assert j_specs["block0"]["moe"]["w1"] == JP("expert")
    assert specs["block0.moe.router.weight"] == P()
    assert specs["embed.weight"] == P()
    assert {k for k, s in specs.items() if s} == {
        f"block0.moe.{leaf}" for leaf in t_ep.EXPERT_LEAVES}
    mesh = make_mesh((1, 4), ("data", "expert"), devices=[CPU] * 4)
    pieces = t_ep.shard_expert_params(t.state_dict(), mesh)
    assert [tuple(s.shape) for s in pieces["block0.moe.b2"].shards] == \
        [(1, 16)] * 4
    np.testing.assert_array_equal(pieces["block0.moe.w2"].numpy(),
                                  tree["block0"]["moe"]["w2"])


def _leaves(tree):
    if any("." in k for k in tree):
        tree = moe_sensorformer_params_to_jax(tree, 2)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_params_close(got, want, nu, step, noisy):
    floor = NOISE_RMS ** 2 * (1 - optax_b2 ** step)
    for (path, g), (_, w), (_, n) in zip(_leaves(got), _leaves(want),
                                         _leaves(nu)):
        tiny = noisy[path] = noisy.get(path, False) | (n < floor)
        np.testing.assert_allclose(g[tiny], w[tiny], rtol=0,
                                   atol=2 * LR * step,
                                   err_msg=f"step {step} {path} (noise)")
        np.testing.assert_allclose(g[~tiny], w[~tiny], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL_PER_STEP * step,
                                   err_msg=f"step {step} {path}")


def _ep_cfg(E, cf):
    return dict(features=6, d_model=16, num_heads=2, num_layers=1,
                num_experts=E, capacity_factor=cf)


@pytest.mark.parametrize("shape,E,cf", [((2, 2), 4, 4.0), ((2, 4), 8, 2.0),
                                        ((2, 4), 8, 1.0)])
def test_ep_train_step_matches_jax(shape, E, cf):
    """mse and loss each step, and the params after three Adam steps,
    on both packages' (data, expert) meshes."""
    x = _x(B=8, T=8, F=6, seed=4)
    n = shape[0] * shape[1]
    j_mesh = j_make_mesh(shape, ("data", "expert"), devices=jax.devices()[:n])
    j_model = JMoESensorFormer(**_ep_cfg(E, cf))
    init, step, put_x = j_ep.make_ep_train_step(j_model, optax.adam(LR),
                                                j_mesh)
    state = init(jax.random.PRNGKey(1), x)
    start = jax.device_get(state.params)
    runs = []
    for _ in range(3):
        state, m = step(state, put_x(x))
        runs.append((float(m["loss"]), float(m["mse"]),
                     jax.device_get(state.params),
                     jax.device_get(state.opt_state[0].nu)))
    model = MoESensorFormer(**_ep_cfg(E, cf), device="cpu")
    model.load_state_dict(moe_sensorformer_params_from_jax(start))
    init, step, put_x = t_ep.make_ep_train_step(
        model, Adam(LR), make_mesh(shape, ("data", "expert"),
                                   devices=[CPU] * n))
    st, xs = init(), put_x(x)
    assert [tuple(s.shape) for s in xs.shards] == [(8 // n, 8, 6)] * n
    noisy = {}
    for i, (loss, mse, params, nu) in enumerate(runs, 1):
        st, m = step(st, xs)
        np.testing.assert_allclose(float(m["mse"]), mse, **MSE_TOL)
        np.testing.assert_allclose(float(m["loss"]), loss, **MSE_TOL)
        got = {k: torch.from_numpy(v) for k, v in host_params(st.params)
               .items()}
        _assert_params_close(got, params, nu, i, noisy)
    w1 = st.params["block0.moe.w1"]
    assert [s.shape[0] for s in w1.shards] == [E // shape[1]] * shape[1]


def test_ep_matches_dense_dispatch_when_no_drops():
    """tests/test_moe.py's case: capacity E guarantees no drop, so the
    all-to-all path's mse is the single-device model's."""
    E = 4
    x = _x(B=8, T=8, F=6, seed=3)
    j, tree, model = _pair(_ep_cfg(E, float(E)), x)
    with torch.no_grad():
        pred, _ = model(torch.from_numpy(x))
    want = float(torch.mean(torch.square(pred[:, :-1]
                                         - torch.from_numpy(x)[:, 1:])))
    init, step, put_x = t_ep.make_ep_train_step(
        model, Adam(0.0), make_mesh((2, 2), ("data", "expert"),
                                    devices=[CPU] * 4))
    _, metrics = step(init(), put_x(x))
    np.testing.assert_allclose(float(metrics["mse"]), want, **MSE_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_ep_grads_equal_the_model_on_each_row_block(cf):
    """The EP step's loss and gradients against the one-device model run
    on each shard's row block separately (the same C a block, so the
    same drops), its squared errors and aux summed as the step sums
    them."""
    x = _x(B=8, T=8, F=6, seed=6)
    model = MoESensorFormer(**_ep_cfg(8, cf), device="cpu",
                            generator=torch.Generator().manual_seed(2))
    mesh = make_mesh((2, 2), ("data", "expert"), devices=[CPU] * 4)
    init, step, put_x = t_ep.make_ep_train_step(model, Adam(), mesh,
                                                aux_weight=0.01)
    metrics, grads = step.value_and_grad(init(), put_x(x))
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.state_dict().items()}
    se, aux, dropped = 0.0, 0.0, 0
    for blk in np.split(x, 4):
        pred, a = torch.func.functional_call(model, leaves,
                                             (torch.from_numpy(blk),))
        se = se + torch.sum(torch.square(pred[:, :-1]
                                         - torch.from_numpy(blk)[:, 1:]))
        aux = aux + a
        dropped += int(model.block0.moe.dropped)
    mse = se / (x[:, 1:].size)
    loss = mse + 0.01 * aux / 4
    want = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(metrics["mse"]), float(mse.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float(loss.detach()),
                               rtol=1e-5)
    for (k, _), g in zip(leaves.items(), want):
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), err_msg=k,
                                   **GRAD_TOL)
    # the step's own drops, read from its shards, equal the oracle's
    assert step.dropped() == dropped
    if cf < 1:  # half the capacity a uniform routing needs
        assert dropped > 0


def test_ep_train_step_learns():
    x = _x(B=8, T=8, F=6, seed=4)
    model = MoESensorFormer(**_ep_cfg(8, 2.0), device="cpu",
                            generator=torch.Generator().manual_seed(1))
    init, step, put_x = t_ep.make_ep_train_step(
        model, Adam(1e-2), make_mesh((2, 4), ("data", "expert"),
                                     devices=[CPU] * 8))
    state, xs = init(), put_x(x)
    losses = []
    for _ in range(5):
        state, m = step(state, xs)
        losses.append(float(m["mse"]))
    assert losses[-1] < losses[0]
    w1 = state.params["block0.moe.w1"]
    assert w1.shards[0].shape[0] == 2 and w1.shape == (8, 16, 64)
    # the module the step was built from keeps its own weights and axis
    assert model.block0.moe.ep_axis is None
