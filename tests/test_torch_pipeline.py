"""The port's pipeline parallelism (``iotml_torch.parallel.pipeline``)
held against the JAX package's on the CPU: ``tests/test_pipeline.py``'s
cases on both packages, JAX's eight virtual devices against eight
``torch.device("cpu")`` shards, from the same numpy draws and the
converted flax init.

Tolerances are the JAX suite's: ``pipeline_apply`` rtol = atol 1e-5,
its gradients rtol 1e-4 / atol 1e-5; the pp step's loss rtol 1e-4
(tests/test_pipeline.py's bound); its gradients against the one-device
step's rtol 1e-4 / atol 1e-6 (tests/test_transformer_sp.py's); stacking
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iotml.models.transformer import SensorFormer as JSensorFormer
from iotml.parallel import pipeline as j_pp
from iotml.parallel.mesh import make_mesh as j_make_mesh
from iotml_torch.models.convert import sensorformer_params_from_jax
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.parallel import pipeline as t_pp
from iotml_torch.parallel.mesh import make_mesh
from iotml_torch.parallel.seq_parallel import loss_and_grads
from iotml_torch.train.optim import Adam

APPLY_TOL = dict(rtol=1e-5, atol=1e-5)
APPLY_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-4, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
CPU = torch.device("cpu")


def _cpu_mesh(shape, names):
    return make_mesh(shape, names, devices=[CPU] * int(np.prod(shape)))


def _stacked_mlp(n_layers, dim, seed=0):
    r = np.random.default_rng(seed)
    return {"w": r.normal(scale=0.3, size=(n_layers, dim, dim)).astype(
                np.float32),
            "b": r.normal(scale=0.1, size=(n_layers, dim)).astype(
                np.float32)}


def _j_stage(local, h):
    for j in range(local["w"].shape[0]):
        h = jnp.tanh(h @ local["w"][j] + local["b"][j])
    return h


def _t_stage(local, h):
    for j in range(local["w"].shape[0]):
        h = torch.tanh(h @ local["w"][j] + local["b"][j])
    return h


def test_pipeline_apply_matches_jax_and_sequential():
    stacked = _stacked_mlp(8, 16)  # 2 layers a stage
    mbs = np.random.default_rng(1).normal(size=(6, 5, 16)).astype(
        np.float32)
    j_mesh = j_make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    want = np.asarray(j_pp.pipeline_apply(_j_stage, j_mesh)(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(mbs)))
    calls = []

    def stage(local, h):
        calls.append(local["w"].shape[0])
        return _t_stage(local, h)

    got = t_pp.pipeline_apply(stage, _cpu_mesh((4,), ("pipe",)))(
        {k: torch.from_numpy(v) for k, v in stacked.items()}, mbs)
    np.testing.assert_allclose(got.numpy(), want, **APPLY_TOL)
    seq = torch.from_numpy(mbs)
    seq = _t_stage({k: torch.from_numpy(v) for k, v in stacked.items()},
                   seq)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), **APPLY_TOL)
    # bubble ticks skipped: each of 4 stages runs its 2 layers on each
    # of the 6 microbatches once
    assert calls == [2] * (4 * 6)


def test_pipeline_apply_grads_match_jax():
    stacked = _stacked_mlp(4, 8, seed=2)
    mbs = np.random.default_rng(3).normal(size=(4, 3, 8)).astype(np.float32)
    j_mesh = j_make_mesh((4,), ("pipe",), devices=jax.devices()[:4])
    piped = j_pp.pipeline_apply(_j_stage, j_mesh)
    want = jax.grad(lambda p: jnp.mean(jnp.square(piped(p, mbs))))(
        jax.tree.map(jnp.asarray, stacked))
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in stacked.items()}
    out = t_pp.pipeline_apply(_t_stage, _cpu_mesh((4,), ("pipe",)))(
        leaves, mbs)
    got = torch.autograd.grad(torch.mean(torch.square(out)),
                              [leaves["w"], leaves["b"]])
    for g, k in zip(got, ("w", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   err_msg=k, **APPLY_GRAD_TOL)


def test_stack_unstack_roundtrip_and_jax_layout():
    model = JSensorFormer(features=6, d_model=16, num_heads=2, num_layers=4)
    tree = jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 8, 6)))["params"])
    params = sensorformer_params_from_jax(tree)
    static, blocks = t_pp.stack_blocks(params, 4)
    assert set(static) == {k for k in params if not k.startswith("block")}
    assert blocks["attn.qkv.weight"].shape == (4, 48, 16)
    back = t_pp.unstack_blocks(static, blocks, 4)
    assert set(back) == set(params)
    for k, v in params.items():
        assert torch.equal(back[k], v), k
    j_static, j_blocks = j_pp.stack_blocks(tree, 4)
    for i in range(4):
        one = jax.tree.map(lambda a, i=i: np.asarray(a)[i], j_blocks)
        got = sensorformer_params_from_jax({**j_static, "block0": one})
        for k, v in got.items():
            if k.startswith("block0."):
                name = k[len("block0."):]
                assert torch.equal(blocks[name][i], v), (i, name)


def _j_pp_run(x, steps, mesh_shape=(2, 4), layers=4, mb=2):
    mesh = j_make_mesh(mesh_shape, ("data", "pipe"))
    model = JSensorFormer(features=18, d_model=32, num_heads=2,
                          num_layers=layers)
    init, step, put_x = j_pp.make_pp_train_step(model, optax.adam(1e-3),
                                                mesh, n_microbatches=mb)
    state = init(jax.random.PRNGKey(0), x)
    raw = jax.device_get(j_pp.unstack_blocks(
        state.params["static"], state.params["blocks"], layers))
    losses = []
    for _ in range(steps):
        state, m = step(state, put_x(x))
        losses.append(float(jax.device_get(m["loss"])))
    return raw, losses


def test_pp_train_step_matches_jax_and_the_one_device_step():
    x = np.random.default_rng(0).normal(size=(8, 16, 18)).astype(np.float32)
    raw, want_losses = _j_pp_run(x, steps=3)
    model = SensorFormer(features=18, d_model=32, num_heads=2, num_layers=4,
                         device="cpu")
    model.load_state_dict(sensorformer_params_from_jax(raw))
    init, step, put_x = t_pp.make_pp_train_step(
        model, Adam(1e-3), _cpu_mesh((2, 4), ("data", "pipe")),
        n_microbatches=2)
    state, xs = init(), put_x(x)
    metrics, grads = step.value_and_grad(state, xs)
    loss, want = loss_and_grads(model, model.state_dict(),
                                torch.from_numpy(x))
    np.testing.assert_allclose(float(metrics["loss"]), float(loss),
                               rtol=1e-5)
    host = t_pp.unstack_blocks(
        {k: torch.from_numpy(v.numpy()) for k, v in grads["static"].items()},
        {k: torch.from_numpy(v.numpy()) for k, v in grads["blocks"].items()},
        4)
    for k, g in want.items():
        np.testing.assert_allclose(host[k].numpy(), g.numpy(), err_msg=k,
                                   **GRAD_TOL)
    losses = []
    for _ in range(3):
        state, m = step(state, xs)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert losses[-1] < losses[0] and state.step == 3


def test_pp_blocks_stay_sharded_over_pipe():
    model = SensorFormer(features=6, d_model=16, num_heads=2, num_layers=8,
                         device="cpu")
    init, step, put_x = t_pp.make_pp_train_step(
        model, Adam(1e-2), _cpu_mesh((1, 8), ("data", "pipe")),
        n_microbatches=2)
    x = np.random.default_rng(1).normal(size=(4, 8, 6)).astype(np.float32)
    state, _ = step(init(), put_x(x))
    kern = state.params["blocks"]["attn.qkv.weight"]
    assert [tuple(s.shape) for s in kern.shards] == [(1, 48, 16)] * 8
    assert kern.shape == (8, 48, 16)
    # each stage's Adam moments are its own slice's
    mu = state.opt_state.mu
    assert tuple(mu[("blocks", "attn.qkv.weight", 3)].shape) == (1, 48, 16)
    assert tuple(mu[("static", "embed.weight", 0)].shape) == (16, 6)


def test_pp_refuses_as_jax():
    mesh = _cpu_mesh((2, 4), ("data", "pipe"))
    model = SensorFormer(features=6, d_model=16, num_heads=2, num_layers=3,
                         device="cpu")
    with pytest.raises(ValueError, match="num_layers=3 not divisible by "
                                         "pipe=4"):
        t_pp.make_pp_train_step(model, Adam(), mesh, n_microbatches=2)
    ring = SensorFormer(features=6, d_model=16, num_heads=2, num_layers=4,
                        attn_mode="ring", device="cpu")
    with pytest.raises(ValueError, match="attn_mode='ring' cannot compose"):
        t_pp.make_pp_train_step(ring, Adam(), mesh, n_microbatches=2)
    j_mesh = j_make_mesh((2, 4), ("data", "pipe"))
    for layers, mode, msg in ((3, "dense", "not divisible"),
                              (4, "ring", "cannot compose")):
        with pytest.raises(ValueError, match=msg):
            j_pp.make_pp_train_step(
                JSensorFormer(features=6, d_model=16, num_heads=2,
                              num_layers=layers, attn_mode=mode),
                optax.sgd(0.1), j_mesh, n_microbatches=2)
