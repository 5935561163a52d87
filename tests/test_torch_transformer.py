"""The port's SensorFormer held against the flax model on the same params.

Params are made by flax from a seed and carried across with
``sensorformer_params_from_jax``; inputs are numpy from a seed.  The flax
flash path runs its Pallas kernel in interpret mode
(``attn_mode="flash_interpret"``); the port's ``flash`` mode takes the
kernel's plain version for CPU tensors.  Tolerances: predictions rtol =
atol = 2e-4, the JAX suite's flash-vs-dense model bound
(tests/test_transformer_sp.py:36-39); anomaly scores on equal inputs
1e-6; the param round trip exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.models.transformer import SensorFormer as JSensorFormer
from iotml_torch.models.convert import (sensorformer_params_from_jax,
                                        sensorformer_params_to_jax)
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops.attention import flash_attention

MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
SMALL = dict(features=18, d_model=32, num_heads=2, num_layers=1)


def _x(B=3, T=40, F=18, seed=0):
    return np.random.default_rng(seed).normal(size=(B, T, F)).astype(
        np.float32)


def _flax(cfg, x, seed=1, attn_mode="dense"):
    model = JSensorFormer(**cfg, attn_mode=attn_mode)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return model, jax.tree.map(np.asarray, params)


def _port(cfg, tree, attn_mode):
    model = SensorFormer(**cfg, attn_mode=attn_mode, device="cpu")
    model.load_state_dict(sensorformer_params_from_jax(tree))
    return model.eval()


def test_param_tree_round_trips_exactly():
    j_model, tree = _flax(dict(num_layers=2), _x(T=8))
    state = sensorformer_params_from_jax(tree)
    port = SensorFormer(device="cpu")
    assert set(state) == set(port.state_dict())
    for name, t in port.state_dict().items():
        assert state[name].shape == t.shape, name
    back = sensorformer_params_to_jax(state, num_heads=4)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cfg,T,port_mode,flax_mode", [
    (SMALL, 40, "dense", "dense"),
    (SMALL, 40, "flash", "flash_interpret"),
    (SMALL, 40, "flash_reference", "flash_interpret"),
    ({}, 64, "flash", "flash_interpret"),
], ids=["small-dense", "small-flash", "small-flash_reference",
        "full-width-flash"])
def test_sensorformer_matches_flax(cfg, T, port_mode, flax_mode):
    x = _x(T=T)
    j_model, tree = _flax(cfg, x, attn_mode=flax_mode)
    want = np.asarray(j_model.apply({"params": tree}, jnp.asarray(x)))
    before = dict(flash_attention.launches)
    with torch.no_grad():
        got = _port(cfg, tree, port_mode)(torch.from_numpy(x)).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert flash_attention.launches == before  # CPU: no kernel


@pytest.mark.parametrize("shape", ["T", "BT"])
def test_sensorformer_positions_match_flax(shape):
    x = _x(B=2, T=24, seed=3)
    rng = np.random.default_rng(4)
    pos = rng.integers(0, 4096, size=(24,) if shape == "T" else (2, 24))
    j_model, tree = _flax(SMALL, x)
    want = np.asarray(j_model.apply({"params": tree}, jnp.asarray(x),
                                    jnp.asarray(pos)))
    with torch.no_grad():
        got = _port(SMALL, tree, "flash")(torch.from_numpy(x),
                                          torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, **MODEL_TOL)


def test_anomaly_scores_match_flax():
    rng = np.random.default_rng(5)
    pred = rng.normal(size=(3, 40, 18)).astype(np.float32)
    x = rng.normal(size=(3, 40, 18)).astype(np.float32)
    want = np.asarray(JSensorFormer.anomaly_scores(jnp.asarray(pred),
                                                   jnp.asarray(x)))
    got = SensorFormer.anomaly_scores(torch.from_numpy(pred),
                                      torch.from_numpy(x)).numpy()
    assert got.shape == (3, 39)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sequence_over_max_len_raises_as_flax_does():
    cfg = dict(SMALL, max_len=16)
    x = _x(B=1, T=20)
    j_model = JSensorFormer(**cfg)
    with pytest.raises(ValueError, match="max_len"):
        j_model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="max_len"):
        SensorFormer(**cfg, device="cpu")(torch.from_numpy(x))


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SensorFormer()


def test_ring_mode_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        SensorFormer(attn_mode="ring", device="cpu")
    with pytest.raises(ValueError, match="unknown attn_mode"):
        SensorFormer(attn_mode="sparse", device="cpu")


def test_same_seed_same_weights_and_scores_on_cpu():
    x = torch.from_numpy(_x(B=2, T=20, seed=6))
    a = SensorFormer(**SMALL, device="cpu",
                     generator=torch.Generator().manual_seed(3))
    b = SensorFormer(**SMALL, attn_mode="flash", device="cpu",
                     generator=torch.Generator().manual_seed(3))
    for (na, ta), (nb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert na == nb and torch.equal(ta, tb)
    with torch.no_grad():
        sa = SensorFormer.anomaly_scores(a(x), x)
        sb = SensorFormer.anomaly_scores(b(x), x)
    assert sa.shape == (2, 19) and bool(torch.isfinite(sa).all())
    torch.testing.assert_close(sa, sb, **MODEL_TOL)
