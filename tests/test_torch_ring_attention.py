"""The port's ring attention (``iotml_torch.parallel.ring_attention``)
and the mesh collectives it rides (``iotml_torch.parallel.mesh``) held
against the JAX package's on the CPU.

The JAX side runs ``tests/test_attention.py``'s cases on its eight
virtual CPU devices; the port runs them on eight ``torch.device("cpu")``
shards, from the same numpy draws.  Tolerances are the JAX suite's:
outputs rtol = atol 1e-5 (the ring's bound, tests/test_attention.py:80),
gradients rtol 1e-4 / atol 1e-5 (its flash-grad bound, :70-71); shapes,
pieces and collectives' results exact.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.ops.attention import attention_reference as j_attention
from iotml.parallel.mesh import make_mesh as j_make_mesh
from iotml.parallel.ring_attention import make_ring_attention as j_ring
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops.attention import attention_reference
from iotml_torch.parallel import mesh as t_mesh
from iotml_torch.parallel.data_parallel import put_global
from iotml_torch.parallel.mesh import (NamedSharding, P, make_mesh,
                                       shard_map)
from iotml_torch.parallel.ring_attention import (make_ring_attention,
                                                 ring_attention)

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _qkv(B=2, T=32, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, T, H, D)).astype(np.float32)
                 for _ in range(3))


def _seq_mesh(n):
    return make_mesh((n,), ("seq",), devices=[CPU] * n)


def _j_seq_mesh(n):
    return j_make_mesh((n,), ("seq",), devices=jax.devices()[:n])


@pytest.mark.parametrize("n,T,causal,seed", [(8, 64, True, 0),
                                             (4, 32, False, 3),
                                             (4, 32, True, 1),
                                             (8, 64, False, 2)])
def test_ring_attention_matches_jax_and_reference(n, T, causal, seed):
    q, k, v = _qkv(T=T, seed=seed)
    want = np.asarray(j_ring(_j_seq_mesh(n), "seq", causal=causal)(
        *map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(
        want, np.asarray(j_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal)), **OUT_TOL)
    out = make_ring_attention(_seq_mesh(n), "seq", causal=causal)(q, k, v)
    assert len(out.shards) == n and out.shape == q.shape
    assert [tuple(s.shape) for s in out.shards] == \
        [(2, T // n, 2, 8)] * n
    got = out.numpy()
    np.testing.assert_allclose(got, want, **OUT_TOL)
    plain = attention_reference(*map(torch.from_numpy, (q, k, v)),
                                causal=causal).numpy()
    np.testing.assert_allclose(got, plain, **OUT_TOL)


@pytest.mark.parametrize("n,causal", [(8, True), (4, False)])
def test_ring_attention_grads_match_jax(n, causal):
    q, k, v = _qkv(T=32, seed=5)
    ring = j_ring(_j_seq_mesh(n), "seq", causal=causal)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(ring(*a))),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = make_ring_attention(_seq_mesh(n), "seq", causal=causal)(*ts)
    loss = sum(torch.sin(s).sum() for s in out.shards)
    got = torch.autograd.grad(loss, ts)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **GRAD_TOL)
    dense = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    plain = torch.autograd.grad(
        torch.sin(attention_reference(*dense, causal=causal)).sum(), dense)
    for g, w in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL)


def test_ring_attention_output_is_seq_sharded():
    q, k, v = _qkv(T=64)
    out = make_ring_attention(_seq_mesh(8), "seq")(q, k, v)
    j_out = j_ring(j_make_mesh((8,), ("seq",)), "seq")(
        *map(jnp.asarray, (q, k, v)))
    assert len(out.shards) == len(j_out.sharding.device_set) == 8
    assert out.sharding.spec == P(None, "seq", None, None)
    assert out.blocks == [(0, i, 0, 0) for i in range(8)]


def test_ring_attention_takes_sharded_inputs_and_a_two_axis_mesh():
    """Inputs already cut ``P('data', 'seq')`` on a (2, 4) mesh: each
    data row is its own ring."""
    q, k, v = _qkv(B=4, T=32, seed=7)
    mesh = make_mesh((2, 4), ("data", "seq"), devices=[CPU] * 8)
    spec = P("data", "seq")
    cut = [put_global(a, NamedSharding(mesh, spec)) for a in (q, k, v)]
    body = lambda q, k, v: ring_attention(q, k, v, "seq")  # noqa: E731
    out = shard_map(body, mesh, in_specs=(spec,) * 3, out_specs=spec)(*cut)
    want = attention_reference(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(out.numpy(), want, **OUT_TOL)


def test_ring_backward_keeps_no_hop_probabilities():
    """Each hop is rematerialised: what autograd keeps for the backward
    holds no ``[B, H, Tl, Tl]`` block (the probabilities), only blocks of
    the inputs' size."""
    q, k, v = _qkv(B=1, T=64, H=1, D=4, seed=2)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = make_ring_attention(_seq_mesh(4), "seq")(*ts)
    assert (1, 1, 16, 16) not in shapes
    assert all(int(np.prod(s)) <= 64 * 4 for s in shapes), shapes
    torch.autograd.grad(sum(s.sum() for s in out.shards), ts)


def test_ring_attention_outside_shard_map_raises_as_jax():
    q, k, v = map(torch.from_numpy, _qkv())
    with pytest.raises(NameError, match="unbound axis name: seq"):
        ring_attention(q, k, v, "seq")
    with pytest.raises(NameError, match="unbound axis name: seq"):
        SensorFormer(features=18, d_model=16, num_heads=2, num_layers=1,
                     attn_mode="ring", device="cpu")(
            torch.zeros(1, 4, 18))


def _j_collective(mesh, fn, spec):
    from iotml.parallel.mesh import shard_map as j_shard_map
    from jax.sharding import PartitionSpec as JP

    return j_shard_map(fn, mesh=mesh, in_specs=(JP(*spec),),
                       out_specs=JP(*spec), check_vma=False)


@pytest.mark.parametrize("kind", ["ppermute", "psum", "all_to_all",
                                  "all_to_all_back"])
def test_collectives_match_jax_lax(kind):
    """Each collective on a (2, 4) ('data', 'x') mesh, per data row, as
    ``jax.lax``'s under ``shard_map``; and its gradient as jax.grad's."""
    x = np.random.default_rng(3).normal(size=(2, 4 * 8, 6)).astype(
        np.float32)
    perm = [(0, 2), (2, 1), (1, 3), (3, 0)]
    j_ops = {
        "ppermute": lambda a: jax.lax.ppermute(a, "x", perm),
        "psum": lambda a: jax.lax.psum(a, "x"),
        "all_to_all": lambda a: jax.lax.all_to_all(a, "x", 1, 2,
                                                   tiled=True),
        "all_to_all_back": lambda a: jax.lax.all_to_all(a, "x", 2, 1,
                                                        tiled=True)}
    t_ops = {
        "ppermute": lambda a: t_mesh.ppermute(a, "x", perm),
        "psum": lambda a: t_mesh.psum(a, "x"),
        "all_to_all": lambda a: t_mesh.all_to_all(a, "x", 1, 2),
        "all_to_all_back": lambda a: t_mesh.all_to_all(a, "x", 2, 1)}
    if kind == "all_to_all_back":
        x = x.reshape(2, 8, 24)  # a local [1, 2, 24] block splits 4 ways
    spec = ("data", "x")
    j_mesh = j_make_mesh((2, 4), spec, devices=jax.devices()[:8])
    j_fn = _j_collective(j_mesh, j_ops[kind], spec)
    want = np.asarray(j_fn(jnp.asarray(x)))
    w = np.random.default_rng(4).normal(size=want.shape).astype(np.float32)
    want_g = np.asarray(jax.grad(
        lambda a: jnp.sum(j_fn(a) * w))(jnp.asarray(x)))
    mesh = make_mesh((2, 4), spec, devices=[CPU] * 8)
    t_fn = shard_map(t_ops[kind], mesh, in_specs=(P(*spec),),
                     out_specs=P(*spec))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = t_fn(xt)
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-6, atol=1e-6)
    whole = torch.cat([torch.cat(out.shards[r * 4:(r + 1) * 4], dim=1)
                       for r in range(2)])
    got_g, = torch.autograd.grad((whole * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(got_g.numpy(), want_g, rtol=1e-6, atol=1e-6)


def test_shards_that_diverge_raise():
    mesh = _seq_mesh(2)

    def body(x):
        if t_mesh.axis_index("seq") == 0:
            return t_mesh.psum(x, "seq")
        return x

    with pytest.raises(RuntimeError, match="diverged"):
        shard_map(body, mesh, in_specs=(P("seq"),), out_specs=P("seq"))(
            torch.zeros(4))


def test_a_shard_error_reaches_the_caller():
    mesh = _seq_mesh(4)

    def body(x):
        if t_mesh.axis_index("seq") == 2:
            raise KeyError("shard 2")
        return t_mesh.psum(x, "seq")

    with pytest.raises(KeyError, match="shard 2"):
        shard_map(body, mesh, in_specs=(P("seq"),), out_specs=P("seq"))(
            torch.zeros(8))


def test_one_shard_runs_at_a_time_under_a_short_switch_interval():
    """16 shards (more than this host's cores), 40 collectives each, the
    interpreter switching threads every microsecond: a read-modify-write
    of a plain dict in every shard body loses no update, since one shard
    runs at a time, and every psum holds the sum of the shard indices."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    box, done = {"n": 0, "sums": []}, {}
    mesh = make_mesh((16,), ("x",), devices=[CPU] * 16)

    def body(v):
        i = t_mesh.axis_index("x")
        for _ in range(40):
            n = box["n"]
            box["n"] = n + 1
            v = t_mesh.psum(v * 0 + i, "x")
            box["sums"].append(float(v.sum()))
        return v

    def run():
        done["out"] = shard_map(body, mesh, in_specs=(P("x"),),
                                out_specs=P("x"))(torch.zeros(16))

    try:
        t = threading.Thread(target=run, daemon=True, name="stress")
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the shards did not finish in 120 s"
    finally:
        sys.setswitchinterval(old)
    assert box["n"] == 16 * 40
    assert box["sums"] == [120.0] * (16 * 40)
    np.testing.assert_array_equal(done["out"].numpy(), np.full(16, 120.0))
