"""The port's flash-attention backward held against ``iotml.ops.attention``.

Same inputs (numpy, from a seed) through both packages.  The JAX side runs
its Pallas backward kernels in interpret mode: causal calls at these sizes
take the triangular-grid pair (``_flash_bwd_dkv_kernel_tri`` /
``_flash_bwd_dq_kernel_tri``), non-causal ones the dense-grid pair
(``_flash_bwd_dkv_kernel`` / ``_flash_bwd_dq_kernel``).  Both backward
paths are fed the JAX forward's own ``out`` and ``lse``.  Tolerances:

- float32: rtol 1e-4 / atol 1e-5, the JAX suite's flash-grad bound
  (tests/test_attention.py:70-71);
- bfloat16: rtol 1e-2 / atol 1e-3 compared in float32.  P comes from the
  LSE, not a running max, so blocks change only the order of the f32
  sums; what is left is the rounding of each output to bfloat16, at most
  one unit in the last place (2^-7 of the value), and the rare p or ds
  that rounds to the other neighbour.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.ops import attention as j_attn
from iotml_torch.ops import attention as t_attn

F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_TOL = dict(rtol=1e-2, atol=1e-3)


def _inputs(B=2, T=40, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, D)).astype(np.float32)
            for _ in range(4)]


def _torch(a, dtype):
    """A JAX array (any float dtype) → a torch tensor of ``dtype``."""
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,block,causal", [
    (40, 16, True), (32, 16, True), (32, 16, False)],
    ids=["tri-ragged", "tri", "dense"])
def test_backward_reference_matches_jax_interpret(T, block, causal, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    q, k, v, do = (jnp.asarray(a).astype(jdt)
                   for a in _inputs(T=T, seed=T + causal))
    out, lse = j_attn._flash_forward(q, k, v, causal, block, block, True)
    want = j_attn._flash_backward(q, k, v, out, lse, do, causal, block,
                                  block, True)
    got = t_attn.flash_attention_backward_reference(
        *(_torch(a, tdt) for a in (q, k, v, out)),
        torch.from_numpy(np.array(lse)), _torch(do, tdt), causal, block,
        block)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (2, T, 2, 8) and g.dtype == tdt, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=f"d{name}", **tol)


@pytest.mark.parametrize("T,causal", [(130, True), (200, True), (192, False)],
                         ids=["tri-130", "tri-200", "dense-192"])
def test_backward_reference_at_the_wgmma_tiles_matches_jax_interpret(
        T, causal):
    """bf16 at D=128 with blocks of 64, the tensor-core kernels' own
    tiles: ragged T causal, and non-causal where T is a multiple of 64."""
    q, k, v, do = (jnp.asarray(a).astype(jnp.bfloat16)
                   for a in _inputs(B=1, T=T, H=2, D=128, seed=T))
    out, lse = j_attn._flash_forward(q, k, v, causal, 64, 64, True)
    want = j_attn._flash_backward(q, k, v, out, lse, do, causal, 64, 64,
                                  True)
    got = t_attn.flash_attention_backward_reference(
        *(_torch(a, torch.bfloat16) for a in (q, k, v, out)),
        torch.from_numpy(np.array(lse)), _torch(do, torch.bfloat16), causal,
        64, 64)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (1, T, 2, 128) and g.dtype == torch.bfloat16, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   err_msg=f"d{name}", **BF16_TOL)


def test_flash_attention_grads_match_jax_grad():
    """tests/test_attention.py's grad case: Σ sin(out), causal, T=40,
    blocks 16; the port's autograd (the plain backward on CPU tensors)
    against jax.grad of the dense reference and of the Pallas kernel."""
    q, k, v = _inputs(T=40)[:3]
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def dense(q, k, v):
        return jnp.sum(jnp.sin(j_attn.attention_reference(q, k, v, True)))

    def pallas(q, k, v):
        return jnp.sum(jnp.sin(j_attn.flash_attention(q, k, v, True, 16, 16,
                                                      True)))

    want_dense = jax.grad(dense, argnums=(0, 1, 2))(jq, jk, jv)
    want_pallas = jax.grad(pallas, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = t_attn.flash_attention(tq, tk, tv, True, 16, 16)
    got = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    for g, wd, wp in zip(got, want_dense, want_pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(wd), **F32_TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_reference_equals_dense_autograd_for_any_blocks(causal):
    """f32: blocks 8 and 64 give dense attention's autograd grads (the
    tiling changes the order of the sums only)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T=64, seed=3))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        t_attn.attention_reference(*leaves, causal=causal), leaves, do)
    for block in (8, 64):
        o, lse = t_attn.flash_attention_reference(q, k, v, causal, block,
                                                  block)
        got = t_attn.flash_attention_backward_reference(
            q, k, v, o, lse, do, causal, block, block)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_through_the_plain_forward_matches_the_plain_backward(
        causal):
    """Autograd through ``flash_attention_reference`` (the
    ``flash_reference`` training path) gives the plain backward's grads."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T=48, seed=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _ = t_attn.flash_attention_reference(*leaves, causal, 16, 16)
    got = torch.autograd.grad(o, leaves, do)
    o, lse = t_attn.flash_attention_reference(q, k, v, causal, 16, 16)
    want = t_attn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     causal, 16, 16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **F32_TOL)


def test_flash_attention_bwd_on_cpu_takes_the_plain_version():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T=40, seed=5))
    o, lse = t_attn.flash_attention_fwd(q, k, v, True, 16, 16)
    before = dict(t_attn.flash_attention.launches)
    got = t_attn.flash_attention_bwd(q, k, v, o, lse, do, True, 16, 16)
    want = t_attn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     True, 16, 16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    only_k = t_attn.flash_attention_bwd(q, k, v, o, lse, do, True, 16, 16,
                                        needs=(False, True, False))
    assert only_k[0] is None and only_k[2] is None
    assert torch.equal(only_k[1], want[1])
    assert t_attn.flash_attention.launches == before


def test_autograd_honours_needs_input_grad():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T=32, seed=6))
    kk = k.clone().requires_grad_()
    out = t_attn.flash_attention(q, kk, v, True, 16, 16)
    (dk,) = torch.autograd.grad(out, (kk,), do)
    o, lse = t_attn.flash_attention_reference(q, k, v, True, 16, 16)
    want = t_attn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                     True, 16, 16)[1]
    assert torch.equal(dk, want)


def test_ragged_non_causal_and_foreign_devices_raise():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(T=40))
    lse = torch.zeros((2, 2, 40))
    with pytest.raises(ValueError, match="T % 16 == 0"):
        t_attn.flash_attention_backward_reference(q, k, v, q, lse, do,
                                                  False, 16, 16)
    with pytest.raises(ValueError, match="T % 16 == 0"):
        t_attn.flash_attention_bwd(q, k, v, q, lse, do, False, 16, 16)
    meta = [t.to("meta") for t in (q, k, v, q, lse, do)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_attn.flash_attention_bwd(*meta, True, 16, 16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        t_attn.flash_attention_fwd(*meta[:3], True, 16, 16)
