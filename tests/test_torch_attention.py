"""The port's attention ops held against ``iotml.ops.attention``.

Same inputs (numpy, from a seed) through both packages.  The JAX flash
path runs its Pallas kernel in interpret mode, as tests/test_attention.py
does.  Tolerances:

- ``attention_reference`` and the blockwise fold: 1e-5 (float32 sums in
  another order);
- ``flash_attention_reference`` against JAX ``flash_attention`` /
  ``_flash_forward`` in float32: 2e-5 on O and LSE, the JAX suite's flash
  forward bound (tests/test_attention.py:56-57);
- bfloat16: O atol = rtol = 2e-2 compared in float32, LSE atol 1e-3 —
  P is rounded to bfloat16 before P·V, at the running max of each tile.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.ops import attention as j_attn
from iotml_torch.ops import attention as t_attn

F32_TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(B=2, T=32, H=2, D=8, seed=0, Tk=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    k = rng.normal(size=(B, Tk or T, H, D)).astype(np.float32)
    v = rng.normal(size=(B, Tk or T, H, D)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal,q_offset,k_offset,Tk", [
    (True, 0, 0, None), (False, 0, 0, None), (True, 16, 0, None),
    (True, 32, 16, 48), (False, 8, 0, 16)])
def test_attention_reference_matches_jax(causal, q_offset, k_offset, Tk):
    q, k, v = _qkv(T=32, Tk=Tk, seed=1)
    want = j_attn.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      q_offset=q_offset, k_offset=k_offset)
    got = t_attn.attention_reference(*_t(q, k, v), causal=causal,
                                     q_offset=q_offset, k_offset=k_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_blockwise_update_folded_equals_reference():
    """Folding KV in 4 blocks through the online softmax == the full
    softmax, and each step equals JAX's."""
    q, k, v = _qkv(T=32)
    B, T, H, D = q.shape
    scale = 1.0 / np.sqrt(D)
    o = torch.zeros((B, T, H, D))
    m = torch.full((B, H, T), t_attn.NEG_INF)
    l = torch.zeros((B, H, T))
    jo = jnp.zeros((B, T, H, D), jnp.float32)
    jm = jnp.full((B, H, T), -1e30, jnp.float32)
    jl = jnp.zeros((B, H, T), jnp.float32)
    qt, kt, vt = _t(q, k, v)
    qpos = np.arange(T)
    for blk in range(4):
        sl = slice(blk * 8, (blk + 1) * 8)
        mask = qpos[:, None] >= qpos[sl][None, :]
        o, m, l = t_attn.blockwise_update(o, m, l, qt, kt[:, sl], vt[:, sl],
                                          scale, torch.from_numpy(mask))
        jo, jm, jl = j_attn.blockwise_update(
            jo, jm, jl, jnp.asarray(q), jnp.asarray(k[:, sl]),
            jnp.asarray(v[:, sl]), scale, jnp.asarray(mask))
        for got, want in ((o, jo), (m, jm), (l, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    got = t_attn.finalize_blockwise(o, l)
    want = t_attn.attention_reference(qt, kt, vt, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(j_attn.finalize_blockwise(jo, jl)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,block,causal", [
    (32, 16, True), (40, 16, True), (32, 16, False), (40, 8, False)])
def test_flash_reference_matches_jax_interpret(T, block, causal):
    q, k, v = _qkv(T=T, seed=T + causal)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want = j_attn.flash_attention(jq, jk, jv, causal, block, block, True)
    want_o, want_lse = j_attn._flash_forward(jq, jk, jv, causal, block,
                                             block, True)
    got_o, got_lse = t_attn.flash_attention_reference(*_t(q, k, v), causal,
                                                      block, block)
    assert got_o.shape == (2, T, 2, 8) and got_lse.shape == (2, 2, T)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **F32_TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               **F32_TOL)


@pytest.mark.parametrize("T,block,causal", [(40, 16, True), (32, 16, False)])
def test_flash_reference_bf16_matches_jax_interpret(T, block, causal):
    q, k, v = (a.astype(jnp.bfloat16) for a in _qkv(T=T, seed=7))
    want_o, want_lse = j_attn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, block, block,
        True)
    got_o, got_lse = t_attn.flash_attention_reference(
        *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (q, k, v)), causal, block, block)
    assert got_o.dtype == torch.bfloat16 and got_lse.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o).astype(np.float32),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=1e-3)


def test_flash_reference_equals_dense_where_blocks_do_not_matter():
    """f32: the plain version at block 8 and at block 64 agree with the
    dense reference (the tiling changes rounding only)."""
    q, k, v = _t(*_qkv(T=48, seed=3))
    want = t_attn.attention_reference(q, k, v, causal=True)
    for block in (8, 64):
        got, _ = t_attn.flash_attention_reference(q, k, v, True, block, block)
        torch.testing.assert_close(got, want, **F32_TOL)


def test_non_causal_ragged_raises_as_jax_does():
    q, k, v = _qkv(T=40)
    with pytest.raises(ValueError, match="T % 16 == 0"):
        j_attn.flash_attention(*map(jnp.asarray, (q, k, v)), False, 16, 16,
                               True)
    with pytest.raises(ValueError, match="T % 16 == 0"):
        t_attn.flash_attention(*_t(q, k, v), False, 16, 16)
    with pytest.raises(ValueError, match="T % 16 == 0"):
        t_attn.flash_attention_fwd(*_t(q, k, v), False, 16, 16)


def test_flash_attention_on_cpu_takes_the_plain_version():
    q, k, v = _t(*_qkv(T=40, seed=5))
    before = dict(t_attn.flash_attention.launches)
    got = t_attn.flash_attention(q, k, v, True, 16, 16)
    got_o, got_lse = t_attn.flash_attention_fwd(q, k, v, True, 16, 16)
    want_o, want_lse = t_attn.flash_attention_reference(q, k, v, True, 16, 16)
    assert torch.equal(got, want_o) and torch.equal(got_o, want_o)
    assert torch.equal(got_lse, want_lse)
    assert t_attn.flash_attention.launches == before


def test_flash_attention_backward_raises_on_cpu():
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(T=16)))
    out = t_attn.flash_attention(q, k, v, True, 8, 8)
    with pytest.raises(NotImplementedError, match="B4-B7"):
        out.sum().backward()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_attention_backward_raises_on_cuda(cuda_device):
    q, k, v = (t.to(cuda_device).requires_grad_()
               for t in _t(*_qkv(T=16, D=16)))
    out = t_attn.flash_attention(q, k, v, True, 8, 8)
    with pytest.raises(NotImplementedError, match="B4-B7"):
        out.sum().backward()
