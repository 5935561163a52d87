"""The split-TF32 arithmetic of the float32 flash kernels at D = 8 and
16, forward and backward, modelled on the CPU
(``iotml_torch/ops/tf32x3.py``): the rounding ``cvt.rn.tf32.f32`` does
(the kernels'), beside ``cvt.rna.tf32.f32``'s (ties away, modelled here
only); the forward's two products each as three tf32 products, held
against the JAX package's Pallas forward in interpret mode at the f32
flash forward bound, O and LSE rtol = atol = 2e-5
(tests/test_attention.py:56-57); and the backward's five products, held
against its Pallas backward at the f32 flash-grad bound, rtol 1e-4 /
atol 1e-5 (tests/test_attention.py:70-71).  One-pass TF32 must fail each
bound, so the bound is shown to see TF32's error.  The kernels themselves
are held on the card (tests/test_torch_cuda_attention.py,
``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iotml.ops import attention as j_attn
from iotml_torch.ops import tf32x3

F32_TOL = dict(rtol=1e-4, atol=1e-5)
FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _round_rna(x):
    """``cvt.rna.tf32.f32``: round to nearest with ties away from zero, by
    adding half a unit to the magnitude and clearing the 13 dropped bits
    (inf and NaN kept).  The kernels round with ``cvt.rn`` instead: on
    sm_90 ``cvt.rna`` is emulated in several instructions."""
    bits = _bits(x)
    mag = bits & 0x7FFFFFFF
    rounded = ((mag + 0x1000) & ~0x1FFF) & 0x7FFFFFFF
    out = torch.where((mag & 0x7F800000) == 0x7F800000, mag, rounded) \
        | (bits & 0x80000000)
    return _f32(out.tolist())


#: the rounding each ``ties`` names: the model's (the kernels') or rna
ROUND = {"even": tf32x3.tf32_round, "away": _round_rna}


#: (bits given, rounded with ties to even, rounded with ties away)
EDGES = [
    # 1 + 2^-11, a tie whose kept bits are even: even stays, away goes up
    (0x3F801000, 0x3F800000, 0x3F802000),
    # just under the tie rounds down, just over rounds up, in both
    (0x3F800FFF, 0x3F800000, 0x3F800000),
    (0x3F801001, 0x3F802000, 0x3F802000),
    # a tie whose kept bits are odd: up in both
    (0x3F803000, 0x3F804000, 0x3F804000),
    # negative ties: the magnitude rounds as a positive one
    (0xBF801000, 0xBF800000, 0xBF802000),
    (0xBF803000, 0xBF804000, 0xBF804000),
    # the mantissa carries into the exponent: (2 - 2^-23) -> 2
    (0x3FFFFFFF, 0x40000000, 0x40000000),
    # the largest float rounds to inf
    (0x7F7FFFFF, 0x7F800000, 0x7F800000),
    # subnormals round in the same bit field; the smallest to 0
    (0x00001000, 0x00000000, 0x00002000),
    (0x00003000, 0x00004000, 0x00004000),
    (0x00000001, 0x00000000, 0x00000000),
    (0x007FFFFF, 0x00800000, 0x00800000),
    # signed zeros, inf and NaN are kept
    (0x00000000, 0x00000000, 0x00000000),
    (0x80000000, 0x80000000, 0x80000000),
    (0x7F800000, 0x7F800000, 0x7F800000),
    (0xFF800000, 0xFF800000, 0xFF800000),
    (0x7FC00000, 0x7FC00000, 0x7FC00000),
    (0x7FFFFFFF, 0x7FFFFFFF, 0x7FFFFFFF),
]


@pytest.mark.parametrize("ties", ["even", "away"])
@pytest.mark.parametrize("given,even,away", EDGES,
                         ids=[f"{e[0]:#010x}" for e in EDGES])
def test_tf32_round_edge_values(given, even, away, ties):
    got = ROUND[ties](_f32([given]))
    assert int(_bits(got)[0]) == (even if ties == "even" else away)


@pytest.mark.parametrize("ties", ["even", "away"])
def test_tf32_round_keeps_ten_mantissa_bits_and_is_nearest(ties):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=10_000).astype(np.float32)
                         * np.float32(1e3))
    r = ROUND[ties](x)
    assert int((_bits(r) & 0x1FFF).max()) == 0
    # within half a tf32 unit (2^-11 relative), and idempotent
    rel = ((r.double() - x.double()).abs() / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -11
    assert torch.equal(ROUND[ties](r), r)


def test_hi_plus_lo_is_exact_for_22_bit_values():
    """Values with at most 22 significant bits split exactly: hi + lo ==
    x; in general the split keeps x to 2^-22 relative."""
    rng = np.random.default_rng(1)
    mant = rng.integers(2 ** 21, 2 ** 22, size=5_000)
    sign = rng.choice([-1.0, 1.0], size=5_000)
    x = torch.from_numpy((sign * np.ldexp(mant.astype(np.float64),
                                          rng.integers(-40, 40, 5_000)
                                          - 21)).astype(np.float32))
    hi, lo = tf32x3.split(x)
    assert int((_bits(hi) & 0x1FFF).max()) == 0
    assert int((_bits(lo) & 0x1FFF).max()) == 0
    assert torch.equal(hi + lo, x)
    y = torch.from_numpy(rng.normal(size=5_000).astype(np.float32))
    hi, lo = tf32x3.split(y)
    rel = ((hi.double() + lo.double() - y.double()).abs()
           / y.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


def test_split_matmul_terms():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(16, 48)).astype(np.float32))
    exact = a.double() @ b.double()
    err = {n: float((tf32x3.split_matmul(a, b, n).double() - exact).abs()
                    .max()) for n in (1, 3)}
    plain = float((a @ b - exact).abs().max())
    assert err[1] > 100 * plain
    assert err[3] <= 4 * plain
    with pytest.raises(ValueError):
        tf32x3.split_matmul(a, b, 2)


#: B=2, H=2; ragged T causal; full T a multiple of the block
CASES = [(T, D, causal, block) for D in (8, 16)
         for T, causal, block in ((100, True, 32), (257, True, 64),
                                  (100, False, 50), (257, False, 257))]
#: shorter ones, for three terms only: a key tile of 17 or 65 rows a
#: block or two past the last full one, and full T at two blocks
SHORT_CASES = [(T, D, causal, block) for D in (8, 16)
               for T, causal, block in ((17, True, 16), (65, True, 32),
                                        (48, False, 16), (64, False, 32))]


def _jax_case(T, D, causal, block):
    rng = np.random.default_rng(T + D + causal)
    q, k, v, do = (rng.normal(size=(2, T, 2, D)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    out, lse = j_attn._flash_forward(jq, jk, jv, causal, block, block, True)
    want = j_attn._flash_backward(jq, jk, jv, out, lse, jdo, causal, block,
                                  block, True)
    ins = [torch.from_numpy(np.array(a)) for a in (q, k, v, out, lse, do)]
    return ins, [np.asarray(w) for w in want]


def _outside(got, want) -> int:
    """How many elements of the (dq, dk, dv) pairs fall outside F32_TOL."""
    return sum(int((np.abs(g.numpy() - w) > F32_TOL["atol"]
                    + F32_TOL["rtol"] * np.abs(w)).sum())
               for g, w in zip(got, want))


@pytest.mark.parametrize("T,D,causal,block", CASES + SHORT_CASES)
def test_three_term_split_holds_the_f32_grad_bound(T, D, causal, block):
    """Three terms, rounded as the kernels round (ties to even), hold the
    bound."""
    (q, k, v, o, lse, do), want = _jax_case(T, D, causal, block)
    got = tf32x3.flash_attention_backward_split(q, k, v, o, lse, do, causal,
                                                block, block, terms=3)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == (2, T, 2, D) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"d{name}",
                                   **F32_TOL)


@pytest.mark.parametrize("T,D,causal,block", CASES)
def test_one_pass_tf32_fails_the_f32_grad_bound(T, D, causal, block):
    """The same check with one tf32 product per product fails: the
    bound sees TF32's 2^-11 rounding, so passing it says something."""
    (q, k, v, o, lse, do), want = _jax_case(T, D, causal, block)
    got = tf32x3.flash_attention_backward_split(q, k, v, o, lse, do, causal,
                                                block, block, terms=1)
    assert _outside(got, want) > 0


#: the forward's cases (B=2, H=2): ragged and whole-block causal T, full
#: T a multiple of the block
FWD_CASES = [(T, D, causal, block) for D in (8, 16)
             for T, causal, block in ((17, True, 16), (64, True, 32),
                                      (65, True, 32), (128, True, 64),
                                      (48, False, 16), (64, False, 32))]


def _jax_forward_case(T, D, causal, block):
    rng = np.random.default_rng(100 + T + D + causal)
    q, k, v = (rng.normal(size=(2, T, 2, D)).astype(np.float32)
               for _ in range(3))
    out, lse = j_attn._flash_forward(*map(jnp.asarray, (q, k, v)), causal,
                                     block, block, True)
    return ([torch.from_numpy(a) for a in (q, k, v)],
            (np.asarray(out), np.asarray(lse)))


def _forward_outside(got, want) -> int:
    """How many elements of (o, lse) fall outside FWD_TOL."""
    return sum(int((np.abs(g.numpy() - w) > FWD_TOL["atol"]
                    + FWD_TOL["rtol"] * np.abs(w)).sum())
               for g, w in zip(got, want))


@pytest.mark.parametrize("T,D,causal,block", FWD_CASES)
def test_three_term_split_holds_the_f32_forward_bound(T, D, causal, block):
    """The forward with Q·Kᵀ and P·V in three tf32 terms, rounded as the
    kernel rounds, holds O and LSE at 2e-5 of JAX's Pallas forward."""
    (q, k, v), (want_o, want_lse) = _jax_forward_case(T, D, causal, block)
    o, lse = tf32x3.flash_attention_forward_split(q, k, v, causal, block,
                                                  block, terms=3)
    assert o.shape == (2, T, 2, D) and o.dtype == torch.float32
    assert lse.shape == (2, 2, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), want_o, err_msg="O", **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, err_msg="LSE",
                               **FWD_TOL)


@pytest.mark.parametrize("T,D,causal,block", FWD_CASES)
def test_one_pass_tf32_fails_the_f32_forward_bound(T, D, causal, block):
    """The same check with one tf32 product per product fails: the
    forward's bound sees TF32's 2^-11 rounding."""
    (q, k, v), want = _jax_forward_case(T, D, causal, block)
    got = tf32x3.flash_attention_forward_split(q, k, v, causal, block,
                                               block, terms=1)
    assert _forward_outside(got, want) > 0


def test_split_model_refuses_bfloat16():
    x = torch.zeros((1, 8, 1, 8), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 8))
    with pytest.raises(ValueError):
        tf32x3.flash_attention_backward_split(x, x, x, x, lse, x)
    with pytest.raises(ValueError):
        tf32x3.flash_attention_forward_split(x, x, x)
    with pytest.raises(ValueError):
        tf32x3.tf32_round(x)
    with pytest.raises(ValueError):
        tf32x3.tf32_round(torch.zeros(3, dtype=torch.float64))
