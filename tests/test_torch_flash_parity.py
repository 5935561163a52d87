"""The checks that hold the flash kernels' bfloat16 results against their
plain versions (``iotml_torch.ops.flash_parity``), on the CPU: they pass
what the plain version gives at other tiles, and fail a scaled O, a
rescale missed in one late row, and a backward error that one rounding
flip does not explain."""

import numpy as np
import pytest
import torch

from iotml_torch.ops import flash_parity as fp
from iotml_torch.ops.attention import (flash_attention_backward_reference,
                                       flash_attention_reference)


def _bf16(*shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _qkv(T, seed=0, D=128, H=2):
    return [_bf16(1, T, H, D, seed=seed + i) for i in range(4)]


@pytest.mark.parametrize("T,causal", [(200, True), (256, False)])
def test_forward_check_passes_the_plain_version_at_other_blocks(T, causal):
    """Blocks 32 against 64: P is rounded at other running maxima, more
    than the kernel's tiles change at blocks 64."""
    q, k, v, _ = _qkv(T)
    o, lse = flash_attention_reference(q, k, v, causal, 32, 32)
    want_o, want_lse = flash_attention_reference(q, k, v, causal, 64, 64)
    errs = fp.check_wgmma_forward("blocks 32", o, lse, want_o, want_lse, 32)
    assert 0 < errs["o_row_rel"] <= fp.O_ROW_REL_MAX
    fp.check_rejects_scaled_o("blocks 32", o, lse, want_o, want_lse, 32)


def test_element_bound_follows_the_blocks():
    """An element near 0 off by 2e-3 in a row of |O| near 1: inside the
    bound at other blocks (P rounded at other maxima), outside it at the
    kernel's own key tile."""
    want = _bf16(1, 4, 1, 128, seed=4)
    want[0, 0, 0, 0] = 0.0
    got = want.clone()
    got[0, 0, 0, 0] = 2e-3
    lse = torch.zeros(1, 1, 4)
    assert fp.wgmma_forward_faults(got, lse, want, lse, 1024) == []
    assert fp.wgmma_forward_faults(got, lse, want, lse, fp.KERNEL_KEY_TILE)


def test_forward_check_fails_o_scaled_by_0_9():
    q, k, v, _ = _qkv(200)
    o, lse = flash_attention_reference(q, k, v, True, 64, 64)
    assert fp.wgmma_forward_faults(o, lse, o, lse) == []
    scaled = (o.double() * 0.9).to(o.dtype)
    assert fp.wgmma_forward_faults(scaled, lse, o, lse)
    with pytest.raises(AssertionError):
        fp.check_wgmma_forward("scaled", scaled, lse, o, lse)


def test_row_check_sees_a_small_row_that_atol_misses():
    """Rows of |O| near 2e-3, as a row averaging 65,536 keys has: one row
    scaled by 0.9 passes element by element and fails the row check."""
    want = (_bf16(1, 8, 1, 128, seed=3).double() * 2e-3).to(torch.bfloat16)
    lse = torch.zeros(1, 1, 8)
    got = want.clone()
    got[0, -1, 0] = (got[0, -1, 0].double() * 0.9).to(torch.bfloat16)
    assert not bool(fp._outside(got.double(), want.double(),
                                **fp.WGMMA_O_TOL).any())
    assert fp.o_row_rel_err(got, want) > fp.O_ROW_REL_MAX
    assert fp.wgmma_forward_faults(got, lse, want, lse)


def _backward_case(T=96, causal=True):
    q, k, v, do = _qkv(T, seed=10)
    o, lse = flash_attention_reference(q, k, v, causal, 64, 64)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, causal,
                                              64, 64)
    return (q, k, v, o, lse, do), want


def test_no_flips_where_the_outputs_agree():
    inputs, want = _backward_case()
    assert fp.bwd_rounding_flips(*inputs, want, want, True) == []


def _nearest_flip(inputs, name, causal=True):
    """(row, column index, gap, midpoint distance) of the p or ds
    nearest a bf16 midpoint among the rows of ``name`` in head 0."""
    q = inputs[0]
    best = None
    for t in range(q.shape[1]):
        p, ds = fp._column(*inputs, causal, 0, 0, t,
                           "query" if name == "dq" else "key")
        x = p if name == "dv" else ds
        nz = x != 0
        gap, mid = fp._gap_and_mid(torch.where(nz, x, 1.0))
        mid = torch.where(nz, mid, 1.0)
        i = int(mid.argmin())
        if best is None or float(mid[i]) < best[3]:
            best = (t, i, float(gap[i]), float(mid[i]))
    return best


def _flipped(inputs, want, name, gaps=1.0):
    """``want`` with one row of ``name`` moved as a flip of ``gaps`` gaps
    of its nearest-midpoint p or ds would move it."""
    q, k, v, o, lse, do = inputs
    t, i, gap, mid = _nearest_flip(inputs, name)
    assert mid <= fp.FLIP_MID
    got = [w.double().clone() for w in want]
    which = "qkv".index(name[1])
    mult = {"dq": k, "dk": q, "dv": do}[name][0, i, 0].double()
    got[which][0, t, 0] += gaps * gap * mult
    return got, t, i


@pytest.mark.parametrize("name", ["dq", "dk", "dv"])
def test_one_rounding_flip_is_found_and_shown(name):
    inputs, want = _backward_case()
    got, t, i = _flipped(inputs, want, name)
    flips = fp.bwd_rounding_flips(*inputs, got, want, True, rtol=0.0,
                                  atol=1e-4)
    assert len(flips) == 1
    flip = flips[0]
    assert (flip["output"], flip["row"], flip["h"], flip["at"]) == \
        (name, t, 0, i)
    assert flip["flip_of"] == ("p" if name == "dv" else "ds")
    assert flip["err_after"] <= 1e-4 < flip["err_before"]


def test_two_gaps_are_not_a_flip():
    inputs, want = _backward_case()
    got, _, _ = _flipped(inputs, want, "dk", gaps=2.0)
    with pytest.raises(AssertionError, match="no single ds"):
        fp.bwd_rounding_flips(*inputs, got, want, True, rtol=0.0, atol=1e-4)


def test_an_error_of_one_element_is_not_a_flip():
    inputs, want = _backward_case()
    got = [w.double().clone() for w in want]
    got[1][0, 5, 1, 7] += 0.05
    with pytest.raises(AssertionError, match="dk row"):
        fp.bwd_rounding_flips(*inputs, got, want, True)


def test_flips_are_limited_in_number():
    """A flip explains a row only up to ``max_rows`` rows an output; with
    none allowed (the grid inputs' check) one flipped row fails."""
    inputs, want = _backward_case()
    got, _, _ = _flipped(inputs, want, "dk")
    assert len(fp.bwd_rounding_flips(*inputs, got, want, True, max_rows=1,
                                     rtol=0.0, atol=1e-4)) == 1
    with pytest.raises(AssertionError, match="more than the 0"):
        fp.bwd_rounding_flips(*inputs, got, want, True, max_rows=0,
                              rtol=0.0, atol=1e-4)
