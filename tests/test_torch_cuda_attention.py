"""Card-only checks of the flash-attention kernel and SensorFormer on
``cuda``.  Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_attention.py

Tolerances: float32 O and LSE 2e-5, the JAX suite's flash forward bound
(tests/test_attention.py:56-57); bfloat16 at D = 16 (the FMA design) O
atol = rtol = 2e-2 compared in float32 and LSE atol 1e-3, because P is
rounded to bfloat16 at the running max of each tile and the kernel's
tiles differ from the plain version's blocks; bfloat16 at D = 128 (the
``wgmma`` design) ``flash_parity.check_wgmma_forward``: each O row
within 1e-2 of its norm, O rtol 2e-2 / atol 1e-3 against the plain
version at the kernel's key tile (blocks 64; rtol = atol = 2e-2 at other
blocks), LSE atol 1e-3; the
model's predictions rtol = atol = 2e-4 (tests/test_transformer_sp.py:
36-39).  Backward: float32 dq, dk, dv rtol 1e-4 / atol 1e-5, the JAX
suite's flash-grad bound (tests/test_attention.py:70-71); bfloat16 rtol
1e-2 / atol 1e-3 in float32 (P comes from the LSE, so tiles change only
the order of the f32 sums: one bfloat16 rounding of each output, 2^-7 of
the value at most), where a row outside it passes only as one p or ds
rounding flip (``flash_parity.bwd_rounding_flips``: kernel and plain
version sum Q·Kᵀ and dO·Vᵀ in f32 in different orders, so a p or ds at a
bf16 midpoint rounds apart); on inputs rounded to multiples of 1/4 those
sums are exact in any order, and no flip is allowed; a training step's
loss rtol 1e-5 and grads rtol 1e-4 / atol 1e-6
(tests/test_torch_seq_parallel.py).  The bf16 D=128 cases run the
tensor-core design in both directions (``flash_design`` says "wgmma");
f32 at D = 8 and 16 the split-TF32 one ("mma_tf32x3"), both directions;
the others the FMA one.  The tensor-core cases hold the kernels against
the plain versions at the kernels' own 64-row tiles (blocks 64), so that
P is rounded at the same running max.
"""

import numpy as np
import pytest
import torch

from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops import attention as attn
from iotml_torch.ops import flash_parity as fp
from iotml_torch.parallel.seq_parallel import loss_and_grads

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_O_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LSE_TOL = dict(rtol=0, atol=1e-3)
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5)}
BWD_KEYS = ("bwd_dkv_causal", "bwd_dq_causal", "bwd_dkv_full",
            "bwd_dq_full")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(B, T, H, D, dtype, device, seed=0, grid=False):
    """Three seeded normal tensors; ``grid`` rounds them to multiples of
    1/4 (see the module's note on the bf16 backward cases)."""
    rng = np.random.default_rng(seed)
    ts = [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3)]
    if grid:
        ts = [np.round(t * 4) / 4 for t in ts]
    return [torch.from_numpy(t).to(device, dtype) for t in ts]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,T,H,D,causal,block", [
    (torch.float32, 2, 40, 2, 8, True, 16),
    (torch.float32, 2, 32, 2, 8, False, 16),
    (torch.float32, 2, 300, 4, 16, True, 128),
    (torch.float32, 1, 256, 4, 16, False, 128),
    (torch.bfloat16, 1, 200, 2, 128, True, 128),
    (torch.bfloat16, 1, 256, 2, 128, False, 128),
    (torch.bfloat16, 2, 72, 2, 16, True, 16),
])
def test_kernel_matches_plain_version(dtype, B, T, H, D, causal, block,
                                      cuda_device):
    q, k, v = _qkv(B, T, H, D, dtype, cuda_device, seed=T + D)
    entry = "causal" if causal else "full"
    before = dict(attn.flash_attention.launches)
    o, lse = attn.flash_attention_fwd(q, k, v, causal, block, block)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches[entry] == before[entry] + 1
    want_o, want_lse = attn.flash_attention_reference(q, k, v, causal,
                                                      block, block)
    assert o.shape == q.shape and o.dtype == dtype
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    if attn.flash_design(dtype, D, "forward") == "wgmma":
        fp.check_wgmma_forward("forward", o, lse, want_o, want_lse, block)
    else:
        o_tol = F32_TOL if dtype == torch.float32 else BF16_O_TOL
        lse_tol = F32_TOL if dtype == torch.float32 else BF16_LSE_TOL
        torch.testing.assert_close(o.float(), want_o.float(), **o_tol)
        torch.testing.assert_close(lse, want_lse, **lse_tol)
    # a second launch repeats the first bit for bit
    o2, lse2 = attn.flash_attention_fwd(q, k, v, causal, block, block)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert attn.flash_attention.launches[entry] == before[entry] + 2


@pytest.mark.cuda
def test_flash_attention_launches_the_kernel(cuda_device):
    q, k, v = _qkv(2, 50, 4, 16, torch.float32, cuda_device, seed=1)
    before = attn.flash_attention.launches["causal"]
    got = attn.flash_attention(q, k, v)
    assert attn.flash_attention.launches["causal"] == before + 1
    want = attn.attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(got, want, **F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "head_dim", "dtype", "shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, cuda_device):
    q, k, v = _qkv(1, 40, 2, 16, torch.float32, cuda_device)
    causal = True
    if case == "ragged":
        causal = False
    elif case == "head_dim":
        q, k, v = _qkv(1, 40, 2, 32, torch.float32, cuda_device)
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    else:
        k = k[:, :32]
    before = dict(attn.flash_attention.launches)
    with pytest.raises(ValueError):
        attn.flash_attention_fwd(q, k, v, causal, 16, 16)
    assert attn.flash_attention.launches == before


@pytest.mark.cuda
def test_backward_on_the_card_launches_both_kernels(cuda_device):
    """flash_attention(...).backward launches the dK/dV and dQ kernels
    once each, causal entries only, and gives the plain backward's
    grads."""
    q, k, v = (t.requires_grad_() for t in
               _qkv(1, 16, 2, 16, torch.float32, cuda_device))
    do = _qkv(1, 16, 2, 16, torch.float32, cuda_device, seed=9)[0]
    before = dict(attn.flash_attention.launches)
    got = torch.autograd.grad(attn.flash_attention(q, k, v), (q, k, v), do)
    after = attn.flash_attention.launches
    assert {key: after[key] - before[key] for key in BWD_KEYS} == {
        "bwd_dkv_causal": 1, "bwd_dq_causal": 1, "bwd_dkv_full": 0,
        "bwd_dq_full": 0}
    o, lse = attn.flash_attention_reference(q.detach(), k.detach(),
                                            v.detach())
    want = attn.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), o, lse, do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL[torch.float32])
    # only k needs a grad: the dQ kernel is not launched
    kk = k.detach().clone().requires_grad_()
    before = dict(attn.flash_attention.launches)
    torch.autograd.grad(attn.flash_attention(q.detach(), kk, v.detach()),
                        (kk,), do)
    assert attn.flash_attention.launches["bwd_dq_causal"] == \
        before["bwd_dq_causal"]
    assert attn.flash_attention.launches["bwd_dkv_causal"] == \
        before["bwd_dkv_causal"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,B,T,H,D,causal,block", [
    (torch.float32, 2, 40, 2, 8, True, 16),
    (torch.float32, 2, 32, 2, 8, False, 16),
    (torch.float32, 2, 300, 4, 16, True, 128),
    (torch.float32, 1, 256, 4, 16, False, 128),
    (torch.float32, 1, 70, 1, 128, True, 32),
    (torch.bfloat16, 1, 200, 2, 128, True, 128),
    (torch.bfloat16, 1, 256, 2, 128, False, 128),
    (torch.bfloat16, 2, 72, 2, 16, True, 16),
    # the split-TF32 design (f32, D = 8 and 16) at ragged T; a non-causal
    # call's plain version takes the whole T as its block
    *[(torch.float32, 2, T, 3, D, causal, 128 if causal else T)
      for D in (8, 16) for T in (1, 17, 65, 1000)
      for causal in (True, False)],
])
def test_backward_kernels_match_plain_version(dtype, B, T, H, D, causal,
                                              block, cuda_device):
    q, k, v, do = _qkv(B, T, H, D, dtype, cuda_device, seed=T + D) + \
        _qkv(B, T, H, D, dtype, cuda_device, seed=T + D + 1)[:1]
    o, lse = attn.flash_attention_fwd(q, k, v, causal, block, block)
    entry = "causal" if causal else "full"
    before = dict(attn.flash_attention.launches)
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, causal, block,
                                   block)
    torch.cuda.synchronize()
    for kind in ("dkv", "dq"):
        key = f"bwd_{kind}_{entry}"
        assert attn.flash_attention.launches[key] == before[key] + 1
    want = attn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal, block, block)
    for g, w in zip(got, want):
        assert g.shape == q.shape and g.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, **GRAD_TOL[dtype])
    if dtype == torch.bfloat16:
        fp.bwd_rounding_flips(q, k, v, o, lse, do, got, want, causal)
    # a second launch repeats the first bit for bit
    again = attn.flash_attention_bwd(q, k, v, o, lse, do, causal, block,
                                     block)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
def test_f32_backward_designs_on_the_card(cuda_device):
    """f32 at D = 8 and 16 takes the split-TF32 design in both directions
    (the libraries report it, and a call launches the backward's two
    kernels, at rtol 1e-4 / atol 1e-5 against the plain version); f32 at
    D = 128 keeps the FMA design in both."""
    lib = attn._library("flash_attention_bwd", attn._BWD_ENTRIES)
    fwd = attn._library("flash_attention", attn._FWD_ENTRIES)
    for D, design in ((8, "mma_tf32x3"), (16, "mma_tf32x3"), (128, "fma")):
        for direction, report in (("backward", lib.iotml_flash_bwd_design),
                                  ("forward", fwd.iotml_flash_fwd_design)):
            assert attn.flash_design(torch.float32, D, direction) == design
            assert attn.FLASH_DESIGNS[report(D, 0)] == design
    q, k, v, do = _qkv(2, 300, 2, 16, torch.float32, cuda_device, seed=4) + \
        _qkv(2, 300, 2, 16, torch.float32, cuda_device, seed=5)[:1]
    o, lse = attn.flash_attention_fwd(q, k, v, True, 128, 128)
    want_o, want_lse = attn.flash_attention_reference(q, k, v, True, 128,
                                                      128)
    torch.testing.assert_close(o, want_o, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    before = dict(attn.flash_attention.launches)
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, True, 128, 128)
    torch.cuda.synchronize()
    after = attn.flash_attention.launches
    assert {key: after[key] - before[key] for key in BWD_KEYS} == {
        "bwd_dkv_causal": 1, "bwd_dq_causal": 1, "bwd_dkv_full": 0,
        "bwd_dq_full": 0}
    want = attn.flash_attention_backward_reference(q, k, v, o, lse, do, True,
                                                   128, 128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **GRAD_TOL[torch.float32])


#: the split-TF32 forward's cases (f32, D = 8 and 16), as chip_smoke.py's
#: MMA_FWD_CASES: T, B, H, D, causal; the plain version at blocks 128
#: when causal and at the whole T when not
MMA_FWD_CASES = [(T, B, H, D, causal)
                 for D in (8, 16) for causal in (True, False)
                 for T in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000,
                           4096)
                 for B, H in ((1, 1), (2, 3))]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "T,B,H,D,causal", MMA_FWD_CASES,
    ids=[f"T{T}-BH{B * H}-D{D}-{'causal' if c else 'full'}"
         for T, B, H, D, c in MMA_FWD_CASES])
def test_mma_forward_matches_plain_version(T, B, H, D, causal, cuda_device):
    """f32 at D = 8 and 16 (the split-TF32 design): O and LSE within
    rtol = atol = 2e-5 of the plain version, and a second launch repeats
    the first bit for bit."""
    assert attn.flash_design(torch.float32, D, "forward") == "mma_tf32x3"
    q, k, v = _qkv(B, T, H, D, torch.float32, cuda_device, seed=T + D)
    block = 128 if causal else T
    entry = "causal" if causal else "full"
    before = dict(attn.flash_attention.launches)
    o, lse = attn.flash_attention_fwd(q, k, v, causal, block, block)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches[entry] == before[entry] + 1
    want_o, want_lse = attn.flash_attention_reference(q, k, v, causal,
                                                      block, block)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(o, want_o, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    o2, lse2 = attn.flash_attention_fwd(q, k, v, causal, block, block)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.cuda
def test_mma_forward_realigns_a_misaligned_view(cuda_device):
    """f32 D = 16 q, k, v views that start 4 bytes past an allocation
    (with H = 1 the fold keeps the view): the wrapper hands the split-TF32
    kernel aligned copies (its cp.async copies 16-byte chunks) and answers
    as for aligned tensors; the library itself refuses the misaligned
    pointer (cudaErrorMisalignedAddress, 716) without launching."""
    B, T, H, D = 2, 200, 1, 16
    q, k, v = _qkv(B, T, H, D, torch.float32, cuda_device, seed=6)
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        views.append(buf[1:].view(t.shape).copy_(t))
    assert all(t.data_ptr() % 16 for t in views)
    o, lse = attn.flash_attention_fwd(*views, True, 128, 128)
    want_o, want_lse = attn.flash_attention_reference(q, k, v, True, 128,
                                                      128)
    torch.testing.assert_close(o, want_o, **F32_TOL)
    torch.testing.assert_close(lse, want_lse, **F32_TOL)
    lib = attn._library("flash_attention", attn._FWD_ENTRIES)
    out = torch.empty_like(q)
    out_lse = torch.empty((B * H, T), device=cuda_device)
    err = lib.iotml_flash_fwd(
        views[0].data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        out_lse.data_ptr(), B * H, T, D, 0, 1, D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert err == 716


def _check_wgmma_forward(B, T, H, causal, block, device):
    """bf16 D=128 (the tensor-core design): the forward's O and LSE
    against the plain version at ``block``, and a bit repeat."""
    assert attn.flash_design(torch.bfloat16, 128, "forward") == "wgmma"
    q, k, v = _qkv(B, T, H, 128, torch.bfloat16, device, seed=T + H)
    entry = "causal" if causal else "full"
    before = dict(attn.flash_attention.launches)
    o, lse = attn.flash_attention_fwd(q, k, v, causal, block, block)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches[entry] == before[entry] + 1
    want_o, want_lse = attn.flash_attention_reference(q, k, v, causal,
                                                      block, block)
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    fp.check_wgmma_forward("forward", o, lse, want_o, want_lse, block)
    fp.check_rejects_scaled_o("forward", o, lse, want_o, want_lse, block)
    o2, lse2 = attn.flash_attention_fwd(q, k, v, causal, block, block)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 1), (2, 3)], ids=["BH1", "BH6"])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 1000, 4096])
def test_wgmma_forward_matches_plain_version_causal(T, B, H, cuda_device):
    _check_wgmma_forward(B, T, H, True, 64, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("T,block", [(64, 64), (1024, 64), (1040, 16)])
def test_wgmma_forward_matches_plain_version_full(T, block, cuda_device):
    """Non-causal; T = 1,040 (the caller's block 16) leaves a ragged key
    tile of 16 rows that the kernel masks."""
    _check_wgmma_forward(2, T, 3, False, block, cuda_device)


@pytest.mark.cuda
def test_wgmma_forward_realigns_a_misaligned_view(cuda_device):
    """q, k, v views that start 2 bytes past an allocation (with H = 1 the
    fold keeps the view): the wrapper hands the kernel aligned copies and
    answers as for aligned tensors; the library itself refuses the
    misaligned pointer (cudaErrorMisalignedAddress, 716) without
    launching."""
    B, T, H, D = 2, 200, 1, 128
    q, k, v = _qkv(B, T, H, D, torch.bfloat16, cuda_device, seed=5)
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        views.append(buf[1:].view(t.shape).copy_(t))
    assert all(t.data_ptr() % 16 for t in views)
    o, lse = attn.flash_attention_fwd(*views, True, 64, 64)
    want_o, want_lse = attn.flash_attention_reference(q, k, v, True, 64, 64)
    fp.check_wgmma_forward("realigned", o, lse, want_o, want_lse)
    lib = attn._library("flash_attention", attn._FWD_ENTRIES)
    out = torch.empty_like(q)
    out_lse = torch.empty((B * H, T), device=cuda_device)
    err = lib.iotml_flash_fwd(
        views[0].data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        out_lse.data_ptr(), B * H, T, D, 1, 1, D ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    assert err == 716


def _check_wgmma_backward(B, T, H, causal, device, grid=False):
    """bf16 D=128 (the tensor-core design): the kernels' grads against the
    plain backward at its own tiles (blocks 64), and a bit repeat; on
    ``grid`` inputs no rounding flip is allowed."""
    assert attn.flash_design(torch.bfloat16, 128, "backward") == "wgmma"
    q, k, v, do = _qkv(B, T, H, 128, torch.bfloat16, device, seed=T + H,
                       grid=grid) + \
        _qkv(B, T, H, 128, torch.bfloat16, device, seed=T + H + 1,
             grid=grid)[:1]
    o, lse = attn.flash_attention_fwd(q, k, v, causal, 64, 64)
    entry = "causal" if causal else "full"
    before = dict(attn.flash_attention.launches)
    got = attn.flash_attention_bwd(q, k, v, o, lse, do, causal, 64, 64)
    torch.cuda.synchronize()
    for kind in ("dkv", "dq"):
        key = f"bwd_{kind}_{entry}"
        assert attn.flash_attention.launches[key] == before[key] + 1
    want = attn.flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal, 64, 64)
    for g in got:
        assert g.shape == q.shape and g.dtype == torch.bfloat16
    fp.bwd_rounding_flips(q, k, v, o, lse, do, got, want, causal,
                          max_rows=0 if grid else None)
    again = attn.flash_attention_bwd(q, k, v, o, lse, do, causal, 64, 64)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H", [(1, 1), (2, 3)], ids=["BH1", "BH6"])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 1000, 4096])
def test_wgmma_backward_matches_plain_version_causal(T, B, H, cuda_device):
    _check_wgmma_backward(B, T, H, True, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 1024])
def test_wgmma_backward_matches_plain_version_full(T, cuda_device):
    _check_wgmma_backward(2, T, 3, False, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,causal", [
    (1, 1000, 1, True), (2, 1000, 3, True), (1, 4096, 1, True),
    (2, 4096, 3, True), (2, 1024, 3, False)])
def test_wgmma_backward_on_grid_inputs_has_no_rounding_flip(B, T, H, causal,
                                                            cuda_device):
    """Inputs rounded to multiples of 1/4: Q·Kᵀ and dO·Vᵀ are exact in f32
    in any order, so kernel and plain version round every p and ds alike
    and every row is inside the tolerance."""
    _check_wgmma_backward(B, T, H, causal, cuda_device, grid=True)


@pytest.mark.cuda
def test_wgmma_backward_only_k_needs_a_grad(cuda_device):
    """bf16 D=128 through autograd with only k requiring a grad: the dK/dV
    kernel runs, the dQ kernel does not, and dk is the plain version's."""
    assert attn.flash_design(torch.bfloat16, 128, "backward") == "wgmma"
    q, k, v, do = _qkv(1, 300, 2, 128, torch.bfloat16, cuda_device) + \
        _qkv(1, 300, 2, 128, torch.bfloat16, cuda_device, seed=1)[:1]
    kk = k.clone().requires_grad_()
    before = dict(attn.flash_attention.launches)
    (dk,) = torch.autograd.grad(attn.flash_attention(q, kk, v, True, 64, 64),
                                (kk,), do)
    after = attn.flash_attention.launches
    assert after["bwd_dq_causal"] == before["bwd_dq_causal"]
    assert after["bwd_dkv_causal"] == before["bwd_dkv_causal"] + 1
    o, lse = attn.flash_attention_fwd(q, k, v, True, 64, 64)
    want = attn.flash_attention_backward_reference(q, k, v, o, lse, do, True,
                                                   64, 64)[1]
    fp.bwd_rounding_flips(q, k, v, o, lse, do, (None, dk, None),
                          (None, want, None), True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ragged", "head_dim", "dtype", "shape",
                                  "lse", "folded"])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(case,
                                                               cuda_device):
    q, k, v, do = _qkv(1, 40, 2, 16, torch.float32, cuda_device) + \
        _qkv(1, 40, 2, 16, torch.float32, cuda_device, seed=1)[:1]
    lse = torch.zeros((1, 2, 40), device=cuda_device)
    causal = True
    if case == "ragged":
        causal = False
    elif case == "head_dim":
        q, k, v, do = _qkv(1, 40, 2, 32, torch.float32, cuda_device) + [
            torch.zeros((1, 40, 2, 32), device=cuda_device)]
    elif case == "dtype":
        do = do.half()
    elif case == "shape":
        k = k[:, :32]
    elif case == "lse":
        lse = lse.double()
    before = dict(attn.flash_attention.launches)
    with pytest.raises(ValueError):
        if case == "folded":  # a strided view where contiguous rows are due
            qf = q.permute(0, 2, 1, 3).reshape(2, 40, 16)
            attn.flash_bwd_dq(qf.transpose(0, 1).contiguous().transpose(
                0, 1), qf, qf, qf, lse[0], lse[0])
        else:
            attn.flash_attention_bwd(q, k, v, q, lse, do, causal, 16, 16)
    assert attn.flash_attention.launches == before


@pytest.mark.cuda
def test_sensorformer_on_the_card_matches_the_cpu(cuda_device):
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 200, 18)).astype(np.float32))
    card = SensorFormer(attn_mode="flash").eval()  # no device: the card
    assert card.head.weight.is_cuda
    cpu = SensorFormer(attn_mode="flash", device="cpu").eval()
    cpu.load_state_dict(card.state_dict())
    before = attn.flash_attention.launches["causal"]
    with torch.no_grad():
        got = card(x.to(cuda_device))
        want = cpu(x)
    assert attn.flash_attention.launches["causal"] == before + 2
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)
    scores = SensorFormer.anomaly_scores(got, x.to(cuda_device))
    torch.testing.assert_close(scores.cpu(),
                               SensorFormer.anomaly_scores(want, x),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_sensorformer_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One next-step loss and every parameter's grad of a small
    SensorFormer on the card (flash kernels, forward and backward) against
    the same weights on the CPU (the plain versions)."""
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 200, 18)).astype(np.float32))
    card = SensorFormer(d_model=32, num_heads=2, attn_mode="flash")
    cpu = SensorFormer(d_model=32, num_heads=2, attn_mode="flash",
                       device="cpu")
    cpu.load_state_dict(card.state_dict())
    before = dict(attn.flash_attention.launches)
    loss, grads = loss_and_grads(card, card.state_dict(), x.to(cuda_device))
    after = attn.flash_attention.launches
    assert after["causal"] - before["causal"] == card.num_layers
    assert after["bwd_dkv_causal"] - before["bwd_dkv_causal"] == \
        card.num_layers
    assert after["bwd_dq_causal"] - before["bwd_dq_causal"] == \
        card.num_layers
    want_loss, want_grads = loss_and_grads(cpu, cpu.state_dict(), x)
    torch.testing.assert_close(loss.cpu(), want_loss, rtol=1e-5, atol=0)
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        torch.testing.assert_close(g.cpu(), want_grads[name], rtol=1e-4,
                                   atol=1e-6, msg=name)
