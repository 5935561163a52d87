"""Card-only checks of the flash-attention kernel and SensorFormer on
``cuda``.  Every test is marked ``cuda`` and skips without a card.

The machine with the card has no JAX, so this file imports only torch,
numpy and the port, and runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda_attention.py

Tolerances: float32 O and LSE 2e-5, the JAX suite's flash forward bound
(tests/test_attention.py:56-57); bfloat16 O atol = rtol = 2e-2 compared
in float32 and LSE atol 1e-3, because P is rounded to bfloat16 at the
running max of each tile and the kernel's tiles differ from the plain
version's blocks; the model's predictions rtol = atol = 2e-4
(tests/test_transformer_sp.py:36-39).
"""

import numpy as np
import pytest
import torch

from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops import attention as attn

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_O_TOL = dict(rtol=2e-2, atol=2e-2)
BF16_LSE_TOL = dict(rtol=0, atol=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(B, T, H, D, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
            .to(device, dtype) for _ in range(3)]


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
def test_backward_raises_on_the_card(cuda_device):
    q, k, v = (t.requires_grad_() for t in
               _qkv(1, 16, 2, 16, torch.float32, cuda_device))
    with pytest.raises(NotImplementedError, match="B4-B7"):
        attn.flash_attention(q, k, v).sum().backward()


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
