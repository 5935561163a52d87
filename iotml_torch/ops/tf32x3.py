"""A plain-PyTorch model of the split-TF32 ("3xTF32") arithmetic that the
float32 flash kernels at D = 8 and 16, forward and backward, run on the
tensor cores (namespace ``tf32x3`` of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu``).

- ``tf32_round``: PTX ``cvt.rn.tf32.f32``, what the kernels use, by
  integer arithmetic on the float32 bits: round to nearest, ties to
  even, keep 10 mantissa bits, clear the low 13 (inf and NaN pass
  through).
- ``split``: x = hi + lo with hi = tf32(x) and lo = tf32(x - hi); the
  subtraction is exact, so hi + lo keeps 22 significant bits of x.
- ``split_matmul``: a @ b from ``terms`` tf32 products, each exact in
  float32 (11 × 11 significant bits), summed in float32: 1 is one-pass
  TF32, 3 adds hi·lo and lo·hi (the kernels).
- ``flash_attention_forward_split``: the plain forward
  (``flash_attention_reference``) with both products (Q·Kᵀ and P·V) a
  ``split_matmul``.
- ``flash_attention_backward_split``: the plain backward
  (``flash_attention_backward_reference``) with every product (Q·Kᵀ,
  dO·Vᵀ, Pᵀ·dO, dSᵀ·Q, dS·K) a ``split_matmul``.

What the model does not reproduce is the tensor cores' own f32
accumulation (it aligns and truncates inside one ``mma``); the kernels
keep each tile's sum in fresh registers and add it to the running sum
with IEEE adds, so that truncation reaches no more than one tile's sum.
The model is for the CPU tests: it shows that three terms hold the f32
forward's and backward's tolerances and one does not.  No kernel uses
it.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .attention import NEG_INF, _check_blocks

_LOW = 0x1FFF        # the 13 mantissa bits tf32 drops
_HALF = 0x1000       # half of the last kept bit
_MAG = 0x7FFFFFFF
_EXP = 0x7F800000


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """The nearest value with 10 mantissa bits to each element of a
    float32 tensor, as float32 (low 13 bits zero), ties to even
    (``cvt.rn.tf32.f32``).  Subnormals round in the same bit field; inf
    and NaN are kept."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    sign = bits & 0x80000000
    mag = bits & _MAG
    # adding one less than half a unit, plus the kept last bit, to the
    # magnitude and clearing the dropped bits rounds half to even; a
    # mantissa carry moves into the exponent
    half = _HALF - 1 + ((mag >> 13) & 1)
    rounded = ((mag + half) & ~_LOW) & _MAG
    out = torch.where((mag & _EXP) == _EXP, mag, rounded) | sign
    out = torch.where(out >= 0x80000000, out - 0x100000000, out)
    return out.to(torch.int32).view(torch.float32).view(x.shape)


def split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): hi = tf32(x), lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3
                 ) -> torch.Tensor:
    """a @ b in float32 from ``terms`` tf32 products: 1 hi·hi; 3 adds
    hi·lo + lo·hi (small terms first, as the kernels issue them)."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    if terms == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def flash_attention_forward_split(q, k, v, causal: bool = True,
                                  block_q: int = 128, block_k: int = 128,
                                  terms: int = 3
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_reference`` (float32 only) with Q·Kᵀ and P·V each
    a ``split_matmul`` of ``terms`` terms: (o [B, T, H, D], lse [B, H,
    T])."""
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 model is for float32 inputs")
    B, T, H, D = q.shape
    _check_blocks(T, causal, block_q, block_k)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    pos = torch.arange(T, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        r0 = (k0 // block_q) * block_q if causal else 0
        s = split_matmul(qf[:, :, r0:], kf[:, :, k0:k1].transpose(-1, -2),
                         terms) * scale
        if causal:
            live = pos[r0:, None] >= pos[None, k0:k1]
            s = torch.where(live, s, NEG_INF)
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alive = m_new > NEG_INF / 2
        corr = torch.where(alive, torch.exp(m_old - m_new), 0.0)
        p = torch.where(alive[..., None], torch.exp(s - m_new[..., None]), 0.0)
        l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(dim=-1)
        acc[:, :, r0:] = acc[:, :, r0:] * corr[..., None] + split_matmul(
            p, vf[:, :, k0:k1], terms)
        m[:, :, r0:] = m_new
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = (acc / safe_l[..., None]).permute(0, 2, 1, 3)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return o, lse


def flash_attention_backward_split(q, k, v, o, lse, do, causal: bool = True,
                                   block_q: int = 128, block_k: int = 128,
                                   terms: int = 3
                                   ) -> Tuple[torch.Tensor, ...]:
    """``flash_attention_backward_reference`` (float32 only) with each
    product a ``split_matmul`` of ``terms`` terms: (dq, dk, dv)
    [B, T, H, D]."""
    if q.dtype != torch.float32:
        raise ValueError("the split-TF32 model is for float32 inputs")
    B, T, H, D = q.shape
    _check_blocks(T, causal, block_q, block_k)
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.permute(0, 2, 1, 3) for t in (q, k, v, do))
    delta = torch.einsum("bthd,bthd->bht", do, o)
    dq = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    pos = torch.arange(T, device=q.device)

    def mm(a, b):
        return split_matmul(a, b, terms)

    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        r0 = (k0 // block_q) * block_q if causal else 0
        s = mm(qf[:, :, r0:], kf[:, :, k0:k1].transpose(-1, -2)) * scale
        arg = s - lse[:, :, r0:, None]
        if causal:
            live = pos[r0:, None] >= pos[None, k0:k1]
            p = torch.where(live, torch.exp(torch.where(live, arg, 0.0)),
                            0.0)
        else:
            p = torch.exp(arg)
        dp = mm(dof[:, :, r0:], vf[:, :, k0:k1].transpose(-1, -2))
        ds = p * (dp - delta[:, :, r0:, None]) * scale
        dv[:, :, k0:k1] = mm(p.transpose(-1, -2), dof[:, :, r0:])
        dk[:, :, k0:k1] = mm(ds.transpose(-1, -2), qf[:, :, r0:])
        dq[:, :, r0:] += mm(ds, kf[:, :, k0:k1])
    return tuple(t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
