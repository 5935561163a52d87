"""Attention ops (``iotml.ops.attention``'s twin): the plain softmax
reference, the online-softmax pieces ring attention reuses, and flash
attention's forward as a hand-written Hopper kernel.

Layout is the JAX package's: ``q, k, v`` are ``[B, T, H, D]``, and the
log-sum-exp the forward emits is ``[B, H, T]`` float32.

- ``attention_reference``: plain softmax attention with global-position
  causal masking — the oracle for every other path.
- ``blockwise_update`` / ``finalize_blockwise``: one online-softmax step
  against a KV block, and the final normalization.
- ``flash_attention_reference``: the plain version of the flash kernel.
  It walks ``block_k``-wide KV blocks with the kernel's online softmax
  and dtype policy (f32 scores from input-dtype products, the scale
  applied after QK, masked scores ``NEG_INF``, the ``alive`` guard, P
  rounded to the input dtype before P·V with f32 accumulation).
- ``flash_attention_fwd`` / ``flash_attention``: CUDA tensors launch
  ``csrc/flash_attention.cu`` (or raise); CPU tensors take the plain
  version.  ``flash_attention`` is an ``autograd.Function`` whose
  backward is not written yet.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

#: head dims the kernel is built for (SensorFormer at full width, the
#: long-context shape, and the JAX suite's test shape)
KERNEL_HEAD_DIMS = (8, 16, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v, causal: bool = True, q_offset: int = 0,
                        k_offset: int = 0):
    """Plain softmax attention. q: [B, Tq, H, D], k, v: [B, Tk, H, D] →
    [B, Tq, H, D].  ``q_offset`` / ``k_offset`` are the global positions
    of the local blocks, so the causal mask stays right under sequence
    sharding."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def blockwise_update(o, m, l, q, k_blk, v_blk, scale: float,
                     mask: Optional[torch.Tensor] = None):
    """One online-softmax accumulation against a KV block.

    o: [B, Tq, H, D] running (unnormalized) output; m: [B, H, Tq] running
    row max; l: [B, H, Tq] running denominator; mask: [Tq, Tk] boolean
    (True = attend), already global-position-aware.  Returns the updated
    (o, m, l); the output is ``finalize_blockwise(o, l)``.
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # a fully-masked row (m_new == NEG_INF) would get exp(0) = 1 for
    # every key; the guard keeps its correction and probabilities at 0
    alive = m_new > NEG_INF / 2
    corr = torch.where(alive, torch.exp(m - m_new), 0.0)
    p = torch.where(alive[..., None], torch.exp(s - m_new[..., None]), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + \
        torch.einsum("bhqk,bkhd->bqhd", p, v_blk)
    return o_new, m_new, l_new


def finalize_blockwise(o, l):
    """Normalize the accumulated output; fully-masked rows come out 0."""
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return o / denom


def _check_blocks(T: int, causal: bool, block_q: int, block_k: int) -> None:
    if block_q < 1 or block_k < 1:
        raise ValueError(f"blocks must be positive, got {block_q}, {block_k}")
    if not causal and T % block_k:
        # padded keys are excluded only by the causal mask; non-causal
        # callers pass block-multiple sequence lengths (as in iotml)
        raise ValueError(
            f"non-causal flash attention needs T % {block_k} == 0")


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: int = 128, block_k: int = 128
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernel's plain version: (o [B,T,H,D], lse [B,H,T] f32).

    Walks ``block_k``-wide KV blocks with the online softmax.  A causal
    call gives KV block j only the q blocks (of ``block_q`` rows) that
    reach it — row ``(j·block_k // block_q)·block_q`` onwards — and skips
    strictly-future tiles, as the kernel's triangular grid does.  All q
    blocks of one KV block are computed together; every operation is
    row-wise, so that is the per-tile arithmetic.
    """
    B, T, H, D = q.shape
    _check_blocks(T, causal, block_q, block_k)
    dtype = q.dtype
    scale = 1.0 / math.sqrt(D)
    # [B, H, T, D] in f32: bf16 products are exact in f32, so the scores
    # are the f32 sums of input-dtype products
    qf, kf, vf = (t.permute(0, 2, 1, 3).to(torch.float32) for t in (q, k, v))
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    pos = torch.arange(T, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        r0 = (k0 // block_q) * block_q if causal else 0
        s = (qf[:, :, r0:] @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if causal:
            live = pos[r0:, None] >= pos[None, k0:k1]
            s = torch.where(live, s, NEG_INF)
        m_old = m[:, :, r0:]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        alive = m_new > NEG_INF / 2
        corr = torch.where(alive, torch.exp(m_old - m_new), 0.0)
        p = torch.where(alive[..., None], torch.exp(s - m_new[..., None]), 0.0)
        l[:, :, r0:] = l[:, :, r0:] * corr + p.sum(dim=-1)
        # P rounded to the input dtype before P·V, f32 accumulation
        acc[:, :, r0:] = acc[:, :, r0:] * corr[..., None] + \
            p.to(dtype).to(torch.float32) @ vf[:, :, k0:k1]
        m[:, :, r0:] = m_new
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = (acc / safe_l[..., None]).to(dtype).permute(0, 2, 1, 3)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return o, lse


def _library():
    from . import _build

    lib = _build.load("flash_attention")
    if lib.iotml_flash_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.iotml_flash_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.iotml_flash_fwd.restype = ctypes.c_int
    return lib


def flash_attention_fwd(q, k, v, causal: bool = True, block_q: int = 128,
                        block_k: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention's forward: (o [B,T,H,D] in q's dtype, lse [B,H,T]
    f32).  CUDA tensors launch the kernel or raise; CPU tensors run
    ``flash_attention_reference``.

    ``block_q`` / ``block_k`` are the plain version's blocks and set the
    non-causal ragged check; the kernel tiles with its own sizes (f32
    results agree to rounding; bf16 ones to the rounding of P, which
    depends on the running max at each tile).
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention takes cuda or cpu tensors, "
                         f"not {q.device}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k, v must share one "
                         f"[B, T, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: float32 or bfloat16 q, k, v, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in the "
                         f"kernel's {KERNEL_HEAD_DIMS}")
    if T < 1 or not 1 <= B * H <= 65535:
        raise ValueError(f"flash_attention needs T >= 1 and 1 <= B·H <= "
                         f"65535, got T = {T}, B·H = {B * H}")
    _check_blocks(T, causal, block_q, block_k)

    def fold(t):
        return t.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()

    qf, kf, vf = fold(q), fold(k), fold(v)
    o = torch.empty((B * H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.iotml_flash_fwd(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B * H, T, D, _DTYPE_CODES[q.dtype], int(causal),
            1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches["causal" if causal else "full"] += 1
    return (o.view(B, H, T, D).permute(0, 2, 1, 3),
            lse.view(B, H, T))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, _ = flash_attention_fwd(q, k, v, causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash_attention has no backward yet: its Hopper kernels (the "
            "counterparts of the TPU kernels B4-B7 in ROADMAP.md) come "
            "with the SensorFormer training path")


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention. q, k, v: [B, T, H, D] → [B, T, H, D].

    CUDA tensors launch the Hopper kernel (``csrc/flash_attention.cu``)
    or raise; CPU tensors run ``flash_attention_reference``.  Non-causal
    calls need ``T % block_k == 0`` (ValueError otherwise).  The forward
    computes the per-row log-sum-exp the backward will need
    (``flash_attention_fwd`` returns it); the backward raises
    NotImplementedError until its kernels exist.
    """
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


#: kernel launches so far, by entry point (the plain version is not
#: counted)
flash_attention.launches = {"causal": 0, "full": 0}
