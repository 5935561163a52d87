"""Attention ops (``iotml.ops.attention``'s twin): the plain softmax
reference, the online-softmax pieces ring attention reuses, and flash
attention's forward and backward as hand-written Hopper kernels.

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
- ``flash_attention_backward_reference``: the plain version of the two
  backward kernels.  It recomputes P from the LSE block by block and
  rounds P and dS to the input dtype before each product, as they do.
- ``flash_attention_fwd`` / ``flash_attention_bwd``: CUDA tensors launch
  ``csrc/flash_attention.cu`` / ``csrc/flash_attention_bwd.cu`` (or
  raise); CPU tensors take the plain versions.  ``flash_bwd_dkv`` and
  ``flash_bwd_dq`` launch one backward kernel each on the folded
  ``[B·H, T, D]`` tensors ``flash_bwd_inputs`` makes; ``flash_design``
  says which design a call takes in each direction (tensor-core
  ``wgmma`` for bfloat16 at D = 128; split-TF32 ``mma_tf32x3`` for
  float32 at D = 8, 16; fp32 ``fma`` otherwise).
- ``flash_attention``: an ``autograd.Function`` that saves
  ``(q, k, v, o, lse)`` and whose backward is ``flash_attention_bwd``.
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


def _splice(t, r0: int, rows):
    """``t`` with its rows r0.. (dim 2) replaced by ``rows``, a new
    tensor."""
    return rows if r0 == 0 else torch.cat([t[:, :, :r0], rows], dim=2)


def flash_attention_reference(q, k, v, causal: bool = True,
                              block_q: int = 128, block_k: int = 128
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flash kernel's plain version: (o [B,T,H,D], lse [B,H,T] f32).

    Walks ``block_k``-wide KV blocks with the online softmax.  A causal
    call gives KV block j only the q blocks (of ``block_q`` rows) that
    reach it — row ``(j·block_k // block_q)·block_q`` onwards — and skips
    strictly-future tiles, as the kernel's triangular grid does.  All q
    blocks of one KV block are computed together; every operation is
    row-wise, so that is the per-tile arithmetic.  Nothing is updated in
    place, so autograd runs through it (SensorFormer's
    ``flash_reference`` mode trains that way).
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
        # rows r0.. replaced out of place, so autograd can run through
        l = _splice(l, r0, l[:, :, r0:] * corr + p.sum(dim=-1))
        # P rounded to the input dtype before P·V, f32 accumulation
        acc = _splice(acc, r0, acc[:, :, r0:] * corr[..., None] +
                      p.to(dtype).to(torch.float32) @ vf[:, :, k0:k1])
        m = _splice(m, r0, m_new)
    empty = l == 0.0
    safe_l = torch.where(empty, 1.0, l)
    o = (acc / safe_l[..., None]).to(dtype).permute(0, 2, 1, 3)
    lse = torch.where(empty, NEG_INF, m + torch.log(safe_l))
    return o, lse


def flash_attention_backward_reference(q, k, v, o, lse, do,
                                       causal: bool = True,
                                       block_q: int = 128,
                                       block_k: int = 128
                                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernels' plain version: (dq, dk, dv) [B,T,H,D] in q's
    dtype, from the forward's ``o`` [B,T,H,D] and ``lse`` [B,H,T] and the
    output gradient ``do``.

    delta = rowsum(dO∘O) in f32.  Then, per ``block_k``-wide KV block and
    all q rows that reach it (from ``(j·block_k // block_q)·block_q`` when
    causal, as in ``flash_attention_reference``): f32 scores from
    input-dtype products, scaled after QK; p = exp(s − lse) where the pair
    is live and 0 by a select elsewhere; dp = dO·Vᵀ; ds = p·(dp −
    delta)·scale.  p is rounded to the input dtype before dv += pᵀ·dO, and
    ds before dk += dsᵀ·q and dq += ds·k, with f32 accumulation.  p comes
    from the LSE, not a running max, so the blocks change only the order
    of the f32 sums.
    """
    B, T, H, D = q.shape
    _check_blocks(T, causal, block_q, block_k)
    dtype = q.dtype
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qf, kf, vf, dof = (t.permute(0, 2, 1, 3).to(f32) for t in (q, k, v, do))
    delta = torch.einsum("bthd,bthd->bht", do.to(f32), o.to(f32))
    lse = lse.to(f32)
    dq = torch.zeros((B, H, T, D), dtype=f32, device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    pos = torch.arange(T, device=q.device)
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        r0 = (k0 // block_q) * block_q if causal else 0
        s = (qf[:, :, r0:] @ kf[:, :, k0:k1].transpose(-1, -2)) * scale
        arg = s - lse[:, :, r0:, None]
        if causal:  # exp only of live pairs' arguments
            live = pos[r0:, None] >= pos[None, k0:k1]
            p = torch.where(live, torch.exp(torch.where(live, arg, 0.0)),
                            0.0)
        else:
            p = torch.exp(arg)
        dp = dof[:, :, r0:] @ vf[:, :, k0:k1].transpose(-1, -2)
        ds = p * (dp - delta[:, :, r0:, None]) * scale
        p = p.to(dtype).to(f32)
        ds = ds.to(dtype).to(f32)
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ dof[:, :, r0:]
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qf[:, :, r0:]
        dq[:, :, r0:] += ds @ kf[:, :, k0:k1]
    return tuple(t.to(dtype).permute(0, 2, 1, 3) for t in (dq, dk, dv))


def _bind(lib: ctypes.CDLL, entries) -> ctypes.CDLL:
    """``lib`` with the argument and return types of each flash entry in
    ``entries`` (``(name, pointers)``): the pointers, five ints, the scale
    and the stream, returning a CUDA error code."""
    for entry, n_ptr in entries:
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [ptr] * n_ptr + [i32] * 5 + [ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
    return lib


def _library(name: str, entries):
    from . import _build

    return _bind(_build.load(name), entries)


def _check_inputs(what: str, ts, T: int, causal: bool, block_q: int,
                  block_k: int) -> None:
    """Raise ValueError unless the [B, T, H, D] tensors ``ts`` are what
    the kernels take: one shape, one device, float32 or bfloat16, a head
    dim the kernels are built for, and ``T % block_k == 0`` when not
    causal."""
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: tensors must share one [B, T, H, D] "
                         f"shape, got {[tuple(t.shape) for t in ts]}")
    B, _, H, D = q.shape
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"{what}: float32 or bfloat16 tensors of one "
                         f"dtype, got {[t.dtype for t in ts]}")
    if any(t.device != q.device for t in ts):
        raise ValueError(f"{what}: tensors on different devices")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what}: head dim {D} not in the kernel's "
                         f"{KERNEL_HEAD_DIMS}")
    if T < 1 or not 1 <= B * H <= 65535:
        raise ValueError(f"{what} needs T >= 1 and 1 <= B·H <= 65535, got "
                         f"T = {T}, B·H = {B * H}")
    _check_blocks(T, causal, block_q, block_k)


def _fold(t):
    """[B, T, H, D] → contiguous [B·H, T, D]."""
    B, T, H, D = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, T, D).contiguous()


def _unfold(t, B: int, H: int):
    """[B·H, T, ...] → [B, T, H, ...] (a view)."""
    return t.view(B, H, *t.shape[1:]).transpose(1, 2)


def _check_cuda(what: str, t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes cuda or cpu tensors, not {t.device}")


def _aligned(ts):
    """``ts`` with each tensor that does not start on 16 bytes replaced by
    an aligned copy: the tensor-core designs (both directions) read by
    TMA or 16-byte ``cp.async``, which need every tensor to start on 16
    bytes, and a view may not."""
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone() for t in ts)


_FWD_ENTRIES = [("iotml_flash_fwd", 5)]
_BWD_ENTRIES = [("iotml_flash_bwd_dkv", 8), ("iotml_flash_bwd_dq", 7)]


#: the flash designs by code, as ``iotml_flash_fwd_design`` and
#: ``iotml_flash_bwd_design`` return them (``csrc/flash_tiles.cuh``'s enum)
FLASH_DESIGNS = ("fma", "wgmma", "mma_tf32x3")


def flash_design(dtype: torch.dtype, head_dim: int,
                 direction: str) -> str:
    """Which design the flash kernels of ``direction`` ("forward" or
    "backward") take for ``dtype`` and ``head_dim``; both directions
    follow one rule:

    - ``"wgmma"`` (bf16 tensor cores, TMA): bfloat16 at D = 128, the
      long-context shape;
    - ``"mma_tf32x3"`` (split-TF32 tensor cores, ``mma.sync``, three
      tf32 products per product): float32 at D = 8 and 16, the
      SensorFormer layer;
    - ``"fma"`` (fp32 FMA): everything else (float32 at D = 128,
      bfloat16 at D = 8, 16).

    ``csrc/flash_tiles.cuh`` states the same rules (``fwd_design``,
    ``bwd_design``), and the libraries report them
    (``iotml_flash_fwd_design``, ``iotml_flash_bwd_design``).
    """
    if direction not in ("forward", "backward"):
        raise ValueError(f"direction must be 'forward' or 'backward', got "
                         f"{direction!r}")
    if dtype == torch.bfloat16 and head_dim == 128:
        return "wgmma"
    if dtype == torch.float32 and head_dim in (8, 16):
        return "mma_tf32x3"
    return "fma"


def flash_attention_fwd(q, k, v, causal: bool = True, block_q: int = 128,
                        block_k: int = 128
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention's forward: (o [B,T,H,D] in q's dtype, lse [B,H,T]
    f32).  CUDA tensors launch the kernel or raise; CPU tensors run
    ``flash_attention_reference``.

    ``block_q`` / ``block_k`` are the plain version's blocks and set the
    non-causal ragged check; the kernel tiles with its own sizes (f32
    results agree to rounding; bf16 ones to the rounding of P, which
    depends on the running max at each tile: the ``wgmma`` design's key
    tile is 64 rows).  A failed build or launch raises; nothing falls
    back to another design.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, block_q, block_k)
    _check_cuda("flash_attention", q)
    _check_inputs("flash_attention", (q, k, v), q.shape[1], causal, block_q,
                  block_k)
    B, T, H, D = q.shape
    qf, kf, vf = _aligned((_fold(q), _fold(k), _fold(v)))
    o = torch.empty((B * H, T, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    lib = _library("flash_attention", _FWD_ENTRIES)
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
    return _unfold(o, B, H), lse.view(B, H, T)


def _launch_bwd(kind: str, folded, outs, causal: bool) -> None:
    """Launch one backward kernel on folded inputs ``(q, k, v, do)``
    [B·H, T, D] and ``(lse, delta)`` [B·H, T] f32, writing ``outs``."""
    folded = _aligned(folded)
    qf = folded[0]
    BH, T, D = qf.shape
    lib = _library("flash_attention_bwd", _BWD_ENTRIES)
    fn = lib.iotml_flash_bwd_dkv if kind == "dkv" else lib.iotml_flash_bwd_dq
    with torch.cuda.device(qf.device):
        stream = torch.cuda.current_stream(qf.device).cuda_stream
        err = fn(*(t.data_ptr() for t in (*folded, *outs)), BH, T, D,
                 _DTYPE_CODES[qf.dtype], int(causal), 1.0 / math.sqrt(D),
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention {kind} backward kernel launch "
                           f"failed: CUDA error {err}")
    flash_attention.launches[
        f"bwd_{kind}_{'causal' if causal else 'full'}"] += 1


def flash_smem(kind: str, head_dim: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the forward (``"fwd"``), dK/dV
    (``"dkv"``) or dQ (``"dq"``) kernel at ``head_dim`` and ``dtype``, in
    bytes, as the built library lays it out."""
    code = _DTYPE_CODES[dtype]
    if kind == "fwd":
        lib = _library("flash_attention", _FWD_ENTRIES)
        return int(lib.iotml_flash_fwd_smem(head_dim, code))
    lib = _library("flash_attention_bwd", _BWD_ENTRIES)
    return int(lib.iotml_flash_bwd_smem(head_dim, int(kind == "dq"), code))


def _check_folded(what: str, qf, kf, vf, dof, lse, delta) -> None:
    _check_cuda(what, qf)
    if qf.dim() != 3 or any(t.shape != qf.shape for t in (kf, vf, dof)):
        raise ValueError(f"{what}: q, k, v, do must share one [B·H, T, D] "
                         f"shape")
    if lse.shape != qf.shape[:2] or delta.shape != qf.shape[:2] \
            or lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{what}: lse and delta must be [B·H, T] float32")
    ts = (qf, kf, vf, dof, lse, delta)
    if any(not t.is_contiguous() or t.device != qf.device for t in ts):
        raise ValueError(f"{what}: contiguous tensors on one device")
    BH, T, D = qf.shape
    # dtype, head dim and B·H range: the [B, T, H, D] checks with H = 1
    _check_inputs(what, (qf.view(BH, T, 1, D), kf.view(BH, T, 1, D),
                         vf.view(BH, T, 1, D), dof.view(BH, T, 1, D)),
                  T, True, 1, 1)


def flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel on folded CUDA tensors: q, k, v, do [B·H, T, D],
    lse and delta [B·H, T] f32 → (dk, dv) [B·H, T, D] in q's dtype.
    Raises on anything else; the plain version is
    ``flash_attention_backward_reference``."""
    _check_folded("flash_bwd_dkv", qf, kf, vf, dof, lse, delta)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    _launch_bwd("dkv", (qf, kf, vf, dof, lse, delta), (dk, dv), causal)
    return dk, dv


def flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal: bool = True
                 ) -> torch.Tensor:
    """The dQ kernel on folded CUDA tensors (as ``flash_bwd_dkv``) → dq
    [B·H, T, D] in q's dtype."""
    _check_folded("flash_bwd_dq", qf, kf, vf, dof, lse, delta)
    dq = torch.empty_like(qf)
    _launch_bwd("dq", (qf, kf, vf, dof, lse, delta), (dq,), causal)
    return dq


def flash_bwd_inputs(q, k, v, o, lse, do) -> Tuple[torch.Tensor, ...]:
    """What the backward kernels take, from [B, T, H, D] ``q, k, v, o,
    do`` and ``lse`` [B, H, T]: q, k, v, do folded to contiguous
    [B·H, T, D], then lse and delta = rowsum(dO∘O) as [B·H, T] f32."""
    B, T, H, _ = q.shape
    delta = torch.einsum("bthd,bthd->bht", do.float(), o.float())
    return (_fold(q), _fold(k), _fold(v), _fold(do),
            lse.reshape(B * H, T).contiguous(),
            delta.reshape(B * H, T).contiguous())


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        block_q: int = 128, block_k: int = 128,
                        needs: Tuple[bool, bool, bool] = (True, True, True)
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """Flash attention's backward: (dq, dk, dv) [B,T,H,D] in q's dtype from
    the forward's ``o`` and ``lse`` [B,H,T] f32 and the output gradient
    ``do``.  CUDA tensors launch the dQ kernel when ``needs[0]`` and the
    dK/dV kernel when ``needs[1]`` or ``needs[2]`` (an entry not needed
    comes back None), or raise; CPU tensors run
    ``flash_attention_backward_reference``.  delta = rowsum(dO∘O) is a
    plain f32 reduction, as in the JAX package."""
    if q.device.type == "cpu":
        grads = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                   causal, block_q, block_k)
        return tuple(g if n else None for g, n in zip(grads, needs))
    _check_cuda("flash_attention_bwd", q)
    B, T, H, D = q.shape
    _check_inputs("flash_attention_bwd", (q, k, v, o, do), T, causal,
                  block_q, block_k)
    if lse.shape != (B, H, T) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be [B, H, T] "
                         f"float32 on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    folded = flash_bwd_inputs(q, k, v, o, lse, do)
    dq = dk = dv = None
    if needs[1] or needs[2]:
        dk, dv = flash_bwd_dkv(*folded, causal=causal)
        dk = _unfold(dk, B, H) if needs[1] else None
        dv = _unfold(dv, B, H) if needs[2] else None
    if needs[0]:
        dq = _unfold(flash_bwd_dq(*folded, causal=causal), B, H)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, *ctx.blocks,
                                         needs=ctx.needs_input_grad[:3])
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention. q, k, v: [B, T, H, D] → [B, T, H, D].

    CUDA tensors launch the Hopper kernels (``csrc/flash_attention.cu``
    forward, ``csrc/flash_attention_bwd.cu`` backward) or raise; CPU
    tensors run the plain versions.  Non-causal calls need ``T % block_k
    == 0`` (ValueError otherwise).  Differentiable: the forward saves
    ``(q, k, v, o, lse)`` and the backward (``flash_attention_bwd``)
    recomputes P from the LSE, launching the dK/dV and dQ kernels once
    each.
    """
    return _FlashAttention.apply(q, k, v, causal, block_q, block_k)


#: kernel launches so far, by entry point (the plain versions are not
#: counted)
flash_attention.launches = {"causal": 0, "full": 0, "bwd_dkv_causal": 0,
                            "bwd_dq_causal": 0, "bwd_dkv_full": 0,
                            "bwd_dq_full": 0}
