"""Ring attention: sequence-parallel attention over a mesh axis
(``iotml.parallel.ring_attention``'s twin).

When a history is too long for one card, or the batch × sequence
product wants more than one card's work, the time axis shards over a
mesh axis.  Each shard holds a local Q/K/V block ``[B, T/n, H, D]``;
the K/V blocks rotate around the ring (``mesh.ppermute``: ``.to`` between
the shards of one process, P2P sends across processes) and every shard
folds each arriving block into its online-softmax accumulator
(``ops.attention.blockwise_update``, the flash kernel's arithmetic).
After n − 1 rotations every query has seen every key, with O(T/n)
memory a shard.

Causality under rotation: shard i starts with K/V block i; after s hops
it holds block (i − s) mod n, so global key positions follow from the
hop counter.

Each hop is rematerialised in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package):
autograd would otherwise keep every hop's ``[B, H, Tl, Tl]``
probabilities, the memory ring attention exists to avoid.  The hop is a
plain einsum, as JAX's is, not a kernel.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import NEG_INF, blockwise_update, finalize_blockwise
from .mesh import Mesh, P, axis_index, axis_size, ppermute, shard_map


def _hop(o, m, l, q, k_blk, v_blk, src, qpos, causal: bool, scale: float):
    """One hop's fold of K/V block ``src`` into (o, m, l)."""
    Tl = q.shape[1]
    mask = None
    if causal:
        kpos = src * Tl + torch.arange(Tl, device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
    return blockwise_update(o, m, l, q, k_blk.to(torch.float32),
                            v_blk.to(torch.float32), scale, mask)


def _ring_attention_local(q, k, v, axis_name: str, causal: bool):
    """The per-shard body: q, k, v are this shard's ``[B, Tl, H, D]``
    blocks along ``axis_name``; runs inside ``shard_map``."""
    n = axis_size(axis_name)
    my = axis_index(axis_name)
    B, Tl, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qpos = my * Tl + torch.arange(Tl, device=dev)  # global query positions
    qf = q.to(torch.float32)
    o = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    hop = functools.partial(checkpoint, _hop, use_reentrant=False,
                            preserve_rng_state=False)
    # hop 0 folds the resident block; then exactly n − 1 rotations (a
    # rotation after the last hop would move a K/V block nothing reads)
    o, m, l = hop(o, m, l, qf, k, v, my, qpos, causal, scale)
    perm = [(i, (i + 1) % n) for i in range(n)]
    k_blk, v_blk = k, v
    for s in range(1, n):
        # rotate K/V to the right neighbour (receive from the left)
        k_blk = ppermute(k_blk, axis_name, perm)
        v_blk = ppermute(v_blk, axis_name, perm)
        o, m, l = hop(o, m, l, qf, k_blk, v_blk, (my - s) % n, qpos,
                      causal, scale)
    return finalize_blockwise(o, l).to(q.dtype)


def ring_attention(q, k, v, axis_name: str = "seq", causal: bool = True):
    """The shard_map-body form: call inside ``shard_map`` (or a step
    built on it) where q, k, v are already this shard's sequence
    blocks.  Outside one it raises NameError."""
    return _ring_attention_local(q, k, v, axis_name, causal)


def make_ring_attention(mesh: Mesh, seq_axis: str = "seq",
                        causal: bool = True):
    """A sequence-sharded attention function over ``mesh``: f(q, k, v)
    on ``[B, T, H, D]`` arrays (tensors, numpy arrays, or
    ``ShardedTensor``s cut ``P(None, seq_axis)``) whose T dimension is
    cut over ``seq_axis``; returns a ``ShardedTensor`` cut the same way.
    Autograd runs from its pieces back to tensor inputs."""
    body = functools.partial(_ring_attention_local, axis_name=seq_axis,
                             causal=causal)
    spec = P(None, seq_axis, None, None)
    return shard_map(body, mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)
