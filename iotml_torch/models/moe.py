"""Mixture-of-experts SensorFormer (``iotml.models.moe``'s twin): sparse
FFN capacity for fleet-scale data.

Experts specialise per operating regime (highway, city, fault states)
while the work a token stays that of one FFN.  Routing is the JAX
package's (GShard / Switch style):

- top-1 gating (``argmax``: the first maximum on ties, as jnp's) with a
  fixed capacity a expert, ``C = max(1, int(capacity_factor · N / E))``
  over the local token block; a token's place in its expert's queue is
  a cumulative count, and overflow tokens fall through the residual
  with output 0;
- the expert FFNs are one batched product over the leading expert axis
  (``w1 [E, D, H]``, ``b1``, ``w2``, ``b2``; tanh GELU);
- with ``ep_axis`` set (inside ``shard_map``) the expert weights are the
  local slice ``[E/ep, …]`` and two tiled all-to-alls move the token
  slots expert-major and back (``parallel.expert_parallel``);
- the load-balance loss is Shazeer et al.'s ``E · Σ_e f_e · p_e`` over
  the fraction routed f and the mean gate probability p.

Dispatch and combine go by index, not by the dense one-hot
``[N, E, C]``: each kept token is added into its slot (a slot holds one
token, so the sum is the token), and each token reads its gated slot
back (a dropped token reads a zero row).  Each einsum of the JAX
package's (``nec,nd->ecd``, ``nec,ecd->nd``) has one nonzero term a slot
or token, so the values are the same, and no ``[N, E, C]`` tensor is
made (at 102,400 tokens a shard it would be 52 GB).

Submodule and param names follow the flax tree (``block{i}.moe.router``,
``.w1``, ``.b1``, ``.w2``, ``.b2``), and ``models.convert`` maps the
weights both ways.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from .initializers import lecun_normal, linear
from .transformer import ATTN_MODES, LayerNorm, MultiHeadAttention, _linear

#: an MoE block's expert leaves, each ``[E, …]`` (flax's layout): what
#: the expert axis cuts and what ``models.convert`` copies untransposed
EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def _expert_weight(E: int, fan_in: int, fan_out: int,
                   gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal`` of an ``[E, fan_in, fan_out]`` param: its
    fan-in is ``E · fan_in`` (the expert axis counts as receptive
    field)."""
    return lecun_normal(fan_out, E * fan_in, gen).T.reshape(E, fan_in,
                                                            fan_out)


class MoEFFN(nn.Module):
    """Top-1 routed expert FFN over tokens: ``[N, D] → ([N, D], aux)``.
    After each call ``dropped`` holds the tokens over capacity (a 0-d
    tensor on the device)."""

    def __init__(self, d_model: int, num_experts: int = 8,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 ep_axis: Optional[str] = None, *, gen: torch.Generator,
                 device):
        super().__init__()
        self.d_model, self.num_experts = d_model, num_experts
        self.mlp_ratio, self.capacity_factor = mlp_ratio, capacity_factor
        self.ep_axis = ep_axis
        E, D, H = num_experts, d_model, d_model * mlp_ratio
        self.router = linear(D, E, lecun_normal(E, D, gen), False, device)
        self.w1 = nn.Parameter(_expert_weight(E, D, H, gen).to(device))
        self.b1 = nn.Parameter(torch.zeros(E, H, device=device))
        self.w2 = nn.Parameter(_expert_weight(E, H, D, gen).to(device))
        self.b2 = nn.Parameter(torch.zeros(E, D, device=device))
        self.dropped: Optional[torch.Tensor] = None

    def forward(self, x):
        from ..parallel.mesh import all_to_all, axis_size

        N, D = x.shape
        ep = axis_size(self.ep_axis) if self.ep_axis else 1
        E = self.num_experts
        if E % ep:
            raise ValueError(f"num_experts={E} not divisible by ep={ep}")
        # capacity per expert over the local token block (JAX's Python
        # arithmetic: float product, then int)
        C = max(1, int(self.capacity_factor * N / E))

        probs = torch.softmax(self.router(x), dim=-1)           # [N, E]
        expert = torch.argmax(probs, dim=-1)                     # [N]
        gate = probs.gather(1, expert[:, None])[:, 0]            # [N]
        onehot = F.one_hot(expert, E)                            # [N, E]
        # each token's place in its expert's queue; overflow drops
        pos = (torch.cumsum(onehot, dim=0) - 1).gather(
            1, expert[:, None])[:, 0]
        keep = pos < C
        # a kept token's slot is expert·C + its place; a dropped one
        # goes to the spill row E·C, which is cut off
        slot = torch.where(keep, expert * C + pos, E * C)
        self.dropped = N - torch.count_nonzero(keep)

        slots = x.new_zeros(E * C + 1, D).index_add(0, slot, x)
        slots = slots[:E * C].view(E, C, D)
        w1, b1, w2, b2 = self.w1, self.b1, self.w2, self.b2
        if self.ep_axis and ep > 1:
            # [E, C, d] → [E/ep, ep·C, d]: my experts' slots, all shards
            slots = all_to_all(slots, self.ep_axis, 0, 1)
        h = torch.einsum("ecd,edh->ech", slots, w1) + b1[:, None, :]
        h = F.gelu(h, approximate="tanh")
        h = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
        if self.ep_axis and ep > 1:
            h = all_to_all(h, self.ep_axis, 1, 0)
        h = torch.cat([h.reshape(E * C, D), h.new_zeros(1, D)])
        out = gate[:, None] * h.index_select(0, slot)

        # load balance: fraction routed × mean prob, summed over experts
        frac = onehot.to(probs.dtype).mean(dim=0)
        mean_p = probs.mean(dim=0)
        aux = E * torch.sum(frac * mean_p)
        return out, aux


class MoEBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, num_experts: int = 8,
                 mlp_ratio: int = 4, capacity_factor: float = 1.25,
                 attn_mode: str = "dense", ep_axis: Optional[str] = None,
                 *, gen: torch.Generator, device):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads, attn_mode, gen,
                                       device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.moe = MoEFFN(d_model, num_experts, mlp_ratio, capacity_factor,
                          ep_axis, gen=gen, device=device)

    def forward(self, x):
        B, T, D = x.shape
        x = x + self.attn(self.ln1(x))
        out, aux = self.moe(self.ln2(x).reshape(B * T, D))
        return x + out.reshape(B, T, D), aux


class MoESensorFormer(nn.Module):
    """SensorFormer with MoE FFN blocks over [B, T, features], on
    ``device`` (``cuda`` unless given), weights drawn on the CPU from
    ``generator`` (seed 0 when None); returns ``(pred, aux_total)``."""

    def __init__(self, features: int = 18, d_model: int = 64,
                 num_heads: int = 4, num_layers: int = 2,
                 num_experts: int = 8, capacity_factor: float = 1.25,
                 max_len: int = 4096, attn_mode: str = "dense",
                 ep_axis: Optional[str] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_mode not in ATTN_MODES or attn_mode == "ring":
            raise ValueError(f"unknown attn_mode {attn_mode}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.features, self.d_model = features, d_model
        self.num_heads, self.num_layers = num_heads, num_layers
        self.num_experts, self.capacity_factor = num_experts, capacity_factor
        self.max_len, self.attn_mode = max_len, attn_mode
        self.embed = _linear(features, d_model, gen, device)
        self.pos = nn.Embedding.from_pretrained(
            (torch.randn(max_len, d_model, generator=gen)
             / math.sqrt(d_model)).to(device), freeze=False)
        for i in range(num_layers):
            setattr(self, f"block{i}", MoEBlock(
                d_model, num_heads, num_experts,
                capacity_factor=capacity_factor, attn_mode=attn_mode,
                ep_axis=ep_axis, gen=gen, device=device))
        self.ln_f = LayerNorm(d_model, device=device)
        self.head = _linear(d_model, features, gen, device)

    def set_ep_axis(self, ep_axis: Optional[str]) -> "MoESensorFormer":
        """Name the mesh axis the experts are cut over (flax's
        ``clone(ep_axis=…)``, in place)."""
        for m in self.modules():
            if isinstance(m, MoEFFN):
                m.ep_axis = ep_axis
        return self

    def forward(self, x, positions: Optional[torch.Tensor] = None):
        """x: [B, T, features]; positions: None (0..T-1), [T] or [B, T]."""
        T = x.shape[1]
        if positions is None and T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len="
                             f"{self.max_len}")
        pos = torch.arange(T, device=x.device) if positions is None \
            else positions
        h = self.embed(x) + self.pos(pos)
        aux_total = None
        for i in range(self.num_layers):
            h, aux = getattr(self, f"block{i}")(h)
            aux_total = aux if aux_total is None else aux_total + aux
        return self.head(self.ln_f(h)), aux_total
