"""SensorFormer: causal transformer over per-car sensor histories
(``iotml.models.transformer``'s twin).

Next-step prediction over ``[B, T, features]``: the model reads sensor
vectors 1..t and predicts t+1, and the anomaly score is the next-step
prediction error — the sequence counterpart of the autoencoder's
reconstruction error.  Pre-norm blocks; submodule names follow the flax
param tree (``embed``, ``pos``, ``block{i}.attn.qkv`` / ``.out``,
``ln1``, ``ln2``, ``mlp_in``, ``mlp_out``, ``ln_f``, ``head``), and
``models.convert`` maps the weights both ways.

Flax details kept: ``LayerNorm`` uses epsilon 1e-6 and the fast variance
E[x²] − E[x]² (clamped at 0); ``gelu`` is the tanh approximation; ``qkv``
splits [B, T, 3, H, D] on the ``3`` axis.

``attn_mode``:
  'dense'           – ``attention_reference``
  'flash'           – ``flash_attention``: the Hopper kernel on the card,
                      its plain version for CPU tensors
  'flash_reference' – ``flash_attention_reference`` on any device: the
                      kernel's plain version, as flax's 'flash_interpret'
                      runs the Pallas kernel's body without the TPU
  'ring'            – sequence-parallel ring attention: raises
                      NotImplementedError until the multi-GPU slice
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (attention_reference, flash_attention,
                             flash_attention_reference)
from ..utils.device import DeviceLike, resolve_device

ATTN_MODES = ("dense", "flash", "flash_reference", "ring")
#: flax's defaults: LayerNorm epsilon, MLP width over d_model
LN_EPS = 1e-6
MLP_RATIO = 4


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: epsilon 1e-6, var = max(E[x²] − E[x]², 0)."""

    def __init__(self, features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) \
            + self.bias


def _linear(fan_in: int, fan_out: int, gen: torch.Generator,
            device) -> nn.Linear:
    """nn.Linear with LeCun-normal weights drawn on the CPU from ``gen``
    and a zero bias (flax Dense's init, not bit for bit)."""
    layer = nn.Linear(fan_in, fan_out, device="meta")
    w = torch.randn(fan_out, fan_in, generator=gen) / math.sqrt(fan_in)
    layer.weight = nn.Parameter(w.to(device))
    layer.bias = nn.Parameter(torch.zeros(fan_out, device=device))
    return layer


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, num_heads: int, attn_mode: str,
                 gen: torch.Generator, device):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = d_model // num_heads
        self.attn_mode = attn_mode
        hd = num_heads * self.head_dim
        self.qkv = _linear(d_model, 3 * hd, gen, device)
        self.out = _linear(hd, d_model, gen, device)

    def forward(self, x):
        B, T, _ = x.shape
        H, D = self.num_heads, self.head_dim
        q, k, v = self.qkv(x).view(B, T, 3, H, D).unbind(dim=2)
        if self.attn_mode == "dense":
            o = attention_reference(q, k, v, causal=True)
        elif self.attn_mode == "flash":
            o = flash_attention(q, k, v, causal=True)
        else:  # flash_reference
            o, _ = flash_attention_reference(q, k, v, causal=True)
        return self.out(o.reshape(B, T, H * D))


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, attn_mode: str,
                 gen: torch.Generator, device):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.attn = MultiHeadAttention(d_model, num_heads, attn_mode, gen,
                                       device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.mlp_in = _linear(d_model, d_model * MLP_RATIO, gen, device)
        self.mlp_out = _linear(d_model * MLP_RATIO, d_model, gen, device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class SensorFormer(nn.Module):
    """Next-step sensor prediction over [B, T, features], on ``device``
    (``cuda`` unless given), with weights drawn on the CPU from
    ``generator`` (seed 0 when None)."""

    def __init__(self, features: int = 18, d_model: int = 64,
                 num_heads: int = 4, num_layers: int = 2,
                 max_len: int = 4096, attn_mode: str = "dense", *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attn_mode == "ring":
            raise NotImplementedError(
                "attn_mode='ring' (sequence-parallel ring attention) comes "
                "with the port's multi-GPU slice")
        if attn_mode not in ATTN_MODES:
            raise ValueError(f"unknown attn_mode {attn_mode}")
        if d_model % num_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"num_heads {num_heads}")
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.features, self.d_model = features, d_model
        self.num_heads, self.num_layers = num_heads, num_layers
        self.max_len, self.attn_mode = max_len, attn_mode
        self.embed = _linear(features, d_model, gen, device)
        self.pos = nn.Embedding.from_pretrained(
            (torch.randn(max_len, d_model, generator=gen)
             / math.sqrt(d_model)).to(device), freeze=False)
        for i in range(num_layers):
            setattr(self, f"block{i}", Block(d_model, num_heads, attn_mode,
                                             gen, device))
        self.ln_f = LayerNorm(d_model, device=device)
        self.head = _linear(d_model, features, gen, device)

    def forward(self, x, positions: Optional[torch.Tensor] = None):
        """x: [B, T, features]; positions: None (0..T-1), [T] or [B, T]."""
        T = x.shape[1]
        if positions is None and T > self.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len="
                             f"{self.max_len}")
        pos = torch.arange(T, device=x.device) if positions is None \
            else positions
        # [T, d] or [B, T, d]: broadcasts over the batch either way
        h = self.embed(x) + self.pos(pos)
        for i in range(self.num_layers):
            h = getattr(self, f"block{i}")(h)
        return self.head(self.ln_f(h))

    @staticmethod
    def anomaly_scores(pred, x):
        """Per-step next-step prediction error: pred[t] estimates x[t+1].
        Returns [B, T-1]."""
        return torch.mean(torch.square(pred[:, :-1] - x[:, 1:]), dim=-1)
