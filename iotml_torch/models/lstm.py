"""LSTM sequence-to-sequence next-step predictor (``iotml.models.lstm``'s
twin).

Parity with the reference supervised model (LSTM cardata-v1.py:170-176):

    LSTM(32, relu, return_sequences) → LSTM(16, relu, last-step)
    → RepeatVector(look_back) → LSTM(16, relu, seq) → LSTM(32, relu, seq)
    → TimeDistributed(Dense(features))

Each layer is flax's ``nn.RNN(nn.OptimizedLSTMCell(activation_fn=relu))``:
the carry (c, h) starts at zero and the cell runs over axis 1, with

    i = σ(x W_ii + h W_hi + b_hi)     f = σ(x W_if + h W_hf + b_hf)
    g = relu(x W_ig + h W_hg + b_hg)  o = σ(x W_io + h W_ho + b_ho)
    c' = f c + i g                    h' = o relu(c')

The cell is written here from tensor ops: ``torch.nn.LSTM`` (and cuDNN)
has tanh where Keras's ``LSTM(activation='relu')`` has relu, and so
computes another function.  Parameters keep flax's names and split: an
input kernel per gate without a bias (``ii``, ``if``, ``ig``, ``io``), a
recurrent kernel per gate with the bias (``hi`` …); ``models.convert``
maps them.  The four gates' products run as one product each way, as
flax's cell concatenates them; the input's product runs over every step
at once.

``LSTMSpec`` is the stateless description (what the flax module is in
the JAX package); ``LSTMSeq2Seq`` is the ``nn.Module`` built from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from . import initializers as init

#: gate order: flax's (and Keras's) i, f, g, o
GATES = ("i", "f", "g", "o")


class ReluLSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell(units, activation_fn=relu)``: input
    kernels lecun-normal, recurrent kernels orthogonal, biases zero."""

    def __init__(self, in_features: int, units: int, device,
                 gen: torch.Generator):
        super().__init__()
        self.units = units
        for g in GATES:
            self.add_module(f"i{g}", init.linear(
                in_features, units, init.lecun_normal(units, in_features, gen),
                bias=False, device=device))
            self.add_module(f"h{g}", init.linear(
                units, units, init.orthogonal(units, gen), bias=True,
                device=device))

    def _gates(self, prefix: str):
        return [getattr(self, prefix + g) for g in GATES]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, in] → every step's h, [B, T, units]."""
        B, T, _ = x.shape
        w_i = torch.cat([m.weight for m in self._gates("i")])
        hs = self._gates("h")
        w_h = torch.cat([m.weight for m in hs])
        b_h = torch.cat([m.bias for m in hs])
        zi = F.linear(x, w_i)  # [B, T, 4u], every step at once
        c = x.new_zeros(B, self.units)
        h = x.new_zeros(B, self.units)
        out = []
        for t in range(T):
            z = F.linear(h, w_h, b_h) + zi[:, t]
            i, f, g, o = torch.split(z, self.units, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * F.relu(g)
            h = torch.sigmoid(o) * F.relu(c)
            out.append(h)
        return torch.stack(out, dim=1)


class LSTMSeq2Seq(nn.Module):
    """The model on ``device`` (``cuda`` unless given), weights drawn on
    the CPU from ``generator`` (seed 0 when None)."""

    def __init__(self, features: int = 18, look_back: int = 1,
                 enc_units: Tuple[int, ...] = (32, 16),
                 dec_units: Tuple[int, ...] = (16, 32), *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.look_back = look_back
        self.enc = [f"enc{i}" for i in range(len(enc_units))]
        self.dec = [f"dec{i}" for i in range(len(dec_units))]
        width = features
        for name, u in zip(self.enc + self.dec, enc_units + dec_units):
            self.add_module(name, ReluLSTMCell(width, u, device, gen))
            width = u
        self.head = init.linear(width, features,
                                init.glorot_uniform(features, width, gen),
                                bias=True, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, F] → [B, look_back, F] next-step prediction."""
        h = x
        for name in self.enc:
            h = getattr(self, name)(h)
        code = h[:, -1, :]  # Keras return_sequences=False → last step
        h = code[:, None, :].expand(-1, self.look_back, -1)  # RepeatVector
        for name in self.dec:
            h = getattr(self, name)(h)
        return self.head(h)  # TimeDistributed(Dense(features))


@dataclasses.dataclass(frozen=True)
class LSTMSpec:
    features: int = 18
    look_back: int = 1
    enc_units: Tuple[int, ...] = (32, 16)
    dec_units: Tuple[int, ...] = (16, 32)

    def build(self, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None) -> LSTMSeq2Seq:
        return LSTMSeq2Seq(self.features, self.look_back, self.enc_units,
                           self.dec_units, device=device, generator=generator)
