"""flax's default initializers as CPU draws from a ``torch.Generator``.

Weights are drawn on the CPU and then moved, so one seed gives the same
weights on any device.  Shapes are ``nn.Linear``'s, [out, in]; the
distributions are flax's for its [in, out] kernels (fan-in is ``in``).
"""

from __future__ import annotations

import math

import torch

#: the std of a unit normal truncated to [-2, 2] (flax's variance_scaling
#: divides by it so the truncated draw keeps the asked-for variance)
_TRUNC_STD = 0.87962566103423978


def lecun_normal(out_features: int, in_features: int,
                 gen: torch.Generator) -> torch.Tensor:
    """flax ``lecun_normal``: variance 1/fan_in, normal truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / in_features) / _TRUNC_STD
    w = torch.empty(out_features, in_features)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=gen)


def glorot_uniform(out_features: int, in_features: int,
                   gen: torch.Generator) -> torch.Tensor:
    limit = math.sqrt(6.0 / (in_features + out_features))
    return torch.empty(out_features, in_features).uniform_(
        -limit, limit, generator=gen)


def orthogonal(n: int, gen: torch.Generator) -> torch.Tensor:
    """flax ``orthogonal()`` for a square kernel."""
    return torch.nn.init.orthogonal_(torch.empty(n, n), generator=gen)


def linear(in_features: int, out_features: int, weight: torch.Tensor,
           bias: bool, device) -> torch.nn.Linear:
    """An ``nn.Linear`` on ``device`` holding ``weight`` and a zero bias."""
    layer = torch.nn.Linear(in_features, out_features, bias=bias,
                            device="meta")
    layer.weight = torch.nn.Parameter(weight.to(device))
    if bias:
        layer.bias = torch.nn.Parameter(torch.zeros(out_features,
                                                    device=device))
    return layer
