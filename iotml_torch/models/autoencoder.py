"""Dense anomaly-detection autoencoder (``iotml.models.autoencoder``'s twin).

    input_dim → Dense(encoding_dim, tanh, L1 activity reg)
              → Dense(hidden_dim, relu)
              → Dense(hidden_dim, tanh)
              → Dense(input_dim, relu)

with 18/14/7 (car) or 30/14/7 (creditcard), L1 activity coefficient
1e-7.  Keras semantics that shape training are kept: the activity
penalty is ``l1 * sum(|h|) / batch`` over the first encoder layer's
output (batch = leading dim, masked rows included), kernels are
Glorot-uniform and biases zero.

``AutoencoderSpec`` is the stateless description (what a flax module is
in the JAX package); ``DenseAutoencoder`` is the ``nn.Module`` built from
it on a device.  Submodule names match the flax param tree
(``encoder0`` … ``decoder1``); ``nn.Linear`` keeps weights as
[out, in] where flax kernels are [in, out] (``models.convert`` maps).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from . import initializers as init

#: layer names in forward order (the flax param-tree keys)
LAYERS = ("encoder0", "encoder1", "decoder0", "decoder1")
#: state_dict keys in forward order: W1, b1, W2, b2, W3, b3, W4, b4
PARAM_NAMES = tuple(f"{layer}.{leaf}" for layer in LAYERS
                    for leaf in ("weight", "bias"))


@dataclasses.dataclass(frozen=True)
class AutoencoderSpec:
    input_dim: int = 18
    encoding_dim: int = 14
    hidden_dim: int = 7
    activity_l1: float = 1e-7

    def build(self, device: DeviceLike = None,
              generator: Optional[torch.Generator] = None
              ) -> "DenseAutoencoder":
        return DenseAutoencoder(self, device=device, generator=generator)


class DenseAutoencoder(nn.Module):
    """The autoencoder on ``device`` (``cuda`` unless given), with
    Glorot-uniform weights drawn on the CPU from ``generator`` (seed 0
    when None) so the same seed gives the same weights on any device."""

    def __init__(self, spec: Optional[AutoencoderSpec] = None, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        spec = spec if spec is not None else AutoencoderSpec()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.activity_l1 = spec.activity_l1
        dims = ((spec.input_dim, spec.encoding_dim),
                (spec.encoding_dim, spec.hidden_dim),
                (spec.hidden_dim, spec.hidden_dim),
                (spec.hidden_dim, spec.input_dim))
        for name, (fan_in, fan_out) in zip(LAYERS, dims):
            setattr(self, name, init.linear(
                fan_in, fan_out, init.glorot_uniform(fan_out, fan_in, gen),
                bias=True, device=device))

    def forward(self, x: torch.Tensor, with_penalty: bool = False,
                penalty_rows: Optional[int] = None):
        """``penalty_rows`` is the batch the penalty divides by when
        ``x`` is one shard of it (``x.shape[0]`` unless given)."""
        h = torch.tanh(self.encoder0(x))
        # Keras activity regularizer: l1 * sum(|h|) / batch
        penalty = self.activity_l1 * torch.sum(torch.abs(h)) / (
            x.shape[0] if penalty_rows is None else penalty_rows)
        out = F.relu(self.decoder1(torch.tanh(self.decoder0(
            F.relu(self.encoder1(h))))))
        if with_penalty:
            return out, penalty
        return out

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Latent code (first two layers)."""
        return F.relu(self.encoder1(torch.tanh(self.encoder0(x))))


# The two variants the reference ships.
CAR_AUTOENCODER = AutoencoderSpec(input_dim=18)
CREDITCARD_AUTOENCODER = AutoencoderSpec(input_dim=30)


def reconstruction_error(model: DenseAutoencoder, params,
                         x: torch.Tensor) -> torch.Tensor:
    """Per-row reconstruction MSE — the anomaly score (threshold 5 in
    the reference's analysis).  ``params`` is a state_dict, or None for
    the module's own weights."""
    recon = model(x) if params is None else \
        torch.func.functional_call(model, params, (x,))
    return torch.mean(torch.square(recon - x), dim=-1)
