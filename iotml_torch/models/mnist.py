"""MNIST smoke-test models (``iotml.models.mnist``'s twin).

The reference uses an MNIST-over-Kafka pair as the ingestion smoke test
(confluent-tensorflow-io-kafka.py:44-58) plus a no-Kafka control
(confluent-tensorflow-io-kafka-simplified.py:9-29) to tell ingestion bugs
from model bugs.  The same two models here, with flax's layer names
(``Dense_0``, ``Dense_1``) and its Dense init (lecun-normal kernels, zero
biases), drawn on the CPU from ``generator`` (seed 0 when None) and
placed on ``device`` (``cuda`` unless given).

``forward(x, train=False)`` takes ``train`` as the flax modules do:
dropout fires only when it is true, whatever the module's own
``training`` flag says.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import DeviceLike, resolve_device
from . import initializers as init

PIXELS = 28 * 28


class _Dense2(nn.Module):
    def __init__(self, hidden: int, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        self.Dense_0 = init.linear(PIXELS, hidden,
                                   init.lecun_normal(hidden, PIXELS, gen),
                                   bias=True, device=device)
        self.Dense_1 = init.linear(hidden, 10,
                                   init.lecun_normal(10, hidden, gen),
                                   bias=True, device=device)

    def _hidden(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1) / 255.0
        return F.relu(self.Dense_0(x))


class MNISTClassifier(_Dense2):
    """Flatten → Dense(128, relu) → Dense(10) (softmax applied in loss)."""

    def __init__(self, hidden: int = 128, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hidden, device, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.Dense_1(self._hidden(x))  # logits


class MNISTBaseline(_Dense2):
    """Flatten → Dense(512, relu) → Dropout(0.2) → Dense(10) (control model)."""

    def __init__(self, hidden: int = 512, dropout: float = 0.2, *,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hidden, device, generator)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = F.dropout(self._hidden(x), self.dropout, training=train)
        return self.Dense_1(h)
