"""TwinFeatureStore — the twin table as per-car model features
(``iotml.twin.features``'s copy).

The scorer's live window says what a car looks like *right now*; the
twin says what it has looked like *lately*.  Joining the two is the
classic feature-store enrichment: per-car historical features are
concatenated onto each live row before it enters the model, so an
autoencoder trained on the joined layout learns per-car context (a
reading that is normal for the fleet but abnormal *for this car* becomes
visible).

Feature vector layout (dim = F + 2, F = sensor fields):

    [0:F]  normalized rolling-window MEAN per sensor field — same
           Normalizer the live rows go through, so both halves of the
           joined input live on the same scale;
    [F]    tanh-squashed record count (how much history backs this car);
    [F+1]  lifetime failure rate.

Unknown cars get the zero vector — the "no history" null the model sees
for a car's first records, so cold-start scoring degrades gracefully.
``matrix`` and ``dim`` are the duck type ``serve.scorer.StreamScorer``
joins through; ``gateway.router.GatewayClient`` serves the same duck type
from the sharded twin.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..core.normalize import CAR_NORMALIZER, Normalizer
from .state import TwinTable


class TwinFeatureStore:
    """Vector view over a TwinTable (or a TwinService's table)."""

    def __init__(self, source, normalizer: Normalizer = CAR_NORMALIZER):
        # accepts a TwinService (joins its live table) or a bare TwinTable
        self.table: TwinTable = getattr(source, "table", source)
        self.normalizer = normalizer
        self.dim = len(normalizer.scale) + 2

    def vector(self, key: Optional[bytes]) -> np.ndarray:
        """[dim] float32 features for one car key (zeros = no history)."""
        out = np.zeros((self.dim,), np.float32)
        if key is None:
            return out
        twin = self.table.get(key.decode() if isinstance(key, bytes)
                              else str(key))
        if twin is None or not twin.window:
            return out
        mean = np.mean(np.asarray(twin.window, np.float64), axis=0)
        out[:self.dim - 2] = self.normalizer.np(mean)
        out[self.dim - 2] = math.tanh(twin.count / 100.0)
        out[self.dim - 1] = twin.failures / twin.count
        return out

    def matrix(self, keys, n: int) -> np.ndarray:
        """[n, dim] float32 rows for a batch's keys array (None keys and
        padding rows beyond len(keys) are zero — the no-history null)."""
        out = np.zeros((n, self.dim), np.float32)
        if keys is None:
            return out
        for i, k in enumerate(keys[:n]):
            if k:
                out[i] = self.vector(k)
        return out
