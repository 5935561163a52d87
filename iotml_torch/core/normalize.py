"""Per-field affine normalization (``iotml.core.normalize``'s twin).

Each sensor maps from its (lo, hi) range to (-1, 1) as one
``x * scale + shift`` with a zero mask for the fields the reference
never calibrated.  ``parity=True`` reproduces the reference, zeroed
fields included; ``parity=False`` also normalizes the four TODO fields
with ranges taken from the reference's CSV fixture.
"""

from __future__ import annotations

import numpy as np
import torch

from .schema import CAR_SCHEMA, RecordSchema

# Ranges for the four fields the reference leaves as TODO (min/max of
# the reference's car-sensor-data.csv, rounded out).
_FIXED_RANGES = {
    "coolant_temp": (15.0, 60.0),
    "intake_air_flow_speed": (0.0, 170.0),
    "battery_voltage": (190.0, 255.0),
    "current_draw": (0.0, 40.0),
}


class Normalizer:
    """Precomputed scale/shift/mask for one record schema.

    ``scale``, ``shift`` and ``mask`` are float32 numpy constants;
    ``__call__`` applies them to a tensor on the tensor's device, and
    ``np`` is the float64 host twin the batcher uses.
    """

    def __init__(self, schema: RecordSchema = CAR_SCHEMA,
                 parity: bool = True):
        fields = schema.sensor_fields
        n = len(fields)
        scale = np.zeros((n,), np.float64)
        shift = np.zeros((n,), np.float64)
        mask = np.zeros((n,), np.float64)
        for i, f in enumerate(fields):
            rng = f.norm
            if rng is None and not parity:
                rng = _FIXED_RANGES.get(f.name.lower())
            if rng is None:
                continue  # masked to zero
            lo, hi = rng
            scale[i] = 2.0 / (hi - lo)
            shift[i] = -2.0 * lo / (hi - lo) - 1.0
            mask[i] = 1.0
        self.scale = scale.astype(np.float32)
        self.shift = shift.astype(np.float32)
        self.mask = mask.astype(np.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Normalize a [..., num_sensors] tensor in float32."""
        x = torch.as_tensor(x, dtype=torch.float32)

        def const(a):
            return torch.from_numpy(a).to(x.device)

        return (x * const(self.scale) + const(self.shift)) * const(self.mask)

    def np(self, x: np.ndarray) -> np.ndarray:
        """Host-side twin: float64 arithmetic on the float32 constants,
        rounded to float32 once at the end."""
        x = np.asarray(x, np.float64)
        out = (x * self.scale.astype(np.float64)
               + self.shift.astype(np.float64)) * self.mask.astype(np.float64)
        return out.astype(np.float32)


class IdentityNormalizer:
    """Raw columns for device-side normalization: the batcher ships the
    decoder's float32 columns untouched (``np`` is a cast-only view, no
    copy when already float32) and the sharded step applies the real
    normalizer's affine map on each device
    (``parallel.data_parallel.make_device_normalized_step``)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32)

    def np(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x).astype(np.float32, copy=False)


#: the one raw-columns instance the streaming pipelines share
RAW_COLUMNS = IdentityNormalizer()

# The reference-parity normalizer the pipeline uses by default.
CAR_NORMALIZER = Normalizer(CAR_SCHEMA, parity=True)

# Detection-grade normalizer: the four TODO fields carry signal.
FULL_NORMALIZER = Normalizer(CAR_SCHEMA, parity=False)
