"""iotml_torch.online — true online learning with drift-triggered
adaptation (``iotml.online``'s twin).

- ``OnlineLearner``: per-window SGD folded into the consume loop, with
  ``ContinuousTrainer``'s cursor/commit discipline so offsets-as-
  checkpoint still holds;
- ``PageHinkley`` / ``AdaptiveWindow`` (ADWIN-style) streaming drift
  detectors over the reconstruction-error signal, composed by
  ``DriftMonitor`` into a STABLE → ADAPTING → STABLE state machine;
- drift-triggered adaptation (``AdaptationPolicy``): learning-rate
  boost, detector-window reset, or a replay-buffer refit on the fused
  fit kernel — each adapted model published through the ``ModelRegistry``
  so the scorer fleet hot-swaps it via the ``RegistryWatcher``, with the
  A/B rollback gate protecting against a bad adaptation.

Proof lives in ``iotml_torch.online.drill`` (the drift-adapt-swap drill).
"""

from .detectors import (ADAPTING, STABLE, AdaptiveWindow, DriftMonitor,
                        PageHinkley)
from .learner import AdaptationPolicy, OnlineLearner

__all__ = ["AdaptiveWindow", "AdaptationPolicy", "ADAPTING",
           "DriftMonitor", "OnlineLearner", "PageHinkley", "STABLE"]
