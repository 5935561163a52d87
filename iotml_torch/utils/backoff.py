"""Bounded exponential backoff with jitter (``iotml.utils.backoff``'s copy).

The scorer's rewind-on-ConnectionError loop retries with delays that
grow from ``base_s`` to a hard ``cap_s``, each multiplied by a uniform
jitter in [0.5, 1.0], so a dead broker is not busy-polled and a fleet of
retriers does not come back in step.  The jitter source is injectable
(``rng``) so tests pin exact sequences.
"""

from __future__ import annotations

import random
from typing import Optional


class ExpBackoff:
    """delay_n = min(cap_s, base_s * factor**n) * uniform(0.5, 1.0)."""

    def __init__(self, base_s: float = 0.05, cap_s: float = 2.0,
                 factor: float = 2.0,
                 rng: Optional[random.Random] = None):
        if base_s <= 0 or cap_s < base_s or factor <= 1.0:
            raise ValueError(
                f"need 0 < base_s <= cap_s and factor > 1, got "
                f"base_s={base_s} cap_s={cap_s} factor={factor}")
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self._rng = rng if rng is not None else random.Random()
        self._n = 0

    def next_delay(self) -> float:
        """The next sleep, advancing the schedule."""
        raw = min(self.cap_s, self.base_s * self.factor ** self._n)
        self._n += 1
        return raw * (0.5 + 0.5 * self._rng.random())

    def reset(self) -> None:
        """Back to ``base_s``: call after a successful round."""
        self._n = 0

    @property
    def attempt(self) -> int:
        """Consecutive failures so far (0 after reset)."""
        return self._n
