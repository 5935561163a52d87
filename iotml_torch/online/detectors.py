"""Streaming drift detectors (``iotml.online.detectors``'s twin).

The online learner's drift signal is the reconstruction-error stream:
an autoencoder trained on one sensor distribution reconstructs a
shifted distribution badly, so a sustained error increase IS the drift
(the converse — a model improving on a stationary stream — only ever
moves the signal down, which neither detector fires on).

Two classic detectors, both O(1)-ish per update and free of wall
clocks:

- ``PageHinkley``: the one-sided Page-Hinkley test — cumulative
  deviation above the running mean minus a drift allowance ``delta``;
  fires when the deviation exceeds ``threshold``.  Cheap and fast on
  abrupt (step) drift.
- ``AdaptiveWindow``: an ADWIN-style adaptive window (Bifet & Gavaldà
  2007): exponential bucket compression keeps O(log n) state, and the
  window drops its oldest buckets whenever two sub-windows disagree in
  mean beyond a Hoeffding-like cut ``epsilon(delta)``.  Catches slow
  ramps Page-Hinkley's allowance absorbs, and its post-cut window is
  exactly the "recent distribution" a window-reset adaptation wants.

``DriftMonitor`` composes both over the smoothed error signal and owns
the adaptation state machine (STABLE → ADAPTING → STABLE) plus the
baseline band convergence is judged against.

Plain Python ``math`` in the JAX package's order of operations, so the
same inputs give the same return values, statistics and states at every
step in both packages.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple


class PageHinkley:
    """One-sided (increase-detecting) Page-Hinkley test.

    Args:
      delta: drift allowance per observation — deviations below it
        never accumulate (robustness to noise).
      threshold: the PH statistic level that signals drift (lambda in
        the literature).  Scale both to the signal's units.
      burn_in: observations before the test may fire (the running mean
        is meaningless on the first few points).
    """

    def __init__(self, delta: float = 0.005, threshold: float = 0.5,
                 burn_in: int = 10):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.burn_in = int(burn_in)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self._cum = 0.0
        self._cum_min = 0.0
        self.stat = 0.0

    def update(self, x: float) -> bool:
        """Feed one observation; True when the test fires.  The caller
        owns the reset — a fired test keeps firing until reset()."""
        self.n += 1
        self.mean += (x - self.mean) / self.n
        self._cum += x - self.mean - self.delta
        self._cum_min = min(self._cum_min, self._cum)
        self.stat = self._cum - self._cum_min
        return self.n > self.burn_in and self.stat > self.threshold


class AdaptiveWindow:
    """ADWIN-style adaptive sliding window over a bounded-state sketch.

    State is rows of exponentially-sized buckets (row i buckets cover
    ``2**i`` observations, at most ``max_buckets`` per row), so a
    million-observation window costs ~log2(n) * max_buckets tuples.
    Every ``check_every`` updates the window is scanned at bucket
    boundaries: if some split has |mean(old) − mean(recent)| above the
    Hoeffding-like cut, the old side is dropped — the window *adapts*
    to hold only the post-change distribution.
    """

    def __init__(self, delta: float = 0.002, max_buckets: int = 5,
                 min_window: int = 16, check_every: int = 4):
        self.delta = float(delta)
        self.max_buckets = int(max_buckets)
        self.min_window = int(min_window)
        self.check_every = max(1, int(check_every))
        self.reset()

    def reset(self) -> None:
        # rows[i] = list of (sum, sumsq, count) buckets, count == 2**i
        # each; rows[0] is the newest (per-observation) row.  Within a
        # row, index 0 is the OLDEST bucket.
        self._rows: List[List[Tuple[float, float, int]]] = [[]]
        self.total = 0.0
        self.total_sq = 0.0
        self.width = 0
        self._since_check = 0
        self.last_cut: Optional[int] = None  # width dropped by last cut

    # ----------------------------------------------------------- update
    @property
    def mean(self) -> float:
        return self.total / self.width if self.width else 0.0

    @property
    def variance(self) -> float:
        if self.width < 2:
            return 0.0
        return max(0.0, self.total_sq / self.width - self.mean ** 2)

    def update(self, x: float) -> bool:
        """Feed one observation; True when the window cut (drift)."""
        x = float(x)
        self._rows[0].append((x, x * x, 1))
        self.total += x
        self.total_sq += x * x
        self.width += 1
        self._compress()
        self._since_check += 1
        if self._since_check < self.check_every \
                or self.width < self.min_window:
            return False
        self._since_check = 0
        return self._cut()

    def _compress(self) -> None:
        """Merge row overflow upward: 2 oldest buckets of row i become
        1 bucket of row i+1 (classic ADWIN bucket maintenance)."""
        i = 0
        while i < len(self._rows):
            row = self._rows[i]
            if len(row) <= self.max_buckets:
                break
            if i + 1 == len(self._rows):
                self._rows.append([])
            a, b = row.pop(0), row.pop(0)
            self._rows[i + 1].append((a[0] + b[0], a[1] + b[1],
                                      a[2] + b[2]))
            i += 1

    def _buckets_old_first(self) -> List[Tuple[float, float, int]]:
        """Every bucket, oldest → newest (rows store coarse=old last)."""
        out: List[Tuple[float, float, int]] = []
        for row in reversed(self._rows):
            out.extend(row)
        return out

    def _cut(self) -> bool:
        """Scan split points oldest-first; drop the old side of the
        first split whose mean gap beats the variance-adaptive
        epsilon_cut (the ADWIN2 bound — scale-aware, so raw error
        signals work without pre-normalization)."""
        buckets = self._buckets_old_first()
        if len(buckets) < 2:
            return False
        n, tot = self.width, self.total
        var = self.variance
        dp = math.log(2.0 * math.log(max(n, 3)) / self.delta)
        n0 = 0.0
        s0 = 0.0
        cut_at = None
        for i in range(len(buckets) - 1):
            s0 += buckets[i][0]
            n0 += buckets[i][2]
            n1 = n - n0
            if n0 < 2 or n1 < 2:
                continue
            m = 1.0 / (1.0 / n0 + 1.0 / n1)  # harmonic mean of sizes
            eps = math.sqrt((2.0 / m) * var * dp) + (2.0 / (3.0 * m)) * dp
            if abs(s0 / n0 - (tot - s0) / n1) > eps:
                cut_at = i
        if cut_at is None:
            return False
        dropped = buckets[: cut_at + 1]
        kept = buckets[cut_at + 1:]
        self.last_cut = int(sum(c for _s, _q, c in dropped))
        # rebuild rows from the kept buckets (oldest-first input)
        self._rows = [[]]
        self.total = 0.0
        self.total_sq = 0.0
        self.width = 0
        for s, q, c in kept:
            row = max(0, (c - 1).bit_length() if c > 1 else 0)
            while len(self._rows) <= row:
                self._rows.append([])
            self._rows[row].append((s, q, c))
            self.total += s
            self.total_sq += q
            self.width += c
        return True


#: DriftMonitor states
STABLE = "stable"
ADAPTING = "adapting"


class DriftMonitor:
    """Both detectors over the (EWMA-smoothed) error signal + the
    adaptation state machine.

    The raw signal is reconstruction error per update window; the
    monitor feeds detectors the signal NORMALIZED by its own stable
    baseline (so detector thresholds are scale-free: "error rose to
    1.5× its stable level" means the same at any absolute error).

    States:
      STABLE   — tracking the baseline; detectors armed.
      ADAPTING — a drift fired; the learner is adapting.  Detectors
        are quiet (an adaptation transient must not re-trigger), and
        the monitor watches for convergence: the smoothed error back
        inside ``converge_ratio`` × baseline, at which point the
        baseline re-anchors to the NEW normal and the state returns to
        STABLE.
    """

    def __init__(self, detector: str = "both",
                 ph_delta: float = 0.15, ph_threshold: float = 2.5,
                 adwin_delta: float = 0.002,
                 level_ratio: float = 1.25, level_windows: int = 4,
                 ewma_alpha: float = 0.3, baseline_alpha: float = 0.05,
                 converge_ratio: float = 1.5, burn_in: int = 12,
                 max_adapting_updates: int = 400):
        if detector not in ("ph", "adwin", "both"):
            raise ValueError(f"detector must be ph|adwin|both, "
                             f"got {detector!r}")
        self.detector = detector
        self.ph = PageHinkley(delta=ph_delta, threshold=ph_threshold,
                              burn_in=burn_in)
        self.adwin = AdaptiveWindow(delta=adwin_delta)
        #: the LEVEL rule, the monitor's own safety net on top of the
        #: change detectors: an ONLINE learner self-heals a drift at
        #: its base learning rate, so Page-Hinkley's running mean can
        #: catch a slowly-fading excursion before the statistic trips
        #: (measured: a +36% step peaked at PH 2.18 against threshold
        #: 2.5 and decayed).  Sustained smoothed error >= level_ratio
        #: x baseline for level_windows consecutive windows IS drift,
        #: however the change statistics wander.  level_ratio=0
        #: disables (pure-detector unit tests).
        self.level_ratio = float(level_ratio)
        self.level_windows = int(level_windows)
        self._level_run = 0
        self.ewma_alpha = float(ewma_alpha)
        self.baseline_alpha = float(baseline_alpha)
        self.converge_ratio = float(converge_ratio)
        #: fraction of the drift excursion that must heal before an
        #: episode converges: with only the ratio test, a mild drift
        #: (+30%, under converge_ratio) would "converge" on its first
        #: ADAPTING update and cancel its own boost — convergence must
        #: mean the error CAME BACK, not that it never rose far.  Half,
        #: not most: a drifted MIXTURE's reachable floor sits above the
        #: pre-drift floor (more cohorts = harder modeling task), and a
        #: target under that floor would pin the episode at its
        #: timeout instead of at the model's actual recovery
        self.heal_frac = 0.5
        self.burn_in = int(burn_in)
        #: hard bound on the ADAPTING dwell: convergence is a quality
        #: judgement, and a model that CANNOT recover (e.g. drift
        #: beyond its capacity) must not disarm detection forever
        self.max_adapting_updates = int(max_adapting_updates)
        self.state = STABLE
        self.n = 0
        self.ewma: Optional[float] = None
        self.baseline: Optional[float] = None
        self.drifts = 0
        self.converged = 0
        self._adapting_for = 0
        self._episode_peak = 0.0
        self.last_signal: Optional[str] = None

    # ------------------------------------------------------------ feed
    def severity(self) -> float:
        """Current smoothed error over the stable baseline (>= 1 at
        drift time; the policy's mild-vs-severe discriminator)."""
        if not self.baseline or self.ewma is None:
            return 1.0
        return max(1.0, self.ewma / self.baseline)

    def _normalized(self, x: float) -> float:
        return x / self.baseline if self.baseline else 1.0

    def update(self, err: float) -> Optional[str]:
        """Feed one error observation (one learner update window).
        Returns "ph" | "adwin" when a NEW drift fires (once per
        episode), else None."""
        self.n += 1
        self.ewma = err if self.ewma is None else \
            self.ewma + self.ewma_alpha * (err - self.ewma)
        if self.state == ADAPTING:
            self._adapting_for += 1
            base = self.baseline or self.ewma
            self._episode_peak = max(self._episode_peak, self.ewma)
            # healed = back inside the stable band AND most of the
            # excursion gone (the min of the two targets binds: the
            # ratio test for big drifts, the heal fraction for mild
            # ones — see heal_frac)
            target = min(self.converge_ratio * base,
                         base + self.heal_frac
                         * max(self._episode_peak - base, 0.0))
            done = self.ewma <= max(target, base)
            if done or self._adapting_for >= self.max_adapting_updates:
                if done:
                    self.converged += 1
                self._stabilize()
            return None
        if self.n <= self.burn_in or self.baseline is None:
            # establish the baseline before arming: the first windows
            # of a cold-started model are their own transient
            self.baseline = self.ewma if self.baseline is None else \
                self.baseline + self.baseline_alpha * (self.ewma
                                                       - self.baseline)
            self.adwin.update(self._normalized(self.ewma))
            return None
        # detectors see the SMOOTHED signal normalized by the stable
        # baseline: smoothing keeps single-window noise from walking
        # Page-Hinkley over its threshold, normalization makes the
        # thresholds scale-free.  The baseline follows the signal DOWN
        # (a continuously-training model keeps improving, and judging
        # drift against a stale high baseline would mute detection) but
        # never UP while stable — an error increase must be measured
        # against the pre-drift normal, not a mean the drift itself has
        # already dragged up; the baseline re-anchors upward only on
        # post-adaptation convergence.
        if self.ewma < self.baseline:
            self.baseline += self.baseline_alpha * (self.ewma
                                                    - self.baseline)
        x = self._normalized(self.ewma)
        fired = None
        if self.detector in ("ph", "both") and self.ph.update(x):
            fired = "ph"
        # ADWIN is two-sided (any mean change cuts the window) but only
        # an INCREASE is drift here — a continuously-training model's
        # error declining is the system working.  Gate its fire on the
        # signal sitting meaningfully above the stable band: the
        # baseline ratchets on the smoothed MINIMUM, so normalized
        # noise rides slightly above 1.0 by construction, and a gate
        # halfway to the level rule's threshold clears it.
        adwin_gate = (1.0 + self.level_ratio) / 2.0 \
            if self.level_ratio > 0 else 1.1
        if self.detector in ("adwin", "both") and self.adwin.update(x) \
                and x > adwin_gate and fired is None:
            fired = "adwin"
        if self.level_ratio > 0:
            self._level_run = self._level_run + 1 \
                if x >= self.level_ratio else 0
            if self._level_run >= self.level_windows and fired is None:
                fired = "level"
        if fired is not None:
            self.drifts += 1
            self.last_signal = fired
            self.state = ADAPTING
            self._adapting_for = 0
            self._episode_peak = self.ewma
        return fired

    def begin_episode(self, signal: str) -> None:
        """Externally-signalled drift: enter the ADAPTING episode
        exactly as an internal fire would, handing the convergence /
        re-anchor machinery the episode (a no-op while already
        adapting, so several signals of one drift open ONE episode).
        The mesh learner (``OnlineLearner(mesh=...)``) opens its
        per-device episodes here."""
        if self.state == ADAPTING:
            return
        self.drifts += 1
        self.last_signal = signal
        self.state = ADAPTING
        self._adapting_for = 0
        self._episode_peak = self.ewma if self.ewma is not None else 0.0

    # ----------------------------------------------------- transitions
    def _stabilize(self) -> None:
        """Adaptation over: re-anchor the baseline to the new normal
        and re-arm the detectors on fresh windows."""
        self.state = STABLE
        self.baseline = self.ewma
        self.reset_windows()

    def reset_windows(self) -> None:
        """The "window reset" adaptation primitive: both detectors
        forget pre-drift history (Page-Hinkley's cumulative deviation
        and ADWIN's old sub-window are meaningless across a regime
        change)."""
        self.ph.reset()
        self.adwin.reset()
        self._level_run = 0

    def describe(self) -> dict:
        return {"state": self.state, "n": self.n, "drifts": self.drifts,
                "converged": self.converged,
                "baseline": self.baseline, "ewma": self.ewma,
                "ph_stat": self.ph.stat, "adwin_width": self.adwin.width,
                "last_signal": self.last_signal}
