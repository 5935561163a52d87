"""Per-car failure detection (``iotml.serve.carhealth``'s twin), the
predictive-maintenance deliverable.

A copy of the JAX package's detector, numpy only, with the same
arithmetic, so its state and alerts equal the JAX package's on the same
inputs; the alert counter and active gauge of the JAX package's metrics
registry are not ported (ROADMAP A13).

The reference exists to detect failing CARS, not merely anomalous rows
(reference README.md:7,19: "predictive maintenance … detect sensor
anomalies"), yet its pipeline stops at per-record reconstruction error.
Per-record detection is noise-limited: the car autoencoder's irreducible
error (unpredictable sensors: air temp, accelerometers, per-car tire
baselines) overlaps the failure modes' per-record signal, capping
per-record F1 near 0.6 (ARCHITECTURE.md; the e2e bench measures it live).
A car's failure, however, PERSISTS: every record it emits is drawn from
the shifted distribution, so averaging per-record errors over a car's
recent records shrinks the noise by ~1/√N while the failure signal stays
put — the per-car separation is near-total after a few dozen records.

`CarHealthDetector` maintains an exponential moving average of
reconstruction error per car key (the message key: MQTT topic → bridge →
KSQL pass-through), raises an ALERT when a car's EMA crosses the
threshold (after a minimum evidence count), and clears it with hysteresis
at 70% of the threshold.  Alert transitions are emitted as JSON records
onto a stream topic — the digital-twin feed a MongoDB sink consumes, car
id as the record key, same as the reference's twin pipeline shape.

Detection envelope (measured against the scenario generator's injected
modes; round-5 numbers, 120-car offline fleet, 10-epoch model):

- PARITY normalization, mean-MSE path: healthy per-car EMAs span
  ~0.17–0.35 (per-car quirks: tire baselines, firmware, unpredictable
  sensors) — threshold 0.38 sits just above.  High-magnitude faults
  (tire blowout: EMA ≈ 0.41+) alert cleanly; battery sag moves the
  18-feature mean by ~2% and is INVISIBLE — its whole signature
  (voltage sag + current spike) lives in the two fields parity
  normalization zeroes (the reference's TODO fields).
- FULL normalization (core/normalize.FULL_NORMALIZER): healthy mean-EMA
  band rises to ~0.22–0.42 (four more live features carry irreducible
  error) — the mean-MSE threshold for full-norm deployments sits near
  0.6 offline.
- Per-feature ERROR heads (feature_heads=True, full norm): battery sag
  is a z≈700–900 outlier on BATTERY_VOLTAGE's reconstruction error and
  tire blowout z≈400 on its tire's — the model predicts those features
  from their correlates (voltage from battery %, tires from their
  baseline), so a conditional residual is razor-sharp.  Healthy cars
  reach error-z≈13 on quirk features (per-car tire baselines
  reconstruct persistently badly — the "heavy healthy tails" that
  killed round 4's absolute per-feature thresholds).  feature_z=30
  sits in the ~30× gap; feature_floor=0.1 gates features whose fleet
  MAD is numerical dust.  The engine-vibration mode is INVISIBLE to
  the error head: vibration is inherently unpredictable (speed × a
  per-row random factor), its healthy error spread is as wide as the
  fault's excess (measured z≈2).
- Per-feature VALUE-DRIFT heads (same flag): per-car EMAs of the
  normalized feature VALUES against fleet median/MAD, two-sided,
  model-free.  The vibration fault is a 5.8-z value outlier vs healthy
  max 2.7 (drift_z=4.5 splits the gap); tire blowout 9.2.  Features
  whose fleet MAD is ~0 (control-unit firmware: categorical, a
  minority config is not a failure) are masked.  Both heads'
  statistics are CROSS-SECTIONAL and recomputed every update, so model
  hot-swaps — which shift every car together — cancel instead of
  page-storming (the drift head, having no model, is immune outright).
- TAIL GUARD (live-measured): under continuous 1-epoch/round training
  the error head's MAD scale under-covers structurally heavy-tailed
  features — battery % reconstructs persistently worse for cars at the
  charge-distribution edges (healthy error-z up to 235; 55 false
  alerts in a 200-car live session, every one on BATTERY_PERCENTAGE).
  Each head's alert bar therefore also clears tail_k× the fleet's own
  p90 excess per feature; with that guard the same live session
  detects 8/8 injected failing cars at 0 false alerts across the whole
  sweep of tested thresholds (feature_z 20–30, tail_k 3–6, measured on
  recorded head-state snapshots).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np


class CarHealthDetector:
    """EMA-per-key anomaly detector with hysteresis and alert records.

    Args:
      threshold: EMA level that raises an alert — default 0.38 sits just
        above the measured healthy-fleet EMA band (module docstring).
        "auto" calibrates from the fleet itself (median + k·(p75−median)
        over warmed-up cars, recomputed as the stream flows); it needs a
        STABLE model — under continuous hot-swapping the per-car EMA
        spread collapses to the swap cadence and the quantile margin
        under-estimates, so live deployments with fast retrain loops
        should pin the threshold to their measured healthy band instead.
      alpha: EMA weight per record (effective window ≈ 1/alpha records).
      min_records: evidence required before a car may alert (a single
        outlier row must not page an operator).
      clear_ratio: hysteresis — an alerted car clears below
        threshold×clear_ratio (flapping at the boundary is operator spam).
      auto_k / auto_floor: the auto calibration's margin multiplier and
        minimum threshold.
    """

    #: recompute the auto threshold every this many update() calls
    AUTO_EVERY = 50
    #: steady-state cadence for the feature-head fleet calibration: with
    #: alpha 0.05 the EMAs move ≤ ~18% of any shift within 4 updates and
    #: the excess floors absorb that; a model swap (the one event that
    #: shifts the whole fleet at once) triggers a hot window of
    #: per-update recalibration via notify_model_swap()
    RECAL_EVERY = 4

    def __init__(self, threshold=0.38, alpha: float = 0.05,
                 min_records: int = 20, clear_ratio: float = 0.7,
                 auto_k: float = 4.5, auto_floor: float = 0.3,
                 feature_heads: bool = False, feature_z: float = 30.0,
                 feature_floor: float = 0.1, feature_tail_k: float = 4.0,
                 drift_z: float = 4.5, drift_floor: float = 0.1,
                 drift_tail_k: float = 2.5,
                 feature_names: Optional[list] = None):
        self.auto = threshold == "auto"
        self.threshold = auto_floor if self.auto else float(threshold)
        self.auto_k = auto_k
        self.auto_floor = auto_floor
        #: auto mode must not alert before the first successful fleet
        #: calibration — the floor is a lower BOUND, not a threshold
        self._calibrated = not self.auto
        self._updates = 0
        self.alpha = alpha
        self.min_records = min_records
        self.clear_ratio = clear_ratio
        self.ema: Dict[bytes, float] = {}
        self.count: Dict[bytes, int] = {}
        self.alerted: Dict[bytes, float] = {}  # key → alert wall time
        self.alert_source: Dict[bytes, str] = {}  # key → what fired
        self.transitions: list = []  # (t, key, "ALERT"|"CLEAR", ema, src)
        #: per-FEATURE error heads (round 5): a low-magnitude fault that
        #: barely moves the 18-feature MEAN error (battery sag ≈ +2% MSE
        #: under parity normalization) is a huge outlier on ITS feature's
        #: error — per-car per-feature EMAs are scored as robust
        #: cross-sectional z against the fleet (median/MAD per feature).
        #: Cross-sectional is the property the round-4 per-feature
        #: variants lacked: a model hot-swap shifts every car's error
        #: together, so the fleet median/MAD track it and the z of a
        #: healthy car stays put, where absolute per-feature thresholds
        #: collapsed (measured and rejected, round 4).  Feeds on the
        #: per-row per-feature squared errors the scorer already computes.
        self.feature_heads = bool(feature_heads)
        self.feature_z = float(feature_z)
        #: absolute excess floor (normalized-units²): a feature whose MAD
        #: is tiny (well-reconstructed) would otherwise turn numerical
        #: dust into huge z scores
        self.feature_floor = float(feature_floor)
        #: TAIL GUARD (the live-measured failure mode of pure MAD-z): a
        #: feature can be heavy-tailed across healthy cars for structural
        #: reasons — live continuous models reconstruct battery %
        #: persistently worse for cars at the charge-distribution edges
        #: (z 30–235 on a MAD scale, 55 false alerts in a 200-car live
        #: session).  The alert bar therefore also clears tail_k× the
        #: fleet's own p90 excess per feature: where the healthy tail is
        #: wide the bar widens with it, where it is tight (voltage given
        #: battery: the fault signature) the MAD term still rules.  p90
        #: tolerates un-alerted failing cars in the calibration set
        #: (≤5% contamination cannot reach the 90th percentile).
        self.feature_tail_k = float(feature_tail_k)
        self.drift_tail_k = float(drift_tail_k)
        self.feature_names = feature_names
        #: value-DRIFT head: per-car EMAs of the normalized feature
        #: values themselves, scored two-sided against fleet median/MAD.
        #: Model-free — catches faults on features the model cannot
        #: predict (engine vibration), immune to hot-swaps by
        #: construction.  Fleet-constant/categorical features (MAD ≈ 0:
        #: firmware) are masked — a minority config is not a failure.
        self.drift_z = float(drift_z)
        self.drift_floor = float(drift_floor)
        self._recal_hot = 0
        self.fema: Dict[bytes, np.ndarray] = {}   # key → [F] error EMAs
        self.vema: Dict[bytes, np.ndarray] = {}   # key → [F] value EMAs
        self._fmed: Optional[np.ndarray] = None   # fleet median per feat
        self._fsig: Optional[np.ndarray] = None   # 1.4826·MAD + eps
        self._ftail: Optional[np.ndarray] = None  # p90 healthy excess
        self._vmed: Optional[np.ndarray] = None
        self._vsig: Optional[np.ndarray] = None
        self._vtail: Optional[np.ndarray] = None  # p90 |deviation|
        self._vlive: Optional[np.ndarray] = None  # non-categorical mask

    # ------------------------------------------------------------ update
    def update(self, keys: np.ndarray, errs: np.ndarray,
               ferrs: Optional[np.ndarray] = None,
               fvals: Optional[np.ndarray] = None) -> list:
        """Fold one scored batch's (keys [n] bytes, per-row errors [n],
        optional per-feature errors [n, F] and normalized feature values
        [n, F]) into the per-car state; returns this call's alert
        transitions as [(t, key, state, ema, source)] — the same 5-tuples
        recorded in self.transitions, so publishing them downstream
        carries the transition's own timestamp and which signal fired.
        Vectorized per distinct car: a batch holds many rows of few cars,
        so the group-by does the heavy lifting in numpy and the Python
        loop runs per CAR, not per row."""
        if len(keys) == 0:
            return []
        self._updates += 1
        if self.auto and (not self._calibrated
                          or self._updates % self.AUTO_EVERY == 0):
            self._recalibrate_mse()
        if self.feature_heads and (
                self._fmed is None or self._recal_hot > 0
                or self._updates % self.RECAL_EVERY == 0):
            # the z scores are only cross-sectional if the fleet
            # median/scale are contemporaneous with the EMAs they
            # normalize — at the AUTO_EVERY cadence a model hot-swap
            # mid-window raised every car's error against a stale median
            # and page-stormed (pinned by
            # test_feature_heads_survive_fleetwide_error_shift).
            # Steady-state: every RECAL_EVERY updates (the floors absorb
            # the ≤4-update fold drift); post-swap: per-update for the
            # fold transient (notify_model_swap)
            self._recal_hot = max(0, self._recal_hot - 1)
            self._recalibrate_features()
        order = np.argsort(keys, kind="stable")
        sk, se = keys[order], errs[order]
        sf = ferrs[order] if ferrs is not None else None
        sv = fvals[order] if fvals is not None else None
        # keyless records carry no car identity: drop them before
        # grouping so they can't pollute the per-car state either
        nonempty = sk != b""
        if not nonempty.all():
            sk, se = sk[nonempty], se[nonempty]
            sf = sf[nonempty] if sf is not None else None
            sv = sv[nonempty] if sv is not None else None
            if len(sk) == 0:
                return []
        uniq, starts = np.unique(sk, return_index=True)
        counts = np.append(starts[1:], len(sk)) - starts
        bounds = np.append(starts, len(sk))
        ckeys = [bytes(u) for u in uniq]
        # segmented closed-form EMA folds + whole-batch head evaluation
        # (the per-car python loop was the detector's hot spot: ~8 numpy
        # calls per car per batch cost ~1/3 of the scorer's throughput)
        fe_mat = (self._fold_all(self.fema, ckeys, sf, starts, counts)
                  if self.feature_heads and sf is not None else None)
        ve_mat = (self._fold_all(self.vema, ckeys, sv, starts, counts)
                  if self.feature_heads and sv is not None else None)
        # head evidence is unusable through the post-swap fold transient
        # (suppressed below): skip computing it at all
        fire_src = ([None] * len(ckeys) if self._recal_hot > 0 else
                    self._head_sources_batch(fe_mat, ve_mat, len(ckeys)))
        out = []
        now = time.time()
        for ci, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
            k = ckeys[ci]
            e = self.ema.get(k)
            # fold the car's rows in arrival order: EMA of the sequence
            # (a closed form exists but per-row exactness matters for
            # parity with a record-at-a-time consumer)
            for x in se[lo:hi]:
                e = float(x) if e is None else \
                    e + self.alpha * (float(x) - e)
            self.ema[k] = e
            self.count[k] = self.count.get(k, 0) + int(hi - lo)
            # head evidence is SUPPRESSED through the post-swap fold
            # transient (_recal_hot > 0): within one update the fleet
            # calibration is computed before the folds while the z is
            # evaluated after them, so a large model swap makes every
            # freshly-folded car an apparent outlier against the
            # pre-fold median — evidence that straddles a model
            # boundary must neither PAGE (new alerts, pinned by
            # test_swap_notification_recalibrates_through_the_fold_
            # transient) nor HOLD (clears — a transient fire must not
            # starve an alerted car's recovery through every hot
            # window).  The mse path keeps its own-car threshold either
            # way.
            hot = self._recal_hot > 0
            src_fire = fire_src[ci]
            if k not in self.alerted:
                src = None
                if self._calibrated and \
                        self.count[k] >= self.min_records and \
                        e > self.threshold:
                    src = "mse"
                elif src_fire is not None and \
                        self.count[k] >= self.min_records:
                    src = src_fire
                if src is not None:
                    self.alerted[k] = now
                    self.alert_source[k] = src
                    self.transitions.append((now, k, "ALERT", e, src))
                    out.append((now, k, "ALERT", e, src))
            else:
                # hysteresis applies to the path that FIRED; a head-alerted
                # car whose healthy mean EMA happens to sit above
                # threshold×clear_ratio must still clear once the heads go
                # quiet (requiring the mse hysteresis bar unconditionally
                # left such cars in ALERT forever), but never while its
                # mean error is above the alert threshold itself
                src0 = self.alert_source.get(k, "")
                if hot and src0 != "mse":
                    continue  # defer: head-sourced state frozen while hot
                mse_bar = (self.threshold * self.clear_ratio
                           if src0 == "mse" else self.threshold)
                # during a hot window head evidence can neither page nor
                # hold: treat it as quiet for mse-sourced clears
                quiet_heads = hot or self._head_source(
                    k, ratio=self.clear_ratio) is None
                if e < mse_bar and quiet_heads:
                    src = self.alert_source.pop(k, "")
                    del self.alerted[k]
                    self.transitions.append((now, k, "CLEAR", e, src))
                    out.append((now, k, "CLEAR", e, src))
        return out

    def _fold_all(self, store: Dict[bytes, np.ndarray], ckeys: list,
                  rows: np.ndarray, starts: np.ndarray,
                  counts: np.ndarray) -> np.ndarray:
        """Closed-form EMA fold of EVERY car's rows in one segmented
        pass — the exact same recurrence as the scalar per-row loop,
        vectorized over cars and features (fp association differs only).
        Per-row weight: alpha·(1−alpha)^(m−1−j) within a car's segment;
        a NEW car's first row seeds the EMA, so its weight is
        (1−alpha)^(m−1).  Returns the [C, F] post-fold matrix (also
        written back to the store)."""
        rows = rows.astype(np.float64)
        n = len(rows)
        pos = np.arange(n) - np.repeat(starts, counts)
        m = np.repeat(counts, counts)
        w = self.alpha * (1.0 - self.alpha) ** (m - 1 - pos)
        old = [store.get(k) for k in ckeys]
        is_new = np.array([o is None for o in old], bool)
        if is_new.any():
            w[starts[is_new]] = (1.0 - self.alpha) ** \
                (counts[is_new] - 1)
        wsum = np.add.reduceat(w[:, None] * rows, starts, axis=0)
        decay = (1.0 - self.alpha) ** counts
        out = np.empty((len(ckeys), rows.shape[1]))
        for i, k in enumerate(ckeys):
            fe = wsum[i] if is_new[i] else old[i] * decay[i] + wsum[i]
            out[i] = fe
            store[k] = fe
        return out

    def _error_bar(self) -> np.ndarray:
        """The error head's per-feature alert bar — THE single source of
        truth shared by the batched alert path and the scalar clear path
        (diverging copies would let cars alert under one bar and clear
        under another)."""
        return np.maximum(np.maximum(
            self.feature_z * self._fsig,
            self.feature_tail_k * self._ftail), self.feature_floor)

    def _drift_bar(self) -> np.ndarray:
        return np.maximum(np.maximum(
            self.drift_z * self._vsig,
            self.drift_tail_k * self._vtail), self.drift_floor)

    def _head_sources_batch(self, fe_mat, ve_mat, n_cars: int) -> list:
        """Whole-batch head evaluation: [C] list of firing-source strings
        (None = no head fires).  Same rule as _head_source at ratio 1,
        computed as two matrix comparisons instead of per-car calls."""
        src = [None] * n_cars
        if fe_mat is not None and self._fmed is not None:
            excess = fe_mat - self._fmed
            fire = excess > self._error_bar()
            for i in np.nonzero(fire.any(axis=1))[0]:
                z = np.where(fire[i], excess[i] / self._fsig, 0.0)
                j = int(np.argmax(z))
                src[i] = f"feature:{self._name_of(j)} z={z[j]:.1f}"
        if ve_mat is not None and self._vmed is not None:
            dev = np.abs(ve_mat - self._vmed)
            fire = (dev > self._drift_bar()) & self._vlive
            for i in np.nonzero(fire.any(axis=1))[0]:
                if src[i] is None:
                    z = np.where(fire[i], dev[i] / self._vsig, 0.0)
                    j = int(np.argmax(z))
                    src[i] = f"drift:{self._name_of(j)} z={z[j]:.1f}"
        return src

    def notify_model_swap(self) -> None:
        """Hot-swap notification (StreamScorer.set_params calls this):
        the swap shifts every car's reconstruction error together, so
        the fleet calibration recomputes EVERY update through the EMA
        fold transient (~2/alpha records per car) instead of at the
        steady-state cadence."""
        self._recal_hot = int(2.0 / max(self.alpha, 1e-3))

    def _name_of(self, j: int) -> str:
        return (self.feature_names[j] if self.feature_names is not None
                and j < len(self.feature_names) else str(j))

    def _head_source(self, k: bytes, ratio: float = 1.0):
        """The firing head's source string for car k, or None if no head
        fires at `ratio`× its threshold (ratio<1 = the hysteresis check).

        Error head: one-sided excess of the per-feature reconstruction
        error EMA over an alert bar of max(feature_z·MADsig,
        tail_k·p90-excess, floor).  Drift head: the two-sided analogue
        on the value EMAs, categorical features masked.  The tail term
        is the live robustness guard — see its constructor comment."""
        if not self.feature_heads:
            return None
        if self._fmed is not None:
            fe = self.fema.get(k)
            if fe is not None:
                excess = fe - self._fmed
                fire = excess > self._error_bar() * ratio
                if fire.any():
                    z = np.where(fire, excess / self._fsig, 0.0)
                    j = int(np.argmax(z))
                    return f"feature:{self._name_of(j)} z={z[j]:.1f}"
        if self._vmed is not None:
            ve = self.vema.get(k)
            if ve is not None:
                dev = np.abs(ve - self._vmed)
                fire = (dev > self._drift_bar() * ratio) & self._vlive
                if fire.any():
                    z = np.where(fire, dev / self._vsig, 0.0)
                    j = int(np.argmax(z))
                    return f"drift:{self._name_of(j)} z={z[j]:.1f}"
        return None

    def _recalibrate_mse(self) -> None:
        """Auto MSE threshold: robust fleet quantiles over warmed-up,
        un-alerted cars.  median + k·(p75−median) is
        contamination-tolerant (a few percent of failing cars sit in the
        upper tail and barely move either statistic) and tracks the
        model's error scale; alerted cars are excluded so a detected
        failure cannot inflate the bar for the next one."""
        emas = [e for k, e in self.ema.items()
                if self.count.get(k, 0) >= self.min_records
                and k not in self.alerted]
        if len(emas) >= 20:
            med = float(np.median(emas))
            p75 = float(np.percentile(emas, 75))
            self.threshold = max(self.auto_floor,
                                 med + self.auto_k * (p75 - med))
            self._calibrated = True

    def _recalibrate_features(self) -> None:
        """Per-feature fleet median and MAD over warmed-up, un-alerted
        cars — recomputed every update so the z scores stay
        CROSS-SECTIONAL: a model hot-swap moves every car's error
        together and contemporaneous median/MAD absorb it.  (The flip
        side, inherent to cross-sectional detection: a fault affecting
        the ENTIRE fleet at once shifts the median with it and no single
        car alerts — fleet-level drift belongs to the record-level AUC
        and the obs dashboards, not the per-car pager.)"""
        # ONE quantile call per head (it runs every update): med from
        # p50, robust sigma from the IQR (IQR/1.349 estimates the same
        # sigma as 1.4826·MAD for the distribution core and is
        # computable in the same partition pass), tail from p90 — the
        # one-sided error tail is p90−med exactly (clipping at 0
        # commutes with the quantile above the median).
        fes = [fe for k, fe in self.fema.items()
               if self.count.get(k, 0) >= self.min_records
               and k not in self.alerted]
        if len(fes) >= 20:
            q25, med, q75, q90 = np.percentile(
                np.stack(fes), [25, 50, 75, 90], axis=0)
            self._fmed = med
            self._fsig = (q75 - q25) / 1.349 + 1e-9
            self._ftail = np.maximum(q90 - med, 0.0)
        ves = [ve for k, ve in self.vema.items()
               if self.count.get(k, 0) >= self.min_records
               and k not in self.alerted]
        if len(ves) >= 20:
            stack = np.stack(ves)
            q25, med, q75 = np.percentile(stack, [25, 50, 75], axis=0)
            iqr = q75 - q25
            self._vmed = med
            self._vsig = iqr / 1.349 + 1e-9
            # two-sided tail needs the |deviation| quantile (one extra
            # partition pass)
            self._vtail = np.percentile(np.abs(stack - med), 90, axis=0)
            # fleet-constant features (firmware: categorical) are not
            # drift candidates — a minority config is not a failure
            self._vlive = iqr > 1e-6

    # ------------------------------------------------------------- sinks
    def publish_transitions(self, broker, topic: str,
                            transitions: Optional[list] = None) -> int:
        """Emit alert transitions as keyed JSON records (the digital-twin
        feed: key = car key, value = {car, state, ema, t}).  Pass the
        return value of update() to publish just that batch's
        transitions; the published `t` is the transition's recorded
        timestamp (identical to self.transitions), never re-stamped.
        One wire request for the whole batch (a per-transition produce
        paid a full round trip against a busy broker — 68 ms each
        measured in the scorer ceiling profile)."""
        trans = (list(transitions) if transitions is not None
                 else list(self.transitions))
        if not trans:
            return 0
        entries = [(k, json.dumps(
            {"car": k.decode(errors="replace"), "state": s,
             "ema": round(e, 6), "t": t, "source": src}).encode(), 0)
            for t, k, s, e, src in trans]
        pm = getattr(broker, "produce_many", None)
        if pm is not None:
            pm(topic, entries)
        else:
            for k, v, _ in entries:
                broker.produce(topic, v, key=k)
        return len(entries)

    def summary(self) -> dict:
        out = {
            "cars_seen": len(self.ema),
            "cars_alerted": sorted(k.decode(errors="replace")
                                   for k in self.alerted),
            "n_transitions": len(self.transitions),
            "threshold": round(self.threshold, 4),
        }
        if self.feature_heads:
            out["feature_heads"] = True
            out["feature_calibrated"] = self._fmed is not None
            out["alert_sources"] = {
                k.decode(errors="replace"): s
                for k, s in sorted(self.alert_source.items())}
        return out
