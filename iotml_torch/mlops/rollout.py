"""Zero-downtime rollout: registry watchers and the A/B quality gate
(``iotml.mlops.rollout``'s twin).

The reference rolls a model out by restarting its predict pods
(`run.sh:16-91`) — every rollout is downtime, and a bad model stays
bad until a human redeploys the old blob.  Here rollout is a data-path
event:

- ``RegistryWatcher`` watches a registry channel (the in-process
  ``Topology`` cell when available, the atomic pointer file always)
  and hot-swaps every attached scorer's params **between
  super-batches** — the input cursor and the OutputSequence index
  stream are untouched, so a swap can neither drop nor double-score a
  record.
- ``ABRollout`` runs TWO versions against the same stream — each with
  its own consumer group and its own predictions topic — and scores
  both live against the stream's labels (the r04 detection-quality
  protocol: threshold confusion + histogram AUC).  ``RolloutGate``
  compares them once enough labeled records accrued and either
  **promotes** the candidate to serving or **rolls back** to the
  baseline; with ``deploy_candidate=True`` the candidate serves DURING
  evaluation (the rollback-on-regression shape).

Both sides of an ``ABRollout`` score on ``device`` (``cuda`` unless
given), as every port scorer does.  A watcher's swap counts into
``iotml_model_swaps_total`` and sets ``iotml_model_version{component}``;
a gate decision counts into ``iotml_rollouts_total{outcome}``.  Not
ported: the supervised watcher loop and the mlops drills (ROADMAP A14);
``RegistryWatcher.start()`` runs a plain daemon thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from ..data.dataset import SensorBatches
from ..models.autoencoder import CAR_AUTOENCODER
from ..obs import metrics as obs_metrics
from ..serve.scorer import StreamScorer, hist_auc
from ..stream.consumer import StreamConsumer
from ..stream.producer import OutputSequence
from ..utils.device import DeviceLike
from .checkpoint import params_from_h5_bytes
from .registry import ModelRegistry


class RegistryWatcher:
    """Poll a registry channel; hot-swap attached scorers on change."""

    def __init__(self, registry: ModelRegistry, scorers=(),
                 channel: str = "serving", component: str = "scorer",
                 poll_interval_s: float = 0.25):
        self.registry = registry
        self.channel = channel
        self.component = component
        self.poll_interval_s = poll_interval_s
        self.scorers: List = list(scorers)
        self.current_version: Optional[int] = None
        self.swaps = 0
        self.last_swap_s: Optional[float] = None
        self._params_cache = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- wiring
    def attach(self, scorer) -> None:
        """Add a scorer; it immediately receives the current model (a
        late-joining fleet member must not score on random init)."""
        with self._lock:
            self.scorers.append(scorer)
            if self._params_cache is not None:
                self._apply(scorer, self._params_cache,
                            self.current_version)

    def _apply(self, scorer, params, version) -> None:
        try:
            scorer.set_params(params, version=version)
        except TypeError:  # plain set_params(params) duck-types too
            scorer.set_params(params)

    # ---------------------------------------------------------- polling
    def poll_once(self) -> bool:
        """One channel read; swap + fan-out when the version moved.
        Cheap by design — callers run this between batches/rounds."""
        v = self.registry.channel(self.channel)
        if v is None or v == self.current_version:
            return False
        t0 = time.perf_counter()
        params = params_from_h5_bytes(
            self.registry.load_bytes(v, "model.h5"))
        with self._lock:
            self.current_version = v
            self._params_cache = params
            for s in self.scorers:
                self._apply(s, params, v)
            self.swaps += 1
        self.last_swap_s = time.perf_counter() - t0
        obs_metrics.model_swaps.inc()
        obs_metrics.model_version.set(v, component=self.component)
        return True

    def wait_for_model(self, timeout_s: float = 60.0) -> int:
        """Block until the channel names a committed version (the
        predict pod's download-at-start, registry edition)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.poll_once() or self.current_version is not None:
                return self.current_version
            time.sleep(0.05)
        raise TimeoutError(
            f"no committed version on channel {self.channel!r} of "
            f"{self.registry.root} after {timeout_s}s")

    # -------------------------------------------------------- lifecycle
    def start(self) -> "RegistryWatcher":
        """Poll on a daemon thread every ``poll_interval_s``."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.poll_once()
                except (OSError, ValueError, KeyError):
                    continue  # torn read mid-publish: next poll heals
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="iotml-registry-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None


# ------------------------------------------------------------ the gate
def scorer_quality(scorer) -> Dict[str, Optional[float]]:
    """The r04 detection-quality protocol over a live scorer: threshold
    confusion → precision/recall/F1, error histograms → AUC."""
    q = scorer.quality
    labeled = q["tp"] + q["fp"] + q["fn"] + q["tn"]
    precision = q["tp"] / (q["tp"] + q["fp"]) if q["tp"] + q["fp"] else None
    recall = q["tp"] / (q["tp"] + q["fn"]) if q["tp"] + q["fn"] else None
    f1 = (2 * precision * recall / (precision + recall)
          if precision and recall and precision + recall else
          (0.0 if precision is not None or recall is not None else None))
    auc = hist_auc(scorer.err_hist["true"], scorer.err_hist["false"])
    return {"labeled": labeled, "precision": precision, "recall": recall,
            "f1": f1, "auc": auc}


class RolloutGate:
    """Promote/rollback policy over two live quality snapshots.

    The candidate must not regress either F1 or AUC by more than
    ``epsilon`` (absolute).  ``min_records`` labeled rows (per side)
    and at least one positive label are required before a verdict —
    deciding on nothing is how a gate lies."""

    def __init__(self, min_records: int = 300, epsilon: float = 0.02):
        self.min_records = min_records
        self.epsilon = epsilon

    def decide(self, baseline: Dict, candidate: Dict) -> Optional[str]:
        """'promote' | 'rollback' | None (not enough evidence yet)."""
        for side in (baseline, candidate):
            if side["labeled"] < self.min_records:
                return None
        # comparable evidence: a side that saw no positives has an
        # undefined recall/AUC — wait for the stream to show failures
        if baseline["auc"] is None or candidate["auc"] is None:
            return None
        b_f1 = baseline["f1"] if baseline["f1"] is not None else 0.0
        c_f1 = candidate["f1"] if candidate["f1"] is not None else 0.0
        if c_f1 < b_f1 - self.epsilon or \
                candidate["auc"] < baseline["auc"] - self.epsilon:
            return "rollback"
        return "promote"


class ABRollout:
    """Drive baseline + candidate scorers over one stream; gate them.

    Both sides consume the SAME topic with their own groups and write
    to their own predictions topic (``<result_topic>.v<version>``), so
    the comparison artifact — two aligned prediction streams — is
    itself on the log, replayable like everything else.

    Args:
      broker/topic: the labeled input stream.
      registry: source of both versions' weights.
      baseline/candidate: committed version ids.
      deploy_candidate: point ``serving`` at the candidate for the
        duration (watchers swap the production fleet); a rollback
        verdict then re-points serving at the baseline — the
        rollback-on-regression drill shape.  Off, the candidate runs
        shadow-only and promotion is the only serving change.
      from_start: score the retained history (drills/bench); default
        starts both sides at the live log end.
      device: where both sides score (``cuda`` unless given).
    """

    def __init__(self, broker, topic: str, registry: ModelRegistry,
                 baseline: int, candidate: int, model=None,
                 result_topic: str = "model-predictions",
                 threshold: float = 0.5, gate: Optional[RolloutGate] = None,
                 batch_size: int = 100, normalizer=None,
                 deploy_candidate: bool = False, from_start: bool = False,
                 group_prefix: str = "ab-rollout",
                 device: DeviceLike = None):
        if model is None:
            model = CAR_AUTOENCODER
        self.registry = registry
        self.baseline = baseline
        self.candidate = candidate
        self.gate = gate or RolloutGate()
        self.deploy_candidate = deploy_candidate
        self.decision: Optional[str] = None
        self.decided_at_s: Optional[float] = None
        self.sides: Dict[str, StreamScorer] = {}
        self.consumers = {}
        parts = range(broker.topic(topic).partitions)
        batch_kw = {} if normalizer is None else dict(normalizer=normalizer)
        for name, version in (("baseline", baseline),
                              ("candidate", candidate)):
            params = params_from_h5_bytes(
                registry.load_bytes(version, "model.h5"))
            group = f"{group_prefix}-{name}"
            consumer = StreamConsumer.from_committed(
                broker, topic, parts, group=group, eof=False)
            if not from_start:
                for p in parts:
                    consumer.seek(topic, p, broker.end_offset(topic, p))
            out_topic = f"{result_topic}.v{version}"
            broker.create_topic(out_topic)
            out = OutputSequence(broker, out_topic, partition=0)
            batches = SensorBatches(consumer, batch_size=batch_size,
                                    keep_labels=True, **batch_kw)
            scorer = StreamScorer(model, params, batches, out,
                                  threshold=threshold, device=device)
            self.sides[name] = scorer
            self.consumers[name] = consumer
        if deploy_candidate:
            registry.promote(candidate)
        self._t0 = time.monotonic()

    # ---------------------------------------------------------- driving
    def step(self, max_rows: Optional[int] = 20_000) -> int:
        """Drain both sides once; apply the gate when evidence
        suffices.  Returns rows scored this step."""
        n = 0
        for scorer in self.sides.values():
            n += scorer.score_available(max_rows=max_rows)
        if self.decision is None:
            verdict = self.gate.decide(self.quality("baseline"),
                                       self.quality("candidate"))
            if verdict is not None:
                self._settle(verdict)
        return n

    def quality(self, side: str) -> Dict:
        return scorer_quality(self.sides[side])

    def _settle(self, verdict: str) -> None:
        self.decision = verdict
        self.decided_at_s = time.monotonic() - self._t0
        if verdict == "promote":
            self.registry.promote(self.candidate)
            obs_metrics.rollouts.inc(outcome="promoted")
        else:
            # rollback: serving returns to (or stays at) the baseline.
            # Recorded even when the candidate never served — the
            # history line is the audit trail either way.
            self.registry.rollback(self.baseline)
            obs_metrics.rollouts.inc(outcome="rolled_back")

    def run(self, stop: Optional[Callable[[], bool]] = None,
            timeout_s: float = 60.0,
            poll_interval_s: float = 0.02) -> Optional[str]:
        """Drive until a verdict (or timeout/stop); returns it."""
        deadline = time.monotonic() + timeout_s
        while self.decision is None and time.monotonic() < deadline \
                and (stop is None or not stop()):
            if self.step() == 0:
                time.sleep(poll_interval_s)
        return self.decision
