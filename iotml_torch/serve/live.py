"""Long-lived scorer with live model hot-swap off the artifact store or
the model registry (``iotml.serve.live``'s twin).

The reference's predict Deployment downloads a fixed model at pod start
and scores until it is restarted.  ``LiveScorer`` is that loop without
the restart: it polls the ``{model_name}.latest`` pointer that a
``train.live.ContinuousTrainer`` flips after every round, downloads the
new immutable blob (Keras h5 for an ``.h5`` name, else the port's
checkpoint) and swaps the weights between super-batches; predictions
keep flowing, in order, across the swap (``StreamScorer.set_params``).
With a ``registry`` it follows the registry's ``serving`` channel
instead, through a ``mlops.RegistryWatcher`` polled inline from this
loop (at most every ``watch_poll_s``), so promote and rollback flips
land between super-batches.

Detection quality rides along: batches keep the stream's
``failure_occurred`` labels, so the threshold verdicts are counted live
into a confusion matrix (``StreamScorer.quality``); with a
``carhealth_topic`` batches keep their keys too, a per-car
``CarHealthDetector`` folds each batch's errors, and its alert
transitions go to that topic.  Under a normalizer other than the
reference's, the verdicts average the reference's features only
(``CAR_NORMALIZER.mask``), the set the threshold was calibrated on.

Each swap counts into ``live_model_updates_total``; ``stats()`` sets the
``live_detection_precision`` / ``_recall`` gauges from the cumulative
confusion counts, as the JAX scorer's does.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import Callable, Optional

from ..core.normalize import CAR_NORMALIZER
from ..core.schema import KSQL_CAR_SCHEMA
from ..data.dataset import SensorBatches
from ..mlops.rollout import RegistryWatcher
from ..obs import metrics as obs_metrics
from ..models.autoencoder import CAR_AUTOENCODER
from ..models.h5_import import autoencoder_params_from_h5
from ..stream.consumer import StreamConsumer
from ..stream.producer import OutputSequence
from ..train.artifacts import ArtifactStore
from ..train.checkpoint import CheckpointManager
from ..utils.device import DeviceLike
from .carhealth import CarHealthDetector
from .scorer import StreamScorer


class LiveScorer:
    """Continuous scoring with pointer- or registry-driven weight
    hot-swap.

    ``registry`` (a ``ModelRegistry``) follows its serving channel,
    polled at most every ``watch_poll_s``; ``device`` is where the
    forward runs (``cuda`` unless given)."""

    def __init__(self, broker, topic: str, result_topic: str,
                 store: Optional[ArtifactStore],
                 model_name: str = "cardata-live.h5",
                 threshold: Optional[float] = 5.0,
                 group: str = "cardata-live-score", batch_size: int = 100,
                 carhealth_topic: Optional[str] = "car-health",
                 car_threshold=0.38, car_feature_heads: bool = False,
                 normalizer=None, registry=None, watch_poll_s: float = 0.0,
                 device: DeviceLike = None):
        if store is None and registry is None:
            raise ValueError("need an ArtifactStore pointer or a "
                             "ModelRegistry to follow")
        self.broker = broker
        self.store = store
        self.registry = registry
        self.watch_poll_s = watch_poll_s
        self._watcher = None if registry is None else \
            RegistryWatcher(registry)
        self._last_watch = float("-inf")
        self.model_name = model_name
        parts = range(broker.topic(topic).partitions)
        consumer = StreamConsumer.from_committed(broker, topic, parts,
                                                 group=group, eof=False)
        carhealth = None
        if carhealth_topic is not None:
            carhealth = CarHealthDetector(
                threshold=car_threshold, feature_heads=car_feature_heads,
                feature_names=[f.name
                               for f in KSQL_CAR_SCHEMA.sensor_fields])
            broker.create_topic(carhealth_topic)
        batch_kw = {} if normalizer is None else dict(normalizer=normalizer)
        batches = SensorBatches(consumer, batch_size=batch_size,
                                keep_labels=True,
                                keep_keys=carhealth is not None, **batch_kw)
        out = OutputSequence(broker, result_topic, partition=0)
        verdict_mask = None
        if normalizer is not None and normalizer is not CAR_NORMALIZER:
            verdict_mask = CAR_NORMALIZER.mask.astype(bool)
        # the weights come from wait_for_model(): scoring before that
        # would write predictions of random weights
        self.scorer = StreamScorer(CAR_AUTOENCODER, None, batches, out,
                                   threshold=threshold,
                                   verdict_mask=verdict_mask,
                                   carhealth=carhealth,
                                   carhealth_topic=carhealth_topic,
                                   device=device)
        if self._watcher is not None:
            self._watcher.attach(self.scorer)
        self._current_artifact: Optional[str] = None
        self.model_updates = 0

    # ----------------------------------------------------------- weights
    def _load(self, artifact: str) -> None:
        restore_dir = tempfile.mkdtemp(prefix="iotml_torch_swap_")
        try:
            local = os.path.join(restore_dir, "ckpt")
            if self.model_name.endswith(".h5"):
                params = autoencoder_params_from_h5(
                    self.store.download(artifact, local))
            else:
                params = CheckpointManager.load_dir(
                    self.store.download_tree(artifact, local))["params"]
        finally:
            shutil.rmtree(restore_dir, ignore_errors=True)
        # lint-ok: R13 legacy artifact-store pointer flow (pre-registry
        # deployments); registry-backed LiveScorers swap via _watcher
        self.scorer.set_params(params)
        self._current_artifact = artifact
        self.model_updates += 1
        obs_metrics.live_model_updates.inc()

    def maybe_swap(self) -> bool:
        """Poll the pointer (or the registry's serving channel); load and
        swap when it names a new model."""
        if self._watcher is not None:
            now = time.monotonic()
            if now - self._last_watch < self.watch_poll_s:
                return False
            self._last_watch = now
            if not self._watcher.poll_once():
                return False
            self._current_artifact = \
                f"registry:v{self._watcher.current_version}"
            self.model_updates += 1
            obs_metrics.live_model_updates.inc()
            return True
        latest = self.store.get_text(f"{self.model_name}.latest")
        if latest is None or latest == self._current_artifact:
            return False
        self._load(latest)
        return True

    def wait_for_model(self, timeout_s: float = 60.0) -> str:
        """Block until the trainer publishes the first model (the predict
        pod's download at start, made explicit)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if self.maybe_swap():
                return self._current_artifact
            time.sleep(0.05)
        where = f"{self.model_name}.latest" if self._watcher is None \
            else f"the serving channel of {self.registry.root}"
        raise TimeoutError(f"no artifact at {where} after {timeout_s}s")

    # ------------------------------------------------------------- serve
    def run(self, stop: Optional[Callable[[], bool]] = None,
            max_drains: Optional[int] = None,
            poll_interval_s: float = 0.02,
            on_drain: Optional[Callable[[dict], None]] = None) -> int:
        """Score until ``stop()`` or ``max_drains`` non-empty drains;
        returns rows scored.  Each drain is bounded at 50,000 rows, so the
        loop keeps polling the pointer and ``stop`` under overload.
        ``on_drain`` gets a stats snapshot at most every 0.1 s, and once
        more at the end."""
        if not self.scorer.params_loaded:
            self.wait_for_model()
        scored0 = self.scorer.scored
        drains = 0
        last_emit = 0.0
        try:
            while (stop is None or not stop()) and \
                    (max_drains is None or drains < max_drains):
                self.maybe_swap()
                n = self.scorer.score_available(max_rows=50_000)
                if n == 0:
                    time.sleep(poll_interval_s)
                    continue
                drains += 1
                if on_drain is not None and time.time() - last_emit >= 0.1:
                    last_emit = time.time()
                    on_drain(self.stats())
        finally:
            if on_drain is not None and drains:
                on_drain(self.stats())
        return self.scorer.scored - scored0

    def stats(self) -> dict:
        """Cumulative counters: rows scored, quality counts, error
        histograms, swaps, the current artifact, the cursors and the car
        detector's summary.  ``drain_complete`` is False while a bounded
        drain is suspended (the cursors then run ahead of the flushed
        predictions)."""
        sc = self.scorer
        q = sc.quality
        if q["tp"] + q["fp"]:
            obs_metrics.live_detection_precision.set(
                q["tp"] / (q["tp"] + q["fp"]))
        if q["tp"] + q["fn"]:
            obs_metrics.live_detection_recall.set(
                q["tp"] / (q["tp"] + q["fn"]))
        return {
            "t": time.time(),
            "drain_complete": sc._resume is None,
            "scored": sc.scored,
            "quality": dict(sc.quality),
            "err_hist": {k: v.tolist() for k, v in sc.err_hist.items()},
            "model_updates": self.model_updates,
            "artifact": self._current_artifact,
            "positions": {f"{p}": off for _, p, off
                          in sc.batches.consumer.positions()},
            "carhealth": (sc.carhealth.summary()
                          if sc.carhealth is not None else None),
        }
