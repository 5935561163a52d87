"""The drift-adapt-swap drill (``iotml.online.drill``'s twin): online
learning proven live, end to end.

One seeded run drives the whole story against real components (broker,
registry, watcher, scorer) in a deterministic interleave:

1. a model is pre-trained on the pre-drift fleet and published (v1 —
   "the deployed micro-batch model"; on the card one launch of the fused
   fit kernel);
2. the ``OnlineLearner`` warm-starts from v1 and consumes the live
   stream (per-window incremental updates, baseline established);
3. the regional-cohort drift arrives; the learner must DETECT it
   within an SLO record budget, ADAPT (lr boost / window reset /
   refit), CONVERGE, and publish the adapted model through the
   registry;
4. the scorer fleet must hot-swap to the adapted version via the
   ``RegistryWatcher`` with zero lost / double-scored records, and live
   detection AUC (histogram AUC over the scorer's own error histograms)
   must recover toward its pre-drift level;
5. finally a deliberately WRECKED "adaptation" is published as a
   candidate and deployed — the A/B gate must roll it back.

The seed walk, phases, invariants and SLOs are the JAX package's, so
both packages reach the same verdicts from the same initial weights
(at seed 7 both fail ``adaptation_converged``: the episode is still
adapting when the stream ends).  ``device`` is where every model trains
and scores (``cuda`` unless given).

Run via ``python -m iotml_torch.online drill`` (exit status = verdict).
"""

from __future__ import annotations

import shutil
import tempfile
from typing import List

import numpy as np
import torch

from ..chaos.runner import (Invariant, _check_commits_monotonic,
                            _record_commits)
from ..data.dataset import SensorBatches
from ..gen.scenarios import AdversarialFleet, condition
from ..gen.simulator import FleetScenario
from ..mlops import ABRollout, ModelRegistry, RegistryWatcher, RolloutGate
from ..mlops.checkpoint import params_from_h5_bytes, params_to_h5_bytes
from ..models.autoencoder import CAR_AUTOENCODER
from ..serve.scorer import StreamScorer, hist_auc
from ..stream.broker import Broker
from ..stream.consumer import StreamConsumer
from ..stream.producer import OutputSequence
from ..supervise.drill import DrillReport
from ..train.loop import Trainer
from ..utils.device import DeviceLike, resolve_device
from .learner import OnlineLearner

IN_TOPIC = "SENSOR_DATA_S_AVRO"
PRED_TOPIC = "model-predictions"
GROUP = "online-drill"
CARS = 50


def _phase_auc(scorer, before: dict):
    """r04 histogram AUC of the rows scored since ``before`` (the
    err_hist snapshot protocol: cumulative hists diff into a window)."""
    return hist_auc(scorer.err_hist["true"] - before["true"],
                    scorer.err_hist["false"] - before["false"])


def _snap(scorer) -> dict:
    return {k: v.copy() for k, v in scorer.err_hist.items()}


def _noised(params, rng) -> dict:
    """``params`` + N(0, 1) noise drawn in the JAX package's leaf order
    (flax's sorted layers, bias before kernel), each kernel's draw in
    its [in, out] layout."""
    out = dict(params)
    for layer in sorted({k.split(".")[0] for k in params}):
        bias, weight = params[f"{layer}.bias"], params[f"{layer}.weight"]
        out[f"{layer}.bias"] = bias + torch.from_numpy(
            rng.normal(0, 1.0, tuple(bias.shape)).astype(np.float32))
        kernel = rng.normal(0, 1.0, tuple(weight.shape)[::-1])
        out[f"{layer}.weight"] = weight + torch.from_numpy(
            np.ascontiguousarray(kernel.astype(np.float32).T))
    return out


def drill_drift_adapt_swap(seed: int = 7, records: int = 12_000,
                           slo_detect_records: int = 1500,
                           auc_margin: float = 0.08,
                           device: DeviceLike = None) -> DrillReport:
    """Detect a seeded regional drift, adapt, publish, hot-swap the
    fleet, recover detection quality — then prove the rollback gate
    rejects a wrecked adaptation.  Deterministic single-thread drive;
    record-based SLOs."""
    device = resolve_device(device)

    ticks = max(40, records // CARS)
    t_pretrain = (3 * ticks) // 10
    t_live = (3 * ticks) // 10
    t_post = ticks - t_pretrain - t_live
    window = 50

    broker = Broker()
    commit_log: List[tuple] = []
    _record_commits(broker, commit_log, "stream")
    # The AUC legs need anomaly mass the PARITY feature set can see:
    # failure mode 2 (battery fault) lives in voltage/current, both
    # zeroed by the reference's own normalize_fn TODOs — a fleet whose
    # failing cars all drew mode 2 has label noise, not signal.
    # Deterministically walk seeds from the requested one until the
    # drawn fleet has enough VISIBLE (vibration/tire) failure cars;
    # same seed -> same walk -> same fleet.
    cond = condition("regional-drift", drift_tick=t_pretrain + t_live)
    fleet = None
    for s in range(seed, seed + 32):
        cand_fleet = AdversarialFleet(
            FleetScenario(num_cars=CARS, failure_rate=0.12, seed=s),
            cond)
        failing = cand_fleet.gen.failing
        if int(((failing == 0) | (failing == 1)).sum()) >= 4:
            fleet = cand_fleet
            break
    fleet = fleet or cand_fleet
    root = tempfile.mkdtemp(prefix="iotml_online_drill_")
    reg = ModelRegistry(root)

    # ---- phase A: pre-train "the deployed model", publish v1
    fleet.publish_stream(broker, IN_TOPIC, n_ticks=t_pretrain)
    pre = Trainer(CAR_AUTOENCODER, device=device)
    pre_batches = SensorBatches(
        StreamConsumer(broker, [f"{IN_TOPIC}:0:0"], group="pretrain"),
        batch_size=100, only_normal=True, cache=True)
    pre.fit_compiled(pre_batches, epochs=10)
    mark = broker.end_offset(IN_TOPIC, 0)
    v1 = reg.publish(
        {"model.h5": params_to_h5_bytes(pre.state.params)},
        offsets=[(IN_TOPIC, 0, mark)]).version
    reg.promote(v1)

    # ---- the online learner (warm start from v1) + the scorer fleet
    learner = OnlineLearner(broker, IN_TOPIC, registry=reg,
                            group=GROUP, window=window, publish_every=20,
                            device=device)
    scons = StreamConsumer.from_committed(
        broker, IN_TOPIC, [0], group=f"{GROUP}-scorer", eof=True)
    scons.seek(IN_TOPIC, 0, mark)  # score the LIVE phases only
    scorer = StreamScorer(
        CAR_AUTOENCODER, None,
        SensorBatches(scons, batch_size=100, keep_labels=True),
        OutputSequence(broker, PRED_TOPIC, partition=0), threshold=5.0,
        device=device)
    watcher = RegistryWatcher(reg, scorers=[scorer])
    watcher.poll_once()
    swap_log: List[int] = []
    _orig = scorer.set_params

    def _recording(params, version=None):
        _orig(params, version=version)
        swap_log.append(version)

    scorer.set_params = _recording

    def drive():
        while learner.process_available(max_updates=5):
            learner.write_published()
            watcher.poll_once()
            scorer.score_available(max_rows=2000)
        scorer.score_available()

    # ---- phase B: live pre-drift — baseline + pre AUC.  The online
    # model improves through the first half of the phase (warm start
    # is not convergence), so the pre-drift quality reference is the
    # SECOND half only — the steady state the drift then breaks.
    fleet.publish_stream(broker, IN_TOPIC, n_ticks=t_live // 2)
    drive()
    h0 = _snap(scorer)
    fleet.publish_stream(broker, IN_TOPIC,
                         n_ticks=t_live - t_live // 2)
    drive()
    h_pre = _snap(scorer)
    auc_pre = _phase_auc(scorer, h0)
    updates_at_drift = learner.updates
    fp_adaptations = list(learner.adaptations)

    # ---- phase C: drift + detection + adaptation.  Three windows:
    # the drift front (the "during" dip), the adaptation transient
    # (deliberately unmeasured — rows scored by half-adapted models
    # belong to neither side), and the recovery window the invariant
    # judges.
    fleet.publish_stream(broker, IN_TOPIC, n_ticks=t_post // 3)
    drive()
    h_during = _snap(scorer)
    auc_during = _phase_auc(scorer, h_pre)
    fleet.publish_stream(broker, IN_TOPIC, n_ticks=t_post // 3)
    drive()
    h_transient = _snap(scorer)

    # ---- phase D: post-adaptation recovery window
    fleet.publish_stream(broker, IN_TOPIC,
                         n_ticks=t_post - 2 * (t_post // 3))
    drive()
    auc_post = _phase_auc(scorer, h_transient)
    learner.write_published()
    watcher.poll_once()
    detections = [a for a in learner.adaptations
                  if a[0] > updates_at_drift]
    detect_records = (detections[0][0] - updates_at_drift) * window \
        if detections else None
    latest = reg.latest()
    manifest = reg.manifest(latest)

    # ---- phase E: the rollback gate rejects a WRECKED adaptation
    good = latest
    params = params_from_h5_bytes(reg.load_bytes(good, "model.h5"))
    noise = np.random.RandomState(seed)
    bad = _noised(params, noise)
    cand = reg.publish({"model.h5": params_to_h5_bytes(bad)},
                       metrics={"online": 1.0, "degraded": 1.0}).version
    gate = RolloutGate(min_records=300, epsilon=0.02)
    ab = ABRollout(broker, IN_TOPIC, reg, baseline=good, candidate=cand,
                   gate=gate, threshold=5.0, deploy_candidate=True,
                   from_start=True, group_prefix="online-gate",
                   device=device)
    for _ in range(512):
        if ab.step(max_rows=5_000) == 0:
            break
    serving_final = reg.channel("serving")

    published = broker.end_offset(IN_TOPIC, 0)
    live_records = published - mark
    committed = {p: broker.committed(GROUP, IN_TOPIC, p) for p in [0]}
    manifest_offsets = {p: off for _t, p, off in manifest.offsets}
    invariants = [
        Invariant(
            "no_false_positive_drift",
            not fp_adaptations,
            "no drift fired on the stationary pre-drift stream"
            if not fp_adaptations else
            f"detector fired BEFORE the drift: {fp_adaptations}"),
        Invariant(
            "drift_detected_within_slo",
            detect_records is not None
            and detect_records <= slo_detect_records,
            f"drift detected {detect_records} records after onset "
            f"(slo {slo_detect_records})" if detect_records is not None
            else "the drift was never detected"),
        Invariant(
            "adaptation_converged",
            learner.monitor.converged >= 1,
            f"{learner.monitor.converged} adaptation episode(s) "
            f"converged; monitor state {learner.monitor.state!r}"),
        Invariant(
            "adapted_model_published",
            latest > v1 and manifest.metrics.get("online") == 1.0,
            f"registry at v{latest} (> deployed v{v1}), stamped as an "
            f"online checkpoint with cursors {manifest_offsets}"),
        Invariant(
            "fleet_hot_swapped",
            scorer.model_version == latest and latest in swap_log,
            f"scorer serving v{scorer.model_version} == registry tip "
            f"v{latest} after {len(swap_log)} hot-swaps"),
        Invariant(
            "auc_recovered",
            auc_pre is not None and auc_post is not None
            and (auc_post >= auc_pre - auc_margin
                 or (auc_during is not None
                     and auc_post >= auc_during
                     + max(0.03, 0.3 * (auc_pre - auc_during)))),
            f"live AUC {auc_pre and round(auc_pre, 3)} pre -> "
            f"{auc_during and round(auc_during, 3)} during-drift -> "
            f"{auc_post and round(auc_post, 3)} recovered "
            f"(within {auc_margin} of pre, or a >=30%-of-dip heal — "
            f"a drifted COHORT MIX can have a lower quality ceiling "
            f"than the pristine fleet; the quantitative online-vs-"
            f"micro-batch trajectory is bench_online's)"),
        Invariant(
            "zero_lost_zero_double_scored",
            scorer.scored == live_records
            and broker.end_offset(PRED_TOPIC, 0) == scorer.scored,
            f"{scorer.scored} rows scored == {live_records} live "
            f"records; predictions topic contiguous at "
            f"{broker.end_offset(PRED_TOPIC, 0)}"),
        Invariant(
            "commit_trails_manifest",
            all((committed.get(p) or 0) <= manifest_offsets.get(p, 0)
                for p in committed),
            f"committed {committed} <= newest durable manifest "
            f"{manifest_offsets} (offsets-as-checkpoint held)"),
        Invariant(
            "bad_adaptation_rolled_back",
            ab.decision == "rollback" and serving_final == good,
            f"gate verdict {ab.decision!r}; serving back at v"
            f"{serving_final} == last good v{good}"),
        _check_commits_monotonic(commit_log),
    ]
    shutil.rmtree(root, ignore_errors=True)
    return DrillReport(
        drill="drift-adapt-swap", seed=seed, records=records,
        published=published, scored=scorer.scored,
        restarts={},
        slos={"detect_records": detect_records,
              "auc_pre": auc_pre, "auc_during": auc_during,
              "auc_post": auc_post},
        invariants=invariants, injected={})


DRILLS = {
    "drift-adapt-swap": drill_drift_adapt_swap,
}
