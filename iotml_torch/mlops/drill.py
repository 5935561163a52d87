"""Live mlops drills (``iotml.mlops.drill``'s copy): zero-downtime rollout
and rollback, under fire.

The chaos scenarios (``trainer-crash-mid-checkpoint``,
``rollout-regression-rollback``) prove the model-lifecycle invariants in
a deterministic single-threaded replay; these drills prove the live
multi-threaded system delivers them while the fleet keeps publishing:

- ``drill_rollout``: a supervised scorer serves a stream under sustained
  load while the registry promotes a sequence of new model versions.
  The registry watcher must hot-swap each one within an SLO, and the
  proof of "zero downtime" is record identity: every ``(partition,
  offset)`` in the input log is scored exactly once across every swap.
- ``drill_rollback``: a deliberately degraded candidate is DEPLOYED to
  serving (the production scorer really runs it); the A/B gate must
  detect the live quality regression and roll serving back to the
  baseline within an SLO, and the production scorer must end up back on
  the baseline version having lost nothing.

The rollback drill's first evaluation step waits for the watcher to swap
the candidate in: JAX's drill judges at once, and a quick verdict there
can re-point serving before the candidate was ever live.

The supervisor, SLOs (swap 5 s, rollback 60 s) and invariants are the
JAX package's; each model is made by ``Trainer(..., seed=seed + k)`` and
trains and scores on ``device`` (``cuda`` unless given).  Run via
``python -m iotml_torch.mlops drill`` (verdict = exit status).
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Tuple

import numpy as np

from ..chaos.runner import (Invariant, _check_commits_monotonic,
                            _record_commits)
from ..supervise.drill import CARS_PER_TICK, DrillReport, _wait
from ..supervise.supervisor import Supervisor
from ..utils.device import DeviceLike
from .checkpoint import (AsyncCheckpointer, params_from_h5_bytes,
                         params_to_h5_bytes)
from .registry import ModelRegistry
from .rollout import ABRollout, RegistryWatcher, RolloutGate

IN_TOPIC = "SENSOR_DATA_S_AVRO"
PRED_TOPIC = "model-predictions"
GROUP = "mlops-drill-scorer"


# ------------------------------------------------------------- helpers
def _identity_consumer(broker, parts: int, group: str,
                       identities: List[Tuple[int, int]]):
    """A StreamConsumer whose every polled record is ledgered by
    (partition, offset): the ground truth of the zero-loss and zero-dup
    verdicts."""
    from ..stream.consumer import StreamConsumer

    consumer = StreamConsumer(
        broker, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
        group=group, eof=True)
    orig_poll = consumer.poll

    def poll(max_messages: int = 1024):
        batch = orig_poll(max_messages)
        identities.extend((m.partition, m.offset) for m in batch)
        return batch

    consumer.poll = poll
    return consumer


def _make_scorer(broker, consumer, params, threshold=None,
                 device: DeviceLike = None):
    from ..data.dataset import SensorBatches
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..serve.scorer import StreamScorer
    from ..stream.producer import OutputSequence

    kw = {} if threshold is None else dict(threshold=threshold)
    batches = SensorBatches(consumer, batch_size=100,
                            keep_labels=threshold is not None)
    out = OutputSequence(broker, PRED_TOPIC, partition=0)
    return StreamScorer(CAR_AUTOENCODER, params, batches, out,
                        device=device, **kw)


def _scorer_loop(scorer, consumer, state):
    def loop(unit):
        consumer.rewind_to_committed()
        while not unit.should_stop():
            try:
                n = scorer.score_available()
            except ConnectionError:
                consumer.rewind_to_committed()
                state["rewinds"] += 1
                time.sleep(0.02)
                continue
            unit.heartbeat()
            if not n:
                time.sleep(0.005)

    return loop


def _publish_tick(gen, broker, codec, schema, frame) -> int:
    """One fleet tick, Avro-framed, straight onto the input topic (the
    drill stands in for devsim and the convert leg)."""
    cols = gen.step_columns()
    n = len(cols["car"])
    for i in range(n):
        rec = gen.row_record(cols, i, schema)
        broker.produce(IN_TOPIC, frame(codec.encode(rec)),
                       key=gen.scenario.car_id(i).encode(),
                       partition=i % 2)
    return n


def _identity_verdicts(broker, identities, parts: int) -> List[Invariant]:
    expected = set()
    for p in range(parts):
        expected.update((p, o) for o in
                        range(broker.end_offset(IN_TOPIC, p)))
    seen = list(identities)
    dupes = len(seen) - len(set(seen))
    missing = expected - set(seen)
    extra = set(seen) - expected
    return [
        Invariant(
            "zero_records_lost",
            not missing and not extra,
            f"every one of the {len(expected)} (partition, offset) "
            f"identities in the log was polled and scored"
            if not missing and not extra else
            f"{len(missing)} records NEVER SCORED "
            f"(e.g. {sorted(missing)[:3]}); {len(extra)} phantom"),
        Invariant(
            "zero_double_scored",
            dupes == 0,
            f"{len(seen)} polled identities, all unique"
            + ("" if not dupes else f"; {dupes} DOUBLE-SCORED")),
    ]


def _final_commit(broker, parts: int) -> bool:
    return all(broker.committed(GROUP, IN_TOPIC, p)
               == broker.end_offset(IN_TOPIC, p) for p in range(parts))


def _drill_broker(parts: int):
    from ..stream.broker import Broker

    broker = Broker()
    broker.create_topic(IN_TOPIC, partitions=parts)
    broker.create_topic(PRED_TOPIC, partitions=1)
    commit_log: List[tuple] = []
    _record_commits(broker, commit_log, "stream")
    return broker, commit_log


def _supervise(scorer, consumer, watcher, state, scorer_timeout_s: float):
    sup = Supervisor(poll_interval_s=0.05, name="mlops-drill-supervisor")
    sup.add_loop("scorer", _scorer_loop(scorer, consumer, state),
                 heartbeat_timeout_s=scorer_timeout_s)
    sup.add_loop("registry-watcher", watcher.unit_loop(),
                 heartbeat_timeout_s=30.0)
    return sup.start()


# ------------------------------------------------------------- rollout
def drill_rollout(seed: int = 7, records: int = 1500,
                  n_versions: int = 3, slo_swap_s: float = 5.0,
                  device: DeviceLike = None) -> DrillReport:
    """Zero-downtime hot-swap under sustained load.

    A supervised scorer and registry watcher serve the stream while the
    fleet publishes continuously and the registry promotes
    ``n_versions`` successive models mid-flight.  Every promotion must
    be picked up within ``slo_swap_s`` with the scorer never pausing:
    afterwards every (partition, offset) in the log was scored exactly
    once and the predictions topic is contiguous."""
    from ..core.schema import KSQL_CAR_SCHEMA
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..ops.avro import AvroCodec
    from ..ops.framing import frame
    from ..train.loop import Trainer

    if records < (n_versions + 2) * CARS_PER_TICK:
        raise ValueError(f"rollout needs >= {(n_versions + 2) * 25} "
                         f"records, got {records}")
    parts = 2
    broker, commit_log = _drill_broker(parts)
    tmp = tempfile.TemporaryDirectory(prefix="iotml_drill_registry_")
    registry = ModelRegistry(tmp.name)

    def fresh_params(k: int):
        tr = Trainer(CAR_AUTOENCODER, seed=seed + k, device=device)
        tr._ensure_state()
        return tr.state.params

    v1 = registry.publish({"model.h5": params_to_h5_bytes(fresh_params(0))},
                          metrics={"k": 0.0}).version
    registry.promote(v1)

    identities: List[Tuple[int, int]] = []
    consumer = _identity_consumer(broker, parts, GROUP, identities)
    scorer = _make_scorer(
        broker, consumer,
        params_from_h5_bytes(registry.load_bytes(v1, "model.h5")),
        device=device)
    # the swap observed where it happens (the set_params call itself):
    # sampling scorer.model_version from the drive loop can miss an
    # intermediate version, and the serving channel is level-triggered,
    # so two promotions inside one watcher poll coalesce into one swap
    swap_times: Dict[int, float] = {}
    _orig_set_params = scorer.set_params

    def _recording_set_params(params, version=None):
        _orig_set_params(params, version=version)
        if version is not None and version not in swap_times:
            swap_times[version] = time.monotonic()

    scorer.set_params = _recording_set_params
    watcher = RegistryWatcher(registry, scorers=[scorer],
                              poll_interval_s=0.02)
    state: dict = {"rewinds": 0}
    sup = _supervise(scorer, consumer, watcher, state, 30.0)

    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed))
    codec = AvroCodec(KSQL_CAR_SCHEMA)
    published = 0
    ticks = max(1, -(-records // CARS_PER_TICK))
    promote_every = max(1, ticks // (n_versions + 1))
    #: version -> (t_promoted, scored_at_promote); the swap edge itself
    #: lands in swap_times through the set_params wrapper
    swap_log: Dict[int, list] = {}
    next_k = 1
    try:
        for tick in range(ticks):
            if next_k <= n_versions and tick == next_k * promote_every:
                # promote mid-load: publish new weights, flip serving
                v = registry.publish(
                    {"model.h5": params_to_h5_bytes(fresh_params(next_k))},
                    metrics={"k": float(next_k)}).version
                registry.promote(v)
                swap_log[v] = [time.monotonic(), scorer.scored]
                next_k += 1
            published += _publish_tick(gen, broker, codec,
                                       KSQL_CAR_SCHEMA, frame)
            time.sleep(0.002)  # live pacing: swap windows overlap load
        # quiesce: the last promoted version lands, everything is scored
        # and committed
        last_v = max(swap_log) if swap_log else v1
        _wait(lambda: scorer.model_version == last_v, slo_swap_s + 10)
        _wait(lambda: consumer.at_end() and _final_commit(broker, parts),
              30.0)
    finally:
        sup.stop()
        watcher.stop()
        tmp.cleanup()

    lat = {v: swap_times[v] - e[0]
           for v, e in swap_log.items() if v in swap_times}
    coalesced = sorted(v for v in swap_log if v not in swap_times)
    worst = max(lat.values(), default=None)
    pred_end = broker.end_offset(PRED_TOPIC, 0)
    contiguous = pred_end == scorer.scored == published
    invariants = [
        Invariant(
            # convergence, not every intermediate pointer value: the
            # serving channel is level-triggered, so promotions racing one
            # watcher poll legitimately coalesce; what must hold is that
            # the scorer ends on the LAST promoted version, really swapped
            # mid-load, and never moved backwards
            "hot_swap_converged",
            len(swap_log) == n_versions
            and scorer.model_version == max(swap_log)
            and len(lat) >= 1
            and sorted(swap_times) == sorted(
                swap_times, key=swap_times.get),
            f"{n_versions} promotions -> {len(lat)} swaps applied in "
            f"version order ({len(coalesced)} coalesced: {coalesced}); "
            f"serving version ended at v{scorer.model_version}"),
        Invariant(
            "swap_within_slo",
            worst is not None and worst <= slo_swap_s,
            f"worst promote->swap latency {worst:.3f}s "
            f"(slo {slo_swap_s}s) across {len(lat)} swaps"
            if worst is not None else "a swap was never observed"),
        *_identity_verdicts(broker, identities, parts),
        Invariant(
            "predictions_contiguous", contiguous,
            f"predictions end {pred_end} == scored {scorer.scored} == "
            f"published {published} (no swap dropped or re-emitted a "
            f"row)" if contiguous else
            f"predictions end {pred_end}, scored {scorer.scored}, "
            f"published {published} DIVERGE"),
        _check_commits_monotonic(commit_log),
        Invariant(
            "final_commit_at_end", _final_commit(broker, parts),
            "committed == log end on every partition"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"),
    ]
    return DrillReport(
        drill="rollout", seed=seed, records=records,
        published=published, scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={"worst_swap_latency_s": worst},
        invariants=invariants, injected={})


# ------------------------------------------------------------ rollback
def drill_rollback(seed: int = 7, records: int = 1500,
                   slo_rollback_s: float = 60.0,
                   device: DeviceLike = None) -> DrillReport:
    """Rollback-on-regression, live: the bad model really serves.

    A baseline is trained on the stream's history and promoted; a
    deliberately degraded candidate is then DEPLOYED (serving flips to
    it, and the production scorer hot-swaps onto the bad weights) while
    an A/B evaluation scores both versions against the live labeled
    stream.  The gate must detect the regression and point serving back
    at the baseline within ``slo_rollback_s``; the production scorer must
    end up back on the baseline with zero records lost across the whole
    deploy → regress → rollback arc."""
    from ..core.schema import KSQL_CAR_SCHEMA
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..online.drill import _noised
    from ..ops.avro import AvroCodec
    from ..ops.framing import frame
    from ..train.live import ContinuousTrainer

    if records < 20 * CARS_PER_TICK:
        raise ValueError(f"rollback needs >= {20 * 25} records "
                         f"(training history + evaluation window), "
                         f"got {records}")
    parts = 2
    broker, commit_log = _drill_broker(parts)
    tmp = tempfile.TemporaryDirectory(prefix="iotml_drill_registry_")
    registry = ModelRegistry(tmp.name)

    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed,
                                       failure_rate=0.05))
    codec = AvroCodec(KSQL_CAR_SCHEMA)
    ticks = max(1, -(-records // CARS_PER_TICK))
    history_ticks = max(1, ticks // 2)
    published = 0
    for _ in range(history_ticks):
        published += _publish_tick(gen, broker, codec, KSQL_CAR_SCHEMA,
                                   frame)

    # the baseline: quickly trained on the history, published through
    # the async checkpointer (auto-promoted to serving)
    trainer = ContinuousTrainer(
        broker, IN_TOPIC, None, checkpointer=AsyncCheckpointer(registry),
        group="mlops-drill-train", batch_size=50,
        take_batches=max(2, min(8, published // 60)), epochs_per_round=3,
        device=device)
    trainer.train_round()
    trainer.checkpointer.write_once()
    baseline = registry.latest()

    # the production scorer and watcher, supervised, serving the baseline
    identities: List[Tuple[int, int]] = []
    consumer = _identity_consumer(broker, parts, GROUP, identities)
    good = params_from_h5_bytes(registry.load_bytes(baseline, "model.h5"))
    scorer = _make_scorer(broker, consumer, good, threshold=5.0,
                          device=device)
    scorer.model_version = baseline
    watcher = RegistryWatcher(registry, scorers=[scorer],
                              poll_interval_s=0.02)
    state: dict = {"rewinds": 0}
    sup = _supervise(scorer, consumer, watcher, state, 60.0)

    # the candidate: the baseline's weights + N(0, 1), drawn in the JAX
    # package's leaf order
    bad = _noised(good, np.random.RandomState(seed))
    candidate = registry.publish(
        {"model.h5": params_to_h5_bytes(bad)},
        metrics={"degraded": 1.0}).version

    gate = RolloutGate(min_records=max(50, min(300, published // 2)),
                       epsilon=0.02)
    ab = ABRollout(broker, IN_TOPIC, registry, baseline, candidate,
                   gate=gate, threshold=5.0, deploy_candidate=True,
                   from_start=True, group_prefix="mlops-drill-ab",
                   device=device)
    t_deploy = time.monotonic()
    t_decided = None
    t_restored = None
    try:
        # the gate judges the candidate while it serves: the first
        # evaluation step waits for the watcher's swap, so a quick
        # verdict cannot re-point serving before the candidate was live
        saw_candidate_live = _wait(
            lambda: scorer.model_version == candidate, slo_rollback_s)
        for _ in range(ticks - history_ticks):
            published += _publish_tick(gen, broker, codec,
                                       KSQL_CAR_SCHEMA, frame)
            ab.step(max_rows=5_000)
            if scorer.model_version == candidate:
                saw_candidate_live = True
            if ab.decision is not None and t_decided is None:
                t_decided = time.monotonic()
            if t_decided is not None and t_restored is None \
                    and scorer.model_version == baseline:
                t_restored = time.monotonic()
            time.sleep(0.002)
        # drain the gate to a verdict if the publish loop outran it
        deadline = time.monotonic() + slo_rollback_s
        while ab.decision is None and time.monotonic() < deadline:
            if ab.step(max_rows=5_000) == 0:
                time.sleep(0.01)
            if scorer.model_version == candidate:
                saw_candidate_live = True
        if ab.decision is not None and t_decided is None:
            t_decided = time.monotonic()
        _wait(lambda: scorer.model_version == baseline, 15.0)
        if t_restored is None and scorer.model_version == baseline:
            t_restored = time.monotonic()
        _wait(lambda: consumer.at_end() and _final_commit(broker, parts),
              30.0)
        serving_final = registry.channel("serving")
    finally:
        sup.stop()
        watcher.stop()
        tmp.cleanup()

    t_rollback = (t_decided - t_deploy) if t_decided is not None else None
    t_heal = (t_restored - t_deploy) if t_restored is not None else None
    qb, qc = ab.quality("baseline"), ab.quality("candidate")
    invariants = [
        Invariant(
            "candidate_deployed_live",
            saw_candidate_live,
            "the production scorer really served the degraded "
            "candidate (deploy-during-eval, not shadow)"
            if saw_candidate_live else
            "the candidate never reached the production scorer"),
        Invariant(
            "regression_rolled_back",
            ab.decision == "rollback",
            f"gate verdict {ab.decision!r} (baseline auc={qb['auc']}, "
            f"candidate auc={qc['auc']})"),
        Invariant(
            "rollback_within_slo",
            t_rollback is not None and t_rollback <= slo_rollback_s,
            f"deploy -> rollback verdict in {t_rollback:.3f}s "
            f"(slo {slo_rollback_s}s)" if t_rollback is not None
            else "the gate never decided"),
        Invariant(
            "production_healed",
            t_heal is not None and scorer.model_version == baseline
            and serving_final == baseline,
            f"serving re-pointed and the production scorer swapped "
            f"back to v{baseline} {t_heal:.3f}s after deploy"
            if t_heal is not None else
            "production scorer never returned to the baseline"),
        *_identity_verdicts(broker, identities, parts),
        _check_commits_monotonic(commit_log),
        Invariant(
            "final_commit_at_end", _final_commit(broker, parts),
            "committed == log end on every partition"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"),
    ]
    return DrillReport(
        drill="rollback", seed=seed, records=records,
        published=published, scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={"time_to_rollback_s": t_rollback,
              "time_to_production_healed_s": t_heal},
        invariants=invariants, injected={})


DRILLS = {
    "rollout": drill_rollout,
    "rollback": drill_rollback,
}
