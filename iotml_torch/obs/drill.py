"""Live alert-burn drill — the telemetry plane under real fire
(``iotml.obs.drill``'s copy; its scorer runs on the card unless the
caller names another device).

The supervise drills prove the *pipeline* heals; this drill proves the
*alerting loop around it* actually pages and un-pages.  It runs the full
chain on real threads:

    fleet + canaries → MQTT → bridge → JsonToAvro → supervised scorer
                         │
      /metrics (per-process HTTP) ← canary + pipeline registries
                         │ federated scrape (FleetServer)
                  _IOTML_TSDB (log-native history)
                         │ burn-rate evaluation (SloEngine, supervised)
            _IOTML_ALERTS + /healthz + iotml_slo_burn_rate{...}

in three phases:

- **A healthy**: fleet traffic and canaries flow through the
  undisturbed path; the SLO engine must stay quiet (no alert on a
  healthy system).
- **B degraded**: the ``alert-burn`` chaos schedule arms a SUSTAINED
  mqtt delivery delay far past the canary latency threshold; the FAST
  burn-rate pair must fire within the drill budget, the transition must
  land on the compacted ``_IOTML_ALERTS`` changelog, and both the
  process and fleet ``/healthz`` must flip to degraded with the alert
  attached.
- **C recovery**: faults disarm; once the degraded samples age out of
  the burn windows the alert must RESOLVE on its own and ``/healthz``
  must clear — un-paging is part of the contract.

Alongside the alert lifecycle the drill asserts the telemetry plane's
hygiene invariants: canary e2e latency is trace-span-sourced (the trace
headers survived the hops), canary records NEVER reach the user-facing
prediction topic, and the TSDB topic stays bounded under forced
compaction (per-(series, window) keying actually converges).

Run via ``python -m iotml_torch.obs tsdb drill`` (exit status is the
verdict); ``drill_alert_burn(device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import List, Optional

from ..chaos import faults, scenarios
from ..chaos.runner import IN_TOPIC, PRED_TOPIC, Invariant
from ..supervise.drill import CARS_PER_TICK, DrillReport, _wait
from ..supervise.supervisor import Supervisor
from ..utils.device import DeviceLike
from . import canary as _canary
from . import federate as _federate
from . import metrics as _metrics
from . import slo as _slo
from . import tracing
from . import tsdb as _tsdb

#: drill-scale burn windows: (name, short_ms, long_ms, threshold) — the
#: SRE-workbook fast/slow pairs compressed to seconds so the full
#: fire→resolve lifecycle fits in a CI drill.  The LOGIC is identical
#: to production DEFAULT_WINDOWS; only the durations shrink.
#: threshold geometry: in a total outage the time to fire is
#: threshold x budget x long-window, so fast (8 x 9 s) must stay well
#: under slow (6 x 18 s) — otherwise the slow pair races the fast one
#: to the transition and the drill's "fast pair pages first" assertion
#: becomes a coin flip (the workbook's 14.4x1h vs 6x6h keeps the same
#: ordering).
DRILL_WINDOWS = (
    ("fast", 3_000, 9_000, 8.0),
    ("slow", 6_000, 18_000, 6.0),
)

#: the drill's SLO rules: e2e latency through the real path (threshold
#: far above a healthy in-process hop, far below the injected delay)
#: and probe delivery.
DRILL_SLO_RULES = (
    {"name": "canary-e2e-latency", "objective": 0.97,
     "indicator": {"kind": "latency",
                   "metric": "iotml_canary_e2e_seconds",
                   "threshold_s": 0.1},
     "windows": DRILL_WINDOWS},
    {"name": "canary-delivery", "objective": 0.97,
     "indicator": {"kind": "ratio",
                   "bad": "iotml_canary_probes_total",
                   "total": "iotml_canary_probes_total",
                   "bad_matchers": {"outcome": "lost"},
                   "total_matchers": {"outcome": "sent"}},
     "windows": DRILL_WINDOWS},
)


def _http_json(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as r:
            return json.loads(r.read())
    except (OSError, ValueError):
        return None


def _make_firewalled_scorer(stream, consumer, device: DeviceLike = None):
    """The drill's scorer with the canary firewall armed: the batcher
    drops reserved-id records BEFORE the model (they must never reach the
    user-facing prediction topic).  Fresh weights from seed 0, on
    ``device``."""
    from ..data.dataset import SensorBatches
    from ..models.autoencoder import CAR_AUTOENCODER
    from ..serve.scorer import StreamScorer
    from ..stream.producer import OutputSequence
    from ..train.loop import Trainer

    trainer = Trainer(CAR_AUTOENCODER, device=device)
    trainer._ensure_state()
    batches = SensorBatches(consumer, batch_size=100,
                            exclude_key_marker=_canary.CANARY_KEY_MARKER)
    out = OutputSequence(stream, PRED_TOPIC, partition=0)
    return StreamScorer(CAR_AUTOENCODER, trainer.state.params, batches,
                        out, device=device)


def drill_alert_burn(seed: int = 7, records: int = 600,
                     events=None,
                     healthy_s: float = 10.0,
                     degraded_budget_s: float = 12.0,
                     resolve_budget_s: float = 30.0,
                     device: DeviceLike = None) -> DrillReport:
    """The full fire→resolve alert lifecycle against the live threaded
    telemetry plane (module docstring has the phase map); the scorer runs
    on ``device`` (the card unless the caller names another)."""
    import tempfile

    from ..core.schema import CAR_SCHEMA
    from ..gen.simulator import FleetGenerator, FleetScenario
    from ..mqtt.bridge import KafkaBridge
    from ..mqtt.broker import MqttBroker
    from ..stream.broker import Broker
    from ..stream.consumer import StreamConsumer
    from ..streamproc.tasks import JsonToAvro

    if events is None:
        events = scenarios.build("alert-burn", seed=seed,
                                 records=records).events

    # tracing ON: canary e2e must come from real trace spans
    prev = (tracing.ENABLED, tracing._SAMPLE, tracing._PATH)
    tracing.flush()
    tracing.configure(enabled=True, sample=1.0)
    tracing.reset()

    mqtt = MqttBroker()
    # durable broker: the TSDB-boundedness invariant needs REAL segment
    # compaction, which only the store-backed log implements
    tmp = tempfile.TemporaryDirectory(prefix="iotml-obs-drill-")
    stream = Broker(store_dir=tmp.name)
    KafkaBridge(mqtt, stream, partitions=2)
    task = JsonToAvro(stream, src="sensor-data", dst=IN_TOPIC,
                      partitions=2)
    parts = stream.topic(IN_TOPIC).partitions
    consumer = StreamConsumer(
        stream, [f"{IN_TOPIC}:{p}:0" for p in range(parts)],
        group="obs-drill-scorer")
    scorer = _make_firewalled_scorer(stream, consumer, device)

    # telemetry plane: per-process /metrics + fleet scrape into the
    # TSDB on a tight cadence (2 s chunks: forced compaction later
    # must still find multiple windows to converge on)
    srv = _metrics.start_http_server(port=0)
    proc_port = srv.server_address[1]
    proc_name = tracing.proc_name()
    appender = _tsdb.TsdbAppender(stream, chunk_ms=2_000)
    collector = _federate.FleetCollector()
    fleet = _federate.FleetServer(collector, port=0, interval_s=0.25,
                                  broker=stream, tsdb=appender).start()
    engine = _slo.SloEngine(stream, DRILL_SLO_RULES, interval_s=0.25)
    probe = _canary.CanaryProbe(mqtt, stream, topic=IN_TOPIC,
                                interval_s=0.15, timeout_s=3.0)

    def task_loop(unit):
        while not unit.should_stop():
            try:
                n = task.process_available()
            except ConnectionError:
                task.consumer.rewind_to_committed()
                time.sleep(0.02)
                continue
            unit.heartbeat()
            time.sleep(0.002 if n else 0.01)

    def scorer_loop(unit):
        consumer.rewind_to_committed()
        while not unit.should_stop():
            try:
                scorer.score_available()
            except ConnectionError:
                consumer.rewind_to_committed()
                time.sleep(0.02)
                continue
            unit.heartbeat()
            time.sleep(0.005)

    # fleet traffic rides beside the canaries for the whole drill (the
    # firewall invariant is only meaningful with real records flowing)
    gen = FleetGenerator(FleetScenario(num_cars=CARS_PER_TICK, seed=seed))
    pub_stop = threading.Event()
    published = {"n": 0}

    def publish_loop():
        ticks = max(1, -(-records // CARS_PER_TICK))
        for _ in range(ticks):
            cols = gen.step_columns()
            for i in range(len(cols["car"])):
                if pub_stop.is_set():
                    return
                rec = gen.row_record(cols, i, CAR_SCHEMA)
                rec["failure_occurred"] = str(cols["failure_occurred"][i])
                mqtt.publish(
                    f"vehicles/sensor/data/{gen.scenario.car_id(i)}",
                    json.dumps(rec).encode(), qos=1)
                published["n"] += 1
            if pub_stop.wait(0.25):
                return

    from ..supervise.registry import register_thread
    publisher = register_thread(threading.Thread(
        target=publish_loop, daemon=True, name="obs-drill-fleet"))

    sup = Supervisor(poll_interval_s=0.02, name="obs-drill-supervisor")
    sup.add_loop("ksql-task", task_loop, heartbeat_timeout_s=30.0)
    sup.add_loop("scorer", scorer_loop, heartbeat_timeout_s=30.0)
    sup.add_loop("slo-engine", engine.loop, heartbeat_timeout_s=30.0)
    sup.add_loop("canary", probe.loop, heartbeat_timeout_s=30.0)
    sup.start()
    publisher.start()

    fired_alert: Optional[dict] = None
    proc_hz_fire: Optional[dict] = None
    fleet_hz_fire: Optional[dict] = None
    t_fire_s: Optional[float] = None
    t_resolve_s: Optional[float] = None
    eng = None
    firing = {}
    healthy_clean = True
    try:
        # ---------------------------------------------------- A healthy
        deadline = time.monotonic() + healthy_s
        while time.monotonic() < deadline:
            if _slo.firing_alerts():
                healthy_clean = False
            time.sleep(0.05)

        # --------------------------------------------------- B degraded
        eng = faults.arm(faults.ChaosEngine(events))
        t_degraded = time.monotonic()
        latency_st = engine.states["canary-e2e-latency"]
        _wait(lambda: latency_st.firing and latency_st.window == "fast",
              degraded_budget_s)
        firing = {n: st for n, st in engine.states.items() if st.firing}
        if latency_st.firing:
            t_fire_s = time.monotonic() - t_degraded
            fired_alert = _slo.read_alerts(stream).get(
                "canary-e2e-latency")
            # the process healthz is instantaneous; the fleet healthz
            # lags one scrape — poll it up to a few intervals
            proc_hz_fire = _http_json(
                f"http://127.0.0.1:{proc_port}/healthz")
            _wait(lambda: ((_http_json(
                f"http://127.0.0.1:{fleet.port}/healthz") or {})
                .get("processes", {}).get(proc_name, {})
                .get("status")) == "degraded", 3.0, interval_s=0.1)
            fleet_hz_fire = _http_json(
                f"http://127.0.0.1:{fleet.port}/healthz")

        # --------------------------------------------------- C recovery
        faults.disarm()
        t_recover = time.monotonic()
        _wait(lambda: not any(st.firing
                              for st in engine.states.values()),
              resolve_budget_s, interval_s=0.1)
        if firing and not any(st.firing for st in engine.states.values()):
            t_resolve_s = time.monotonic() - t_recover
        # quiesce: everything published has flowed through to the scorer
        pub_stop.set()
        publisher.join(timeout=10.0)
        _wait(lambda: task.consumer.at_end(), 20.0)
        _wait(lambda: consumer.at_end(), 20.0)
        # the canary unit is still looping: give it a beat to observe
        # (or expire) every probe still in flight
        _wait(lambda: probe.report()["inflight"] == 0, 6.0,
              interval_s=0.1)
    finally:
        pub_stop.set()
        sup.stop()
        faults.disarm()
        fleet.stop()
        srv.shutdown()
        srv.server_close()
        tracing.flush()
        tracing.configure(enabled=prev[0], sample=prev[1],
                          path=prev[2] if prev[2] else "")

    # ------------------------------------------------------- invariants
    rep = probe.report()
    alerts_log = _slo.read_alerts(stream)
    final_firing = _slo.firing_alerts()

    # canary firewall: every canary delivered to the input topic must
    # be filtered before the model — rows scored == non-canary rows
    delivered = sum(stream.end_offset(IN_TOPIC, p) for p in range(parts))
    canary_delivered = 0
    for p in range(parts):
        off = 0
        while off < stream.end_offset(IN_TOPIC, p):
            batch = stream.fetch(IN_TOPIC, p, off, 4096)
            if not batch:
                break
            for m in batch:
                off = m.offset + 1
                if _canary.is_canary_key(m.key):
                    canary_delivered += 1

    # TSDB boundedness: after forced compaction the topic holds exactly
    # one record per live (series, window) chunk key.  Seal the active
    # segment first — compaction only rewrites sealed segments.
    pre_count = _count_records(stream, _tsdb.TSDB_TOPIC)
    distinct_keys = len(_read_tsdb_keys(stream))
    stream.store.log_for(_tsdb.TSDB_TOPIC, 0).roll()
    stream.run_compaction(force=True)
    post_count = _count_records(stream, _tsdb.TSDB_TOPIC)

    proc_hz_alerts = (proc_hz_fire or {}).get("alerts") or {}
    fleet_hz_status = ((fleet_hz_fire or {}).get("processes", {})
                       .get(proc_name, {}).get("status"))
    invariants: List[Invariant] = [
        Invariant("healthy_phase_quiet", healthy_clean,
                  "no alert fired on the undisturbed pipeline"),
        Invariant("alert_fired_fast_within_budget",
                  t_fire_s is not None and t_fire_s <= degraded_budget_s,
                  "fast burn pair fired "
                  + (f"{t_fire_s:.2f}s" if t_fire_s is not None
                     else "NEVER")
                  + f" after degradation (budget {degraded_budget_s}s)"),
        Invariant("alert_in_changelog",
                  fired_alert is not None
                  and fired_alert.get("action") == "fire"
                  and fired_alert.get("window") == "fast",
                  f"_IOTML_ALERTS fire transition: {fired_alert}"),
        Invariant("alert_in_healthz",
                  bool(proc_hz_alerts) and fleet_hz_status == "degraded",
                  f"process /healthz alerts={sorted(proc_hz_alerts)}; "
                  f"fleet saw {proc_name}={fleet_hz_status}"),
        Invariant("alert_resolved",
                  t_resolve_s is not None and not final_firing,
                  "alert resolved "
                  + (f"{t_resolve_s:.2f}s" if t_resolve_s is not None
                     else "NEVER")
                  + " after recovery; still firing: "
                  f"{sorted(final_firing) or 'none'}"),
        Invariant("resolve_in_changelog",
                  bool(alerts_log) and all(
                      not doc.get("firing")
                      for doc in alerts_log.values()),
                  "_IOTML_ALERTS final states: "
                  + str({k: v.get("action")
                         for k, v in sorted(alerts_log.items())})),
        Invariant("canary_e2e_trace_sourced",
                  rep["ok"] > 0 and rep["trace_sourced"] > 0,
                  f"{rep['trace_sourced']}/{rep['ok']} observed canary "
                  f"round-trips carried a live trace span"),
        Invariant("zero_canaries_scored",
                  canary_delivered > 0
                  and scorer.scored == delivered - canary_delivered,
                  f"delivered={delivered} canaries={canary_delivered} "
                  f"scored={scorer.scored} (must equal non-canary "
                  f"deliveries)"),
        Invariant("tsdb_bounded_after_compaction",
                  0 < post_count == distinct_keys < pre_count,
                  f"TSDB records {pre_count} -> {post_count} after "
                  f"forced compaction ({distinct_keys} distinct chunk "
                  f"keys)"),
        Invariant("no_degraded_units", not sup.degraded(),
                  f"degraded units: {sup.degraded() or 'none'}"
                  + "".join(f"; {u.name}: {u.last_error}"
                            for u in sup.units()
                            if u.name in sup.degraded())),
    ]
    stream.close()
    tmp.cleanup()
    return DrillReport(
        drill="alert-burn", seed=seed, records=records,
        published=published["n"] + rep["sent"], scored=scorer.scored,
        restarts={u.name: u.restarts for u in sup.units()},
        slos={"time_to_fire_s": t_fire_s,
              "time_to_resolve_s": t_resolve_s,
              "canary_last_e2e_s": rep["last_e2e_s"]},
        invariants=invariants,
        injected=dict(sorted(eng.injected.items())) if eng is not None
        else {})


def _read_tsdb_keys(stream) -> set:
    keys = set()
    off = stream.begin_offset(_tsdb.TSDB_TOPIC, 0)
    end = stream.end_offset(_tsdb.TSDB_TOPIC, 0)
    while off < end:
        batch = stream.fetch(_tsdb.TSDB_TOPIC, 0, off, 4096)
        if not batch:
            break
        for m in batch:
            off = m.offset + 1
            if m.key is not None and m.value is not None:
                keys.add(m.key)
    return keys


def _count_records(stream, topic: str, partition: int = 0) -> int:
    """Actual retained records (offsets keep their gaps across a
    compaction pass, so end - begin over-counts)."""
    n = 0
    off = stream.begin_offset(topic, partition)
    end = stream.end_offset(topic, partition)
    while off < end:
        batch = stream.fetch(topic, partition, off, 4096)
        if not batch:
            break
        for m in batch:
            off = m.offset + 1
            n += 1
    return n
