"""Metrics registry with Prometheus text exposition (``iotml.obs.metrics``'s
twin).

Every component registers counters, gauges and histograms here, and
``render()`` emits the Prometheus text format that ``start_http_server``
serves on ``/metrics``.  The families of ``default_registry`` carry the
JAX package's names, help texts and buckets, so one scrape reads the
same from either package; ``cardinality_violations`` holds labels to the
same closed vocabulary.  ``/healthz`` reports stage liveness (the trace
collector), the units of any live supervisor, the model versions with
their offsets lag, the event-time watermarks, consumer lag and the SLO
alerts firing in this process, the replica loss window and the
quorum's ISR widths, under-replicated count and HWM lag; a degraded unit
or a firing alert sets ``status`` to ``degraded``.  A server publishes its address into the fleet's
endpoints manifest when ``IOTML_OBS_ENDPOINTS`` names one, and
in-process otherwise (``federate``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping: backslash, double-quote and
    newline must be escaped or the exposition line is unparseable (a
    label value like `car="a\nb"` silently corrupts the whole scrape)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Optional[dict]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._vals: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return self._vals.get(tuple(sorted(labels.items())), 0.0)

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:  # scrapes race with inc() from worker threads
            vals = dict(self._vals)
        for key, v in sorted(vals.items()):
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        if not vals:
            out.append(f"{self.name} 0")
        return "\n".join(out)


class Gauge(Counter):
    def set(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._vals[key] = float(value)

    def render(self) -> str:
        return super().render().replace(" counter", " gauge", 1)


class Histogram:
    """Fixed-bucket histogram (Prometheus cumulative-bucket convention).

    Optionally labeled: ``observe(v, stage="decode")`` keeps one bucket
    series per label set (the `iotml_stage_seconds{stage=...}` family);
    unlabeled observations are the plain single-series histogram."""

    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)

    def __init__(self, name: str, help_: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        # label-key tuple → [bucket counts..., +Inf count]; () = unlabeled
        self._series: Dict[tuple, list] = {}
        self._sums: Dict[tuple, float] = {}
        self._ns: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def _counts_for(self, key: tuple) -> list:
        counts = self._series.get(key)
        if counts is None:
            counts = self._series[key] = [0] * (len(self.buckets) + 1)
            self._sums[key] = 0.0
            self._ns[key] = 0
        return counts

    def observe(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts_for(key)
            self._sums[key] += value
            self._ns[key] += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    return
            counts[-1] += 1

    def time(self, **labels):
        """Context manager: observe elapsed seconds (optionally into a
        labeled series, e.g. ``checkpoint_seconds.time(phase="fsync")``)."""
        hist = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)

        return _T()

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:  # consistent bucket/sum/count snapshot under load
            series = {k: list(v) for k, v in self._series.items()}
            sums, ns = dict(self._sums), dict(self._ns)
        if not series:
            series[()] = [0] * (len(self.buckets) + 1)
            sums[()], ns[()] = 0.0, 0
        for key in sorted(series):
            labels = dict(key)
            cum = 0
            for b, c in zip(self.buckets, series[key]):
                cum += c
                out.append(f"{self.name}_bucket"
                           f"{_fmt_labels({**labels, 'le': b})} {cum}")
            cum += series[key][-1]
            out.append(f"{self.name}_bucket"
                       f"{_fmt_labels({**labels, 'le': '+Inf'})} {cum}")
            suffix = _fmt_labels(labels)
            out.append(f"{self.name}_sum{suffix} {sums[key]}")
            out.append(f"{self.name}_count{suffix} {ns[key]}")
        return "\n".join(out)


class Registry:
    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", **kw) -> Histogram:
        return self._get(name, lambda: Histogram(name, help_, **kw))

    def _get(self, name, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def render(self) -> str:
        return "\n".join(m.render() for _, m in sorted(self._metrics.items())) + "\n"

    def collect(self) -> Dict[str, float]:
        """Structured snapshot: metric name (with label suffix for labeled
        series; `_sum`/`_count` for histograms) → value.  The typed
        counterpart of `render()` for programmatic consumers."""
        out: Dict[str, float] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, Histogram):
                with m._lock:
                    sums, ns = dict(m._sums), dict(m._ns)
                if not sums:
                    sums[()], ns[()] = 0.0, 0
                for key in sorted(sums):
                    suffix = _fmt_labels(dict(key))
                    out[f"{name}_sum{suffix}"] = sums[key]
                    out[f"{name}_count{suffix}"] = float(ns[key])
                continue
            with m._lock:
                vals = dict(m._vals)
            for key, v in sorted(vals.items()):
                out[name + _fmt_labels(dict(key))] = v
            if not vals:
                out[name] = 0.0
        return out


default_registry = Registry()
records_consumed = default_registry.counter(
    "iotml_records_consumed_total", "stream records decoded")
records_trained = default_registry.counter(
    "iotml_records_trained_total", "records through the train step")
records_scored = default_registry.counter(
    "iotml_records_scored_total", "records through the scorer")
train_step_seconds = default_registry.histogram(
    "iotml_train_step_seconds", "train-step latency")
reconstruction_mse = default_registry.gauge(
    "iotml_reconstruction_mse", "last mean reconstruction error")
live_train_rounds = default_registry.counter(
    "live_train_rounds_total", "continuous-trainer rounds completed")
live_train_loss = default_registry.gauge(
    "live_train_loss", "continuous-trainer last round loss")
live_model_updates = default_registry.counter(
    "live_model_updates_total", "scorer weight hot-swaps applied")
live_detection_precision = default_registry.gauge(
    "live_detection_precision",
    "live verdict precision vs stream labels (cumulative)")
live_detection_recall = default_registry.gauge(
    "live_detection_recall",
    "live verdict recall vs stream labels (cumulative)")
fetch_batch_size = default_registry.histogram(
    "iotml_fetch_batch_size", "records returned per non-empty consumer poll",
    buckets=(1, 8, 32, 128, 512, 1024, 2048, 4096))
commit_seconds = default_registry.histogram(
    "iotml_commit_seconds", "consumer offset-commit latency")
scorer_rewinds = default_registry.counter(
    "iotml_scorer_rewinds_total",
    "scorer rewind-to-committed redeliveries after a broker failover")
consumer_autoresets = default_registry.counter(
    "iotml_consumer_autoresets_total",
    "consumer cursors auto-reset to earliest after retention trimmed "
    "past them (OffsetOutOfRange), by topic")
replica_sync_rounds = default_registry.counter(
    "iotml_replica_sync_rounds_total", "follower replication rounds")
replica_copied = default_registry.counter(
    "iotml_replica_copied_total", "messages copied leader -> follower")
replica_sync_errors = default_registry.counter(
    "iotml_replica_sync_errors_total",
    "replication rounds that failed (leader dying / unreachable)")
replica_lag = default_registry.gauge(
    "iotml_replica_lag_records",
    "per-topic records the leader has that the follower does not "
    "(the loss window if the leader died now)")
failover_epoch = default_registry.gauge(
    "iotml_failover_epoch",
    "current leadership fencing epoch (bumped at every promotion)")
supervisor_unit_up = default_registry.gauge(
    "iotml_supervisor_unit_up",
    "1 while a supervised unit is live, 0 while down/degraded")
supervisor_restarts = default_registry.counter(
    "iotml_supervisor_restarts_total",
    "restarts issued per supervised unit")
supervisor_wedged = default_registry.counter(
    "iotml_supervisor_wedged_total",
    "wedge detections (live thread, stale heartbeat/stage) per unit")
supervisor_degraded = default_registry.gauge(
    "iotml_supervisor_degraded",
    "1 when the restart-storm budget is exhausted and the supervisor "
    "gave the unit up")
supervisor_failovers = default_registry.counter(
    "iotml_supervisor_failovers_total",
    "on_death failover hooks fired (leader promotions)")
cluster_not_leader_bounces = default_registry.counter(
    "iotml_cluster_not_leader_total",
    "produce/fetch requests bounced with NOT_LEADER_FOR_PARTITION "
    "(stale client metadata; refreshed and re-routed)")
cluster_metadata_refreshes = default_registry.counter(
    "iotml_cluster_metadata_refreshes_total",
    "cluster metadata refreshes performed by routing clients")
cluster_shard_failovers = default_registry.counter(
    "iotml_cluster_shard_failovers_total",
    "per-shard leader failovers (one shard moved, not the world; "
    "label shard= says WHICH — the TSDB query surface can tell a "
    "flapping shard from spread-out churn)")
cluster_shard_epoch = default_registry.gauge(
    "iotml_cluster_shard_epoch",
    "current leadership epoch per shard (a bump = a promotion; the "
    "federated scrape carries the per-shard label into the TSDB)")
cluster_coordinator_moves = default_registry.counter(
    "iotml_cluster_coordinator_moves_total",
    "group-coordinator re-discoveries after NOT_COORDINATOR or a "
    "coordinator broker death")
model_version = default_registry.gauge(
    "iotml_model_version",
    "registry version currently loaded, by component "
    "(trainer = last published, scorer = serving)")
model_offsets_lag = default_registry.gauge(
    "iotml_model_offsets_lag",
    "records between the current model's stamped train offsets and the "
    "log end (staleness of the serving model's knowledge)")
checkpoint_seconds = default_registry.histogram(
    "iotml_checkpoint_seconds",
    "checkpoint wall-time by phase: snapshot (train thread, device->"
    "host), serialize + fsync (background writer thread)")
checkpoint_dropped = default_registry.counter(
    "iotml_checkpoint_dropped_total",
    "pending snapshots evicted drop-oldest from the bounded writer "
    "queue (a slow disk sheds checkpoints, never stalls training)")
registry_publishes = default_registry.counter(
    "iotml_registry_publishes_total",
    "model versions committed to the registry (manifest written)")
registry_torn_recovered = default_registry.counter(
    "iotml_registry_torn_recovered_total",
    "torn/uncommitted version dirs swept by registry recovery")
registry_pruned = default_registry.counter(
    "iotml_registry_pruned_total",
    "committed versions removed by retention (keep-newest-N; channel "
    "targets are never pruned)")
model_swaps = default_registry.counter(
    "iotml_model_swaps_total",
    "scorer hot-swaps applied by registry watchers (no restart, no "
    "dropped records)")
rollouts = default_registry.counter(
    "iotml_rollouts_total",
    "A/B rollout gate decisions, by outcome (promoted | rolled_back)")
online_updates = default_registry.counter(
    "iotml_online_updates_total",
    "incremental (per-window) SGD updates applied by the online learner")
online_drifts = default_registry.counter(
    "iotml_online_drifts_total",
    "drift episodes detected on the reconstruction-error signal, by "
    "detector (ph | adwin | level)")
online_adaptations = default_registry.counter(
    "iotml_online_adaptations_total",
    "drift-triggered adaptations applied, by action "
    "(boost | refit | reset)")
online_converged = default_registry.counter(
    "iotml_online_converged_total",
    "adaptation episodes that converged (smoothed error back inside "
    "the stable band; the monitor re-anchored its baseline)")
online_lr = default_registry.gauge(
    "iotml_online_learning_rate",
    "the online learner's current effective learning rate (boosted "
    "while a drift adaptation is active)")
online_drift_stat = default_registry.gauge(
    "iotml_online_drift_stat",
    "current Page-Hinkley statistic over the normalized smoothed "
    "error (drift fires when it crosses the configured threshold)")
fleet_deferred = default_registry.counter(
    "iotml_fleet_deferred_total",
    "fleet-agent publishes deferred under MQTT backpressure (drained "
    "on later ticks — deferred, never dropped)")
dlq_total = default_registry.counter(
    "iotml_dlq_total",
    "undecodable records routed to a dead-letter topic, by source topic")
dlq_route_errors = default_registry.counter(
    "iotml_dlq_route_errors_total",
    "dead letters that could not be routed (degraded to a plain drop)")
watermark_lag_seconds = default_registry.histogram(
    "iotml_watermark_lag_seconds",
    "event-time lag (now - record timestamp) at each stage's progress "
    "frontier, batch-granular (min and max event time per batch)",
    buckets=(0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0,
             60.0, 300.0))
watermark_event_ms = default_registry.gauge(
    "iotml_watermark_event_time_ms",
    "newest event timestamp (ms) each stage has fully processed — the "
    "stage's event-time watermark, by stage/topic/partition")
consumer_lag_records = default_registry.gauge(
    "iotml_consumer_lag_records",
    "records between a consumer group's cursor and the partition "
    "high-water mark, by group/topic/partition")
step_seconds = default_registry.histogram(
    "iotml_step_seconds",
    "hot-loop wall time by loop (train|score|online) and phase "
    "(host_wait | device_compute | host_pipeline)",
    buckets=(0.0001, 0.001, 0.005, 0.02, 0.05, 0.1, 0.5, 1.0, 5.0,
             30.0))
prefetch_occupancy = default_registry.gauge(
    "iotml_prefetch_occupancy",
    "DevicePrefetcher queue fill fraction (0 = device starving on the "
    "host pipeline, 1 = host running ahead)")
isr_size = default_registry.gauge(
    "iotml_isr_size",
    "in-sync replica count per partition, leader included (acks=all "
    "commits at min(ISR positions))")
under_replicated = default_registry.gauge(
    "iotml_under_replicated_partitions",
    "replicated partitions whose ISR is below the configured replica "
    "target (followers evicted for lag/staleness and not re-admitted)")
quorum_hwm_lag = default_registry.gauge(
    "iotml_quorum_hwm_lag_records",
    "records between the leader log end and the quorum high-water mark "
    "— the tail acks=all producers are still waiting on and consumers "
    "cannot read yet, by topic/partition")


#: the CLOSED label-key vocabulary every iotml metric must draw from.
#: Metric labels multiply series: one label drawn from an unbounded set
#: (a car id, a trace id, an offset) turns a fixed-cost scrape into an
#: unbounded allocation — the cardinality-bound test
#: fails such a label before production does.
ALLOWED_LABEL_KEYS = frozenset({
    "stage", "topic", "partition", "group", "phase", "loop", "process",
    "component", "detector", "action", "fault", "source", "outcome",
    "unit", "le", "slo", "window", "shard", "route", "code",
})

#: per-metric ceiling on distinct label-value combinations.  Generous —
#: topics × partitions × stages legitimately reach dozens — but far
#: below what one runaway per-entity label produces in seconds.
MAX_LABEL_SERIES = 256

#: per-metric label DECLARATIONS: the exact label keys each labeled
#: metric may be recorded with.  ALLOWED_LABEL_KEYS bounds the
#: vocabulary; this table bounds each metric's dimensions — a record
#: site using a key missing from its row is registry drift, caught before the new dimension multiplies series in
#: production.  Metrics absent from the table take no labels.
DECLARED_METRIC_LABELS = {
    "alert_transitions": ("action",),
    "canary_probes": ("outcome",),
    "chaos_injected": ("fault",),
    "checkpoint_seconds": ("phase",),
    "cluster_shard_epoch": ("shard",),
    "cluster_shard_failovers": ("shard",),
    "consumer_autoresets": ("topic",),
    "consumer_lag_records": ("group", "partition", "topic"),
    "dlq_total": ("source",),
    "gateway_promotions": ("shard",),
    "gateway_standby_lag": ("shard",),
    "isr_size": ("partition", "topic"),
    "model_offsets_lag": ("component",),
    "model_version": ("component",),
    "online_adaptations": ("action",),
    "online_drifts": ("detector",),
    "prefetch_occupancy": ("loop",),
    "quorum_hwm_lag": ("partition", "topic"),
    "replica_lag": ("topic",),
    "rest_request_seconds": ("route",),
    "rest_requests": ("route", "code"),
    "rollouts": ("outcome",),
    "slo_burn_rate": ("slo", "window"),
    "step_seconds": ("loop", "phase"),
    "supervisor_degraded": ("unit",),
    "supervisor_failovers": ("unit",),
    "supervisor_restarts": ("unit",),
    "supervisor_unit_up": ("unit",),
    "supervisor_wedged": ("unit",),
    "watermark_event_ms": ("group", "partition", "stage", "topic"),
    "watermark_lag_seconds": ("group", "partition", "stage", "topic"),
}


def cardinality_violations(registry: "Registry" = None,
                           max_series: int = MAX_LABEL_SERIES):
    """[(metric, problem)] for labels outside the closed vocabulary or
    metrics whose labeled-series count exceeds `max_series` — the
    label-cardinality bound the obs test suite pins."""
    registry = default_registry if registry is None else registry
    out = []
    with registry._lock:
        metrics = dict(registry._metrics)
    for name, m in sorted(metrics.items()):
        if isinstance(m, Histogram):
            with m._lock:
                keysets = list(m._series.keys())
        else:
            with m._lock:
                keysets = list(m._vals.keys())
        label_keys = {k for key in keysets for k, _v in key}
        bad = label_keys - ALLOWED_LABEL_KEYS
        if bad:
            out.append((name, f"label keys outside the closed "
                              f"vocabulary: {sorted(bad)}"))
        if len(keysets) > max_series:
            out.append((name, f"{len(keysets)} labeled series exceeds "
                              f"the {max_series} cardinality bound"))
    return out


def _labels_key(key: tuple, *names: str) -> str:
    d = dict(key)
    return ":".join(str(d.get(n, "")) for n in names)


def _healthz_doc() -> dict:
    """The ``/healthz`` body: stage liveness from the trace collector,
    supervised units, model versions and their offsets lag, watermarks,
    consumer lag, firing SLO alerts."""
    from . import tracing  # late: tracing imports this module

    stages = tracing.liveness()
    doc = {
        "status": "ok",
        "tracing": tracing.ENABLED,
        # stage -> seconds since its newest span: the stalled stage is
        # the one whose age grows while its upstream stays fresh
        "stages": {s: {"last_span_age_s": age} for s, age in stages.items()},
    }
    # unit states from any live supervisor; late import with a guard: an
    # unsupervised process must not pay for (or fail on) the supervisor
    try:
        from ..supervise import registry as _sup_registry

        units = _sup_registry.snapshot()
        if units:
            doc["supervisor"] = units
            if any(u.get("state") == "degraded" for u in units.values()):
                doc["status"] = "degraded"
    except Exception:  # noqa: BLE001 - the health endpoint stays up
        pass
    with model_version._lock:
        mv = dict(model_version._vals)
    if mv:
        with model_offsets_lag._lock:
            lag = dict(model_offsets_lag._vals)
        doc["model"] = {dict(k).get("component", ""): {
            "version": int(v), "offsets_lag": lag.get(k)}
            for k, v in mv.items()}
    # the replica loss window, and the quorum's durability state: ISR
    # width per partition, the under-replicated count, the tail above
    # the quorum HWM
    with replica_lag._lock:
        lag_vals = dict(replica_lag._vals)
    if lag_vals:
        doc["replica_lag_records"] = {
            dict(k).get("topic", ""): v for k, v in lag_vals.items()}
    with isr_size._lock:
        isr_vals = dict(isr_size._vals)
    if isr_vals:
        with quorum_hwm_lag._lock:
            qlag = dict(quorum_hwm_lag._vals)
        doc["replication"] = {
            "under_replicated_partitions": int(under_replicated.value()),
            "isr": {_labels_key(k, "topic", "partition"): int(v)
                    for k, v in sorted(isr_vals.items())},
            "quorum_hwm_lag_records": {
                _labels_key(k, "topic", "partition"): int(v)
                for k, v in sorted(qlag.items())},
        }
    with watermark_event_ms._lock:
        wm_vals = dict(watermark_event_ms._vals)
    if wm_vals:
        # event timestamps are wall-clock ms: staleness display only
        now_ms = time.time() * 1000.0
        doc["watermarks"] = {}
        for k, v in sorted(wm_vals.items()):
            name = _labels_key(k, "stage", "topic", "partition")
            group = dict(k).get("group")
            if group:
                name += f":{group}"
            doc["watermarks"][name] = {
                "event_time_ms": int(v),
                "lag_s": round(max(now_ms - v, 0.0) / 1000.0, 3)}
    with consumer_lag_records._lock:
        clag_vals = dict(consumer_lag_records._vals)
    if clag_vals:
        doc["consumer_lag_records"] = {
            _labels_key(k, "group", "topic", "partition"): v
            for k, v in sorted(clag_vals.items())}
    # firing burn-rate alerts from any live SloEngine in this process
    try:
        from . import slo as _slo

        firing = _slo.firing_alerts()
        if firing:
            doc["alerts"] = firing
            doc["status"] = "degraded"
    except Exception:  # noqa: BLE001 - the health endpoint stays up
        pass
    epoch = failover_epoch.value()
    if epoch:
        doc["failover_epoch"] = epoch
    return doc


def start_http_server(port: int = 9100, registry: Registry = default_registry):
    """Serve ``/metrics`` (Prometheus text) and ``/healthz`` (JSON) on a
    daemon thread; returns the server (``shutdown()`` then
    ``server_close()`` stop it).  Port 0 binds a free port
    (``server_address[1]``); a port that cannot be bound raises OSError."""
    import http.server
    import json

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path == "/metrics":
                from . import tracing

                tracing.flush()  # spans land in the histograms per scrape
                body = registry.render().encode()
                ctype = "text/plain; version=0.0.4"
            elif self.path == "/healthz":
                body = json.dumps(_healthz_doc(), indent=2,
                                  sort_keys=True).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    from ..supervise.registry import register_thread

    srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
    srv.daemon_threads = True
    register_thread(threading.Thread(
        target=srv.serve_forever, daemon=True,
        name=f"iotml-metrics-{srv.server_address[1]}")).start()
    # federation: the endpoint joins the fleet's manifest when
    # IOTML_OBS_ENDPOINTS names one (and the in-process registry always),
    # so `python -m iotml_torch.obs fleet` finds every process
    try:
        from . import federate, tracing

        name = tracing.proc_name()
        addr = f"127.0.0.1:{srv.server_address[1]}"
        manifest = federate.manifest_path()
        if manifest:
            federate.publish_endpoint(manifest, name, addr)
        else:
            federate.register_local_endpoint(name, addr)
    except Exception:  # noqa: BLE001 - serving must not die on a manifest
        pass           # hiccup (read-only file system, lock contention)
    return srv
