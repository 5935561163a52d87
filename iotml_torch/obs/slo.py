"""Burn-rate SLO engine over the log-native TSDB (``iotml.obs.slo``'s
copy: the same transitions, alert records and burn gauges).

The reference alerts through Prometheus rules + Grafana; this engine is
the framework-native equivalent, evaluated by a supervised unit against
the ``_IOTML_TSDB`` history:

- **declarative rules** (YAML-ish dicts in config): each names an
  objective and an indicator — a ``latency`` indicator over a native
  Histogram family (good = observations under the threshold bucket) or
  a ``ratio`` indicator over two counters (bad / total);
- **multi-window multi-burn-rate alerting** (the SRE-workbook shape):
  the *fast* pair (5 m short + 1 h long, burn >= 14.4) catches an
  outage in minutes, the *slow* pair (30 m short + 6 h long,
  burn >= 6) catches a simmering budget leak; BOTH windows of a pair
  must burn — a short spike alone (fast-short only) never pages;
- **alert transitions append to the compacted ``_IOTML_ALERTS``
  topic** (key = SLO name: the latest state per alert replays from the
  log like every other materialised view), surface in ``/healthz``,
  and export ``iotml_slo_burn_rate{slo=,window=}`` +
  ``iotml_alerts_firing``.

Burn rate = (observed error rate over the window) / (error budget),
error budget = 1 - objective.  Burn 1.0 = exactly on budget; 14.4 on a
99.9 % SLO = the 30-day budget gone in ~2 days.  Counter increases are
reset-corrected by the TSDB layer, so a supervised restart mid-window
reads as a reset, not as negative burn.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from . import metrics as _metrics
from . import tsdb as _tsdb

#: the compacted alert-state changelog (key = SLO name).  One writer
#: family: the obs package, like _IOTML_TSDB.
ALERTS_TOPIC = "_IOTML_ALERTS"

slo_burn_rate = _metrics.default_registry.gauge(
    "iotml_slo_burn_rate",
    "current burn rate per SLO and window pair (1.0 = exactly on "
    "budget; the fast pair pages at 14.4, the slow pair at 6)")
alerts_firing = _metrics.default_registry.gauge(
    "iotml_alerts_firing", "SLO burn-rate alerts currently firing")
slo_evals = _metrics.default_registry.counter(
    "iotml_slo_evaluations_total",
    "SLO rule evaluation passes performed by the engine")
alert_transitions = _metrics.default_registry.counter(
    "iotml_alert_transitions_total",
    "alert state transitions appended to _IOTML_ALERTS, by action "
    "(fire | resolve)")

#: (name, short_ms, long_ms, burn threshold) — the SRE-workbook pairs.
#: A rule's ``window_scale`` multiplies the durations so a drill can
#: compress 5 m/1 h into seconds without changing the alert logic.
DEFAULT_WINDOWS = (
    ("fast", 300_000, 3_600_000, 14.4),
    ("slow", 1_800_000, 21_600_000, 6.0),
)


@dataclass
class SloRule:
    """One declarative SLO: objective + indicator + window pairs."""

    name: str
    objective: float                       # e.g. 0.99
    indicator: dict                        # see from_dict
    windows: Tuple[tuple, ...] = DEFAULT_WINDOWS
    window_scale: float = 1.0

    @classmethod
    def from_dict(cls, doc: dict) -> "SloRule":
        """Validate the YAML-ish rule dict::

            {"name": "e2e-latency", "objective": 0.99,
             "indicator": {"kind": "latency",
                           "metric": "iotml_canary_e2e_seconds",
                           "threshold_s": 0.25,
                           "matchers": {"process": "canary"}},
             "window_scale": 1.0}            # optional

        ``kind: latency`` reads a native Histogram family (good =
        observations <= threshold_s); ``kind: ratio`` reads two
        counters: {"bad": name, "total": name, "matchers": {...}}."""
        name = str(doc.get("name", "")).strip()
        if not name:
            raise ValueError(f"SLO rule without a name: {doc!r}")
        objective = float(doc.get("objective", 0.0))
        if not 0.0 < objective < 1.0:
            raise ValueError(
                f"SLO {name!r}: objective must be in (0, 1), got "
                f"{objective}")
        ind = dict(doc.get("indicator") or {})
        kind = ind.get("kind")
        if kind == "latency":
            if not ind.get("metric"):
                raise ValueError(f"SLO {name!r}: latency indicator "
                                 f"needs a histogram 'metric'")
            float(ind.get("threshold_s", 0.0))
        elif kind == "ratio":
            if not ind.get("bad") or not ind.get("total"):
                raise ValueError(f"SLO {name!r}: ratio indicator needs "
                                 f"'bad' and 'total' counter names")
        else:
            raise ValueError(f"SLO {name!r}: indicator kind must be "
                             f"'latency' or 'ratio', got {kind!r}")
        windows = doc.get("windows")
        if windows is not None:
            windows = tuple(
                (str(w[0]), int(w[1]), int(w[2]), float(w[3]))
                for w in windows)
        return cls(name=name, objective=objective, indicator=ind,
                   windows=windows or DEFAULT_WINDOWS,
                   window_scale=float(doc.get("window_scale", 1.0)))

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective


def _matchers_of(ind_doc: dict, side: str = "") -> List[_tsdb.Matcher]:
    """Equality matchers from the indicator doc; a ratio indicator may
    overlay per-side ones (``bad_matchers`` / ``total_matchers``) on the
    shared ``matchers`` — e.g. bad = outcome="lost" vs total =
    outcome="sent" over the SAME counter family."""
    merged = dict(ind_doc.get("matchers") or {})
    if side:
        merged.update(ind_doc.get(f"{side}_matchers") or {})
    return [_tsdb.Matcher(k, "=", str(v))
            for k, v in sorted(merged.items())]


def _sum_increase(series: Dict[str, dict], name: str, matchers,
                  window_ms: int, at_ms: int) -> float:
    return sum(r["value"] for r in _tsdb.increase(
        series, name, matchers, window_ms=window_ms, at_ms=at_ms))


def _error_rate(rule: SloRule, series: Dict[str, dict],
                window_ms: int, at_ms: int) -> Optional[float]:
    """Observed error fraction over the window, None when the window
    carries no signal (no traffic = no burn, not 100% burn)."""
    ind = rule.indicator
    if ind["kind"] == "ratio":
        total = _sum_increase(series, ind["total"],
                              _matchers_of(ind, "total"),
                              window_ms, at_ms)
        if total <= 0:
            return None
        bad = _sum_increase(series, ind["bad"],
                            _matchers_of(ind, "bad"),
                            window_ms, at_ms)
        return min(max(bad / total, 0.0), 1.0)
    matchers = _matchers_of(ind)
    # latency: good = reset-corrected increase of the cumulative
    # bucket covering the threshold, total = the +Inf bucket
    family = ind["metric"]
    bname = family + "_bucket"
    threshold = float(ind.get("threshold_s", 0.0))
    groups: Dict[tuple, Dict[float, float]] = {}
    for s in _tsdb.select(series, bname, matchers):
        le = s["l"].get("le")
        try:
            edge = float(le)
        except (TypeError, ValueError):
            continue
        inc = _tsdb.increase(
            {_tsdb.series_id(s["n"], s["l"]): s}, bname,
            window_ms=window_ms, at_ms=at_ms)
        if not inc:
            continue
        key = tuple(sorted((k, v) for k, v in s["l"].items()
                           if k != "le"))
        groups.setdefault(key, {})[edge] = \
            groups.get(key, {}).get(edge, 0.0) + inc[0]["value"]
    good = total = 0.0
    for buckets in groups.values():
        edges = sorted(buckets)
        if not edges:
            continue
        total += buckets[edges[-1]]  # +Inf (sorts last)
        covering = [e for e in edges if e >= threshold]
        if covering:
            good += buckets[covering[0]]
    if total <= 0:
        return None
    return min(max(1.0 - good / total, 0.0), 1.0)


@dataclass
class AlertState:
    slo: str
    firing: bool = False
    window: str = ""               # which pair fired ("fast" | "slow")
    burn: Dict[str, float] = field(default_factory=dict)
    since_ms: int = 0
    message: str = ""


#: process-global firing snapshot for /healthz (metrics.start_http_server
#: late-imports this; a process without an SLO engine sees {})
_firing_lock = threading.Lock()
_firing: Dict[str, dict] = {}


def firing_alerts() -> Dict[str, dict]:
    with _firing_lock:
        return dict(_firing)


def _publish_firing(states: Dict[str, AlertState]) -> None:
    with _firing_lock:
        _firing.clear()
        for name, st in states.items():
            if st.firing:
                _firing[name] = {"window": st.window,
                                 "burn": dict(st.burn),
                                 "since_ms": st.since_ms,
                                 "message": st.message}


class SloEngine:
    """Evaluate rules against the TSDB on a cadence; fire/resolve
    alerts; append transitions to the compacted ``_IOTML_ALERTS``
    topic.  Run the ``loop`` body as a supervised unit (the engine is a
    pipeline citizen: it restarts like one, and its own counters reset
    like one — which the TSDB's rate() must read as a reset)."""

    def __init__(self, broker, rules: Iterable[dict],
                 interval_s: float = 2.0, partition: int = 0,
                 lookback_ms: Optional[int] = None):
        self.broker = broker
        self.rules = [r if isinstance(r, SloRule) else
                      SloRule.from_dict(r) for r in rules]
        self.interval_s = interval_s
        self.partition = partition
        # replay horizon: the longest scaled window, plus slack for the
        # chunk the horizon lands inside
        if lookback_ms is None and self.rules:
            lookback_ms = int(max(
                w[2] * r.window_scale
                for r in self.rules for w in r.windows)
                + 2 * _tsdb.DEFAULT_CHUNK_MS)
        self.lookback_ms = lookback_ms or 3_600_000
        self.states: Dict[str, AlertState] = {
            r.name: AlertState(slo=r.name) for r in self.rules}
        # incremental TSDB reader: a cadenced evaluator must not replay
        # the whole (growing) topic per pass — the tail decodes only
        # new records, bounded to the indicator families + lookback
        self._tail = _tsdb.TsdbTail(
            broker, partition=partition,
            names=self._indicator_families(), lookback_ms=self.lookback_ms)
        broker.create_topic(ALERTS_TOPIC, cleanup_policy="compact")

    def _indicator_families(self) -> set:
        """The metric families the rules actually read — the tail skips
        everything else at decode time."""
        names = set()
        for r in self.rules:
            ind = r.indicator
            if ind["kind"] == "latency":
                names.add(ind["metric"] + "_bucket")
            else:
                names.add(ind["bad"])
                names.add(ind["total"])
        return names

    # ---------------------------------------------------------- evaluate
    def evaluate(self, series: Optional[Dict[str, dict]] = None,
                 now_ms: Optional[int] = None) -> List[dict]:
        """One evaluation pass; returns the transition docs appended to
        _IOTML_ALERTS (empty when no alert changed state)."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)  # wallclock-ok: sample
            # timestamps live in the wall/event-time domain
        if series is None:
            series = self._tail.collect(now_ms)
        slo_evals.inc()
        transitions: List[dict] = []
        for rule in self.rules:
            st = self.states[rule.name]
            burns: Dict[str, float] = {}
            fired_pair = ""
            for wname, short_ms, long_ms, threshold in rule.windows:
                pair_burn = None
                pair_ok = True
                for leg, wms in (("short", short_ms), ("long", long_ms)):
                    wms = int(wms * rule.window_scale)
                    err = _error_rate(rule, series, wms, now_ms)
                    burn = (err / rule.error_budget) \
                        if err is not None else 0.0
                    if leg == "short":
                        pair_burn = burn
                    if err is None or burn < threshold:
                        pair_ok = False
                burns[wname] = pair_burn or 0.0
                if pair_ok and not fired_pair:
                    fired_pair = wname
            st.burn = burns
            for wname, burn in burns.items():
                slo_burn_rate.set(burn, slo=rule.name, window=wname)
            if fired_pair and not st.firing:
                st.firing = True
                st.window = fired_pair
                st.since_ms = now_ms
                st.message = (
                    f"SLO {rule.name}: {fired_pair} burn-rate pair over "
                    f"threshold (burn={burns[fired_pair]:.1f}, "
                    f"objective={rule.objective})")
                transitions.append(self._transition(rule, st, "fire",
                                                    now_ms))
            elif not fired_pair and st.firing:
                st.firing = False
                st.message = f"SLO {rule.name}: burn back under threshold"
                transitions.append(self._transition(rule, st, "resolve",
                                                    now_ms))
                st.window = ""
        alerts_firing.set(sum(1 for s in self.states.values()
                              if s.firing))
        _publish_firing(self.states)
        if transitions:
            self._append(transitions)
        return transitions

    def _transition(self, rule: SloRule, st: AlertState, action: str,
                    now_ms: int) -> dict:
        alert_transitions.inc(action=action)
        return {"slo": rule.name, "action": action, "ts_ms": now_ms,
                "window": st.window, "burn": dict(st.burn),
                "objective": rule.objective, "firing": st.firing,
                "message": st.message}

    def _append(self, transitions: List[dict]) -> None:
        entries = [(t["slo"].encode(),
                    json.dumps(t, sort_keys=True).encode(), t["ts_ms"])
                   for t in transitions]
        produce_many = getattr(self.broker, "produce_many", None)
        try:
            if produce_many is not None:
                produce_many(ALERTS_TOPIC, entries,
                             partition=self.partition)
            else:
                for k, v, _ts in entries:
                    self.broker.produce(ALERTS_TOPIC, v, key=k,
                                        partition=self.partition)
        except (ConnectionError, OSError):
            pass  # broker down: /healthz + gauges still carry the alert

    # ------------------------------------------------------- unit body
    def loop(self, unit) -> None:
        """SupervisedUnit body: evaluate on the cadence, heartbeat per
        pass (``sup.add_loop("slo-engine", engine.loop)``)."""
        while not unit.should_stop():
            try:
                self.evaluate()
            except (ConnectionError, OSError):
                pass  # broker hiccup: next pass re-reads
            unit.heartbeat()
            time.sleep(self.interval_s)


def read_alerts(broker, partition: int = 0) -> Dict[str, dict]:
    """Latest alert state per SLO, replayed from the compacted
    _IOTML_ALERTS changelog (the dashboard/CLI cold-start read)."""
    if ALERTS_TOPIC not in broker.topics():
        return {}
    out: Dict[str, dict] = {}
    off = broker.begin_offset(ALERTS_TOPIC, partition)
    end = broker.end_offset(ALERTS_TOPIC, partition)
    while off < end:
        batch = broker.fetch(ALERTS_TOPIC, partition, off, 4096)
        if not batch:
            break
        for m in batch:
            off = m.offset + 1
            if m.key is None:
                continue
            if m.value is None:
                out.pop(m.key.decode(), None)
                continue
            try:
                out[m.key.decode()] = json.loads(m.value)
            except ValueError:
                continue
    return out
