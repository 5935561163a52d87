"""Log-native TSDB — the platform's telemetry stored in its own log
(``iotml.obs.tsdb``'s copy: the same keys, values and query answers).

The reference ships a whole Prometheus beside the pipeline; the
federation layer scrapes the fleet but compacts only the *latest*
snapshot into ``_IOTML_METRICS`` — no history, no query surface.  This
module closes that gap by dogfooding the store plane as the metrics
backend: every federated scrape appends its samples to a compacted
``_IOTML_TSDB`` topic, and a query engine replays the segment read path
to answer instant/range queries, ``rate()`` and
``histogram_quantile()`` — the telemetry feedback loop ROADMAP item 5
(self-tuning data plane) needs.

Frame layout (ARCHITECTURE §26): one record per (series, chunk window).

- **key** = ``<series id>@<window start ms>`` where the series id is
  the metric name plus its sorted ``k=v`` label pairs — per-series
  keying, so latest-per-key compaction bounds the topic at one record
  per live series per window inside retention (StorePolicy's
  ``retention_ms`` expires whole old windows).
- **value** = JSON ``{"n": name, "l": labels, "t": [t0, dt...],
  "v": [v...]}`` with timestamps delta-encoded against the chunk's
  first sample (scrape cadences are near-constant, so deltas are
  small ints) and raw float values.

Each scrape RE-APPENDS the current window's whole chunk for every
series it touched; compaction keeps only the newest (= most complete)
copy, so the log converges to exactly one record per window without
any read-modify-write on the read path.

``rate()`` detects counter resets (a supervised restart zeroes its
process's counters): a sample below its predecessor contributes its
absolute value as the delta — a reset reads as a reset, never as a
negative rate — and each detection counts into
``iotml_tsdb_resets_total``.
"""

from __future__ import annotations

import json
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import metrics as _metrics

#: the compacted telemetry log (key = series id + chunk window), with
#: ONE writer family: the obs package.
TSDB_TOPIC = "_IOTML_TSDB"

#: default chunk window: one record per series per minute under
#: compaction — 60 samples at a 1 s scrape cadence per chunk
DEFAULT_CHUNK_MS = 60_000

#: instant-query lookback: how far behind ``at`` the newest sample may
#: sit and still answer the query (Prometheus's 5 m staleness bound)
DEFAULT_LOOKBACK_MS = 300_000

tsdb_appends = _metrics.default_registry.counter(
    "iotml_tsdb_appends_total",
    "sample-chunk records appended to the _IOTML_TSDB topic")
tsdb_samples = _metrics.default_registry.counter(
    "iotml_tsdb_samples_total",
    "individual samples ingested into the TSDB appender")
tsdb_resets = _metrics.default_registry.counter(
    "iotml_tsdb_resets_total",
    "counter resets detected by rate() (a restarted process's counter "
    "re-starting below its predecessor sample)")
tsdb_series_live = _metrics.default_registry.gauge(
    "iotml_tsdb_series",
    "distinct series the TSDB appender is currently chunking")


# ------------------------------------------------------------- series id
def series_id(name: str, labels: Optional[dict]) -> str:
    """Canonical series identity: name + sorted ``k=v`` pairs.  The
    chunk key prefix, and the dedup identity everywhere."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


# ------------------------------------------------------------- appender
class TsdbAppender:
    """Accumulate scrape samples into per-(series, window) chunks and
    append them to the compacted ``_IOTML_TSDB`` topic.

    Thread-safe; holds only the CURRENT window's chunk per series in
    memory (prior windows are already fully on the log — the last
    append of a window carried every sample it will ever have)."""

    def __init__(self, broker, chunk_ms: int = DEFAULT_CHUNK_MS,
                 retention_ms: Optional[int] = None, partition: int = 0):
        self.broker = broker
        self.chunk_ms = int(chunk_ms)
        self.partition = partition
        self._chunks: Dict[str, dict] = {}
        self._lock = threading.Lock()
        kw = {"cleanup_policy": "compact"}
        if retention_ms is not None:
            # explicit override; otherwise the broker's StorePolicy
            # (IOTML_STORE_* env) governs retention like any topic
            kw["retention_ms"] = int(retention_ms)
        broker.create_topic(TSDB_TOPIC, **kw)

    def append(self, samples: Iterable[tuple],
               ts_ms: Optional[int] = None,
               process: Optional[str] = None) -> int:
        """Ingest one scrape's ``(name, labels, value)`` samples stamped
        at ``ts_ms`` and append the touched chunks; returns the number
        of chunk records produced.  ``process`` is merged into every
        sample's labels (the federation relabel, applied at WRITE time
        so the stored series carry their origin)."""
        if ts_ms is None:
            ts_ms = int(time.time() * 1000)  # wallclock-ok: sample
            # timestamps live in the wall/event-time domain
        window = (ts_ms // self.chunk_ms) * self.chunk_ms
        touched: Dict[str, dict] = {}
        n_samples = 0
        with self._lock:
            for name, labels, value in samples:
                labels = dict(labels or {})
                if process is not None:
                    labels["process"] = process
                sid = series_id(name, labels)
                chunk = self._chunks.get(sid)
                if chunk is None or chunk["w"] != window:
                    # window rollover: the previous window's final copy
                    # is already on the log from its last append
                    chunk = self._chunks[sid] = {
                        "w": window, "n": name, "l": labels,
                        "t": [], "v": []}
                prev_abs = chunk["t"][0] + sum(chunk["t"][1:]) \
                    if chunk["t"] else None
                if prev_abs is not None and ts_ms == prev_abs:
                    # same stamp for this series (two samples in one
                    # scrape pass): last write wins
                    chunk["v"][-1] = float(value)
                elif prev_abs is not None and ts_ms < prev_abs:
                    continue  # out-of-order within a chunk: drop
                else:
                    chunk["t"].append(
                        ts_ms if prev_abs is None else ts_ms - prev_abs)
                    chunk["v"].append(float(value))
                touched[f"{sid}@{chunk['w']}"] = chunk
                n_samples += 1
            # prune series that stopped reporting: anything still
            # parked on a window older than the previous one is dead
            # weight (its final chunk is durable on the log)
            stale = [sid for sid, c in self._chunks.items()
                     if c["w"] < window - self.chunk_ms]
            for sid in stale:
                del self._chunks[sid]
            tsdb_series_live.set(len(self._chunks))
            entries = [
                (key.encode(),
                 json.dumps({"n": c["n"], "l": c["l"],
                             "t": c["t"], "v": c["v"]},
                            sort_keys=True).encode(),
                 ts_ms)
                for key, c in sorted(touched.items())]
        if not entries:
            return 0
        produce_many = getattr(self.broker, "produce_many", None)
        if produce_many is not None:
            produce_many(TSDB_TOPIC, entries, partition=self.partition)
        else:
            for k, v, _ts in entries:
                self.broker.produce(TSDB_TOPIC, v, key=k,
                                    partition=self.partition)
        tsdb_appends.inc(len(entries))
        tsdb_samples.inc(n_samples)
        return len(entries)


# ------------------------------------------------------------- read path
def read_series(broker, start_ms: Optional[int] = None,
                end_ms: Optional[int] = None,
                partition: int = 0) -> Dict[str, dict]:
    """Replay the compacted TSDB topic into
    ``{series id: {"n": name, "l": labels, "samples": [(ts, v)...]}}``
    (samples ascending, deduped — a window re-appended by successive
    scrapes keeps only its newest copy, compaction or not)."""
    out: Dict[str, dict] = {}
    if TSDB_TOPIC not in broker.topics():
        return out
    chunks: Dict[str, dict] = {}  # chunk key → latest doc (log order)
    off = broker.begin_offset(TSDB_TOPIC, partition)
    end = broker.end_offset(TSDB_TOPIC, partition)
    while off < end:
        batch = broker.fetch(TSDB_TOPIC, partition, off, 4096)
        if not batch:
            break
        for m in batch:
            off = m.offset + 1
            if m.key is None:
                continue
            if m.value is None:
                chunks.pop(m.key.decode(), None)  # tombstoned series
                continue
            try:
                chunks[m.key.decode()] = json.loads(m.value)
            except ValueError:
                continue
    return _materialize(chunks, start_ms=start_ms, end_ms=end_ms)


def _materialize(chunks: Dict[str, dict],
                 start_ms: Optional[int] = None,
                 end_ms: Optional[int] = None) -> Dict[str, dict]:
    """Latest chunk docs (key -> doc) into the query-engine series
    shape, decoding the timestamp deltas and applying the time bounds."""
    out: Dict[str, dict] = {}
    for key, doc in chunks.items():
        sid, _, wstr = key.rpartition("@")
        try:
            window = int(wstr)
        except ValueError:
            continue
        if end_ms is not None and window > end_ms:
            continue
        series = out.setdefault(sid, {"n": doc.get("n", ""),
                                      "l": doc.get("l", {}),
                                      "samples": []})
        ts = 0
        for i, (dt, v) in enumerate(zip(doc.get("t", ()),
                                        doc.get("v", ()))):
            ts = dt if i == 0 else ts + dt
            if start_ms is not None and ts < start_ms:
                continue
            if end_ms is not None and ts > end_ms:
                continue
            series["samples"].append((ts, float(v)))
    for series in out.values():
        series["samples"].sort()
    return {sid: s for sid, s in out.items() if s["samples"]}


class TsdbTail:
    """Incremental follower over the TSDB topic for hot-loop readers
    (the SLO engine evaluates every few hundred ms).

    ``read_series`` replays the WHOLE topic per call — fine for a CLI
    query, quadratic for a cadenced evaluator on a growing log.  The
    tail keeps a cursor and a latest-doc-per-chunk-key cache instead:
    the first ``collect`` pays one full replay, every later one decodes
    only the records appended since.  The cache stays bounded by
    dropping chunks whose newest sample fell behind the lookback
    horizon, and (optionally) by a closed set of metric family
    ``names`` — an SLO engine needs its indicators' few families, not
    the fleet's whole registry."""

    def __init__(self, broker, partition: int = 0,
                 names: Optional[Iterable[str]] = None,
                 lookback_ms: Optional[int] = None):
        self.broker = broker
        self.partition = partition
        self.names = frozenset(names) if names is not None else None
        self.lookback_ms = lookback_ms
        self._off: Optional[int] = None
        #: chunk key -> (doc, newest absolute sample ts)
        self._chunks: Dict[str, tuple] = {}

    def collect(self, now_ms: Optional[int] = None) -> Dict[str, dict]:
        """Drain new TSDB records into the cache; return the series
        dict over the lookback horizon (``read_series`` shape)."""
        if now_ms is None:
            now_ms = int(time.time() * 1000)  # wallclock-ok: sample
            # timestamps live in the wall/event-time domain
        if TSDB_TOPIC not in self.broker.topics():
            return {}
        begin = self.broker.begin_offset(TSDB_TOPIC, self.partition)
        if self._off is None or self._off < begin:
            self._off = begin  # first read, or retention expired past us
        end = self.broker.end_offset(TSDB_TOPIC, self.partition)
        while self._off < end:
            batch = self.broker.fetch(TSDB_TOPIC, self.partition,
                                      self._off, 4096)
            if not batch:
                break
            for m in batch:
                self._off = m.offset + 1
                if m.key is None:
                    continue
                key = m.key.decode()
                if m.value is None:
                    self._chunks.pop(key, None)  # tombstoned series
                    continue
                try:
                    doc = json.loads(m.value)
                except ValueError:
                    continue
                if self.names is not None \
                        and doc.get("n") not in self.names:
                    continue
                ts = doc.get("t") or ()
                self._chunks[key] = (doc, ts[0] + sum(ts[1:]) if ts
                                     else 0)
        start_ms = None
        if self.lookback_ms is not None:
            start_ms = now_ms - self.lookback_ms
            dead = [k for k, (_d, last) in self._chunks.items()
                    if last < start_ms]
            for k in dead:
                del self._chunks[k]
        return _materialize({k: d for k, (d, _last)
                             in self._chunks.items()},
                            start_ms=start_ms)


# ------------------------------------------------------------- matchers
class Matcher:
    """One label matcher: ``=``, ``!=``, ``=~``, ``!~`` (anchored
    regex, Prometheus semantics)."""

    __slots__ = ("key", "op", "value", "_re")

    def __init__(self, key: str, op: str, value: str):
        if op not in ("=", "!=", "=~", "!~"):
            raise ValueError(f"unknown matcher op {op!r}")
        self.key, self.op, self.value = key, op, value
        self._re = re.compile(value + r"\Z") if op in ("=~", "!~") \
            else None

    def match(self, labels: dict) -> bool:
        got = str(labels.get(self.key, ""))
        if self.op == "=":
            return got == self.value
        if self.op == "!=":
            return got != self.value
        hit = self._re.match(got) is not None
        return hit if self.op == "=~" else not hit

    def __repr__(self):
        return f"{self.key}{self.op}\"{self.value}\""


_SELECTOR_RE = re.compile(
    r"\s*(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)\s*"
    r"(?:\{(?P<labels>[^}]*)\})?\s*"
    r"(?:\[(?P<window>[0-9]+(?:\.[0-9]+)?[smhd])\])?\s*\Z")
_MATCHER_RE = re.compile(
    r'\s*(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)\s*(?P<op>=~|!~|!=|=)\s*'
    r'"(?P<val>(?:[^"\\]|\\.)*)"\s*(?:,|\Z)')
_DUR = {"s": 1_000, "m": 60_000, "h": 3_600_000, "d": 86_400_000}


def parse_duration_ms(text: str) -> int:
    m = re.match(r"([0-9]+(?:\.[0-9]+)?)([smhd])\Z", text.strip())
    if not m:
        raise ValueError(f"bad duration {text!r} (want e.g. 30s, 5m, 1h)")
    return int(float(m.group(1)) * _DUR[m.group(2)])


def _unescape(text: str) -> str:
    return (text.replace("\\\\", "\x00").replace('\\"', '"')
            .replace("\\n", "\n").replace("\x00", "\\"))


def parse_selector(text: str) -> Tuple[str, List[Matcher], Optional[int]]:
    """``name{k="v",k2=~"re"}[5m]`` → (name, matchers, window_ms)."""
    m = _SELECTOR_RE.match(text)
    if not m:
        raise ValueError(f"bad selector {text!r}")
    matchers: List[Matcher] = []
    lab = m.group("labels")
    if lab:
        pos = 0
        while pos < len(lab.strip()):
            mm = _MATCHER_RE.match(lab, pos)
            if not mm:
                raise ValueError(f"bad matcher in {text!r} at {lab[pos:]!r}")
            matchers.append(Matcher(mm.group("key"), mm.group("op"),
                                    _unescape(mm.group("val"))))
            pos = mm.end()
    window = m.group("window")
    return (m.group("name"), matchers,
            parse_duration_ms(window) if window else None)


def select(series: Dict[str, dict], name: str,
           matchers: Sequence[Matcher] = ()) -> List[dict]:
    """Series whose metric name equals ``name`` and whose labels pass
    every matcher."""
    out = []
    for s in series.values():
        if s["n"] != name:
            continue
        if all(m.match(s["l"]) for m in matchers):
            out.append(s)
    return sorted(out, key=lambda s: sorted(s["l"].items()))


# --------------------------------------------------------------- queries
def instant(series: Dict[str, dict], name: str,
            matchers: Sequence[Matcher] = (),
            at_ms: Optional[int] = None,
            lookback_ms: int = DEFAULT_LOOKBACK_MS) -> List[dict]:
    """Newest sample per matching series at (or before) ``at_ms``,
    within the staleness lookback: ``[{labels, ts_ms, value}]``."""
    out = []
    for s in select(series, name, matchers):
        best = None
        for ts, v in s["samples"]:
            if at_ms is not None and ts > at_ms:
                break
            best = (ts, v)
        if best is None:
            continue
        if at_ms is not None and best[0] < at_ms - lookback_ms:
            continue
        out.append({"labels": s["l"], "ts_ms": best[0],
                    "value": best[1]})
    return out


def range_query(series: Dict[str, dict], name: str,
                matchers: Sequence[Matcher] = (),
                start_ms: int = 0, end_ms: int = 0,
                step_ms: int = 15_000,
                lookback_ms: int = DEFAULT_LOOKBACK_MS) -> List[dict]:
    """Evaluate the instant query at every step across [start, end]:
    ``[{labels, values: [(ts_ms, value)...]}]`` (staleness-bounded
    last-observed carry, Prometheus range semantics)."""
    step_ms = max(int(step_ms), 1)
    out = []
    for s in select(series, name, matchers):
        pts = []
        i = 0
        samples = s["samples"]
        last = None
        t = start_ms
        while t <= end_ms:
            while i < len(samples) and samples[i][0] <= t:
                last = samples[i]
                i += 1
            if last is not None and last[0] >= t - lookback_ms:
                pts.append((t, last[1]))
            t += step_ms
        if pts:
            out.append({"labels": s["l"], "values": pts})
    return out


def _reset_corrected_increase(samples: List[tuple]) -> Tuple[float, int]:
    """Total counter increase over ascending samples with reset
    correction: a drop means the process restarted and the counter
    re-started from (near) zero, so the post-reset absolute value IS
    the delta.  Returns (increase, resets_detected)."""
    inc = 0.0
    resets = 0
    for (t0, v0), (t1, v1) in zip(samples, samples[1:]):
        if v1 >= v0:
            inc += v1 - v0
        else:
            resets += 1
            inc += v1
    return inc, resets


def rate(series: Dict[str, dict], name: str,
         matchers: Sequence[Matcher] = (),
         window_ms: int = 300_000,
         at_ms: Optional[int] = None) -> List[dict]:
    """Per-second rate of a counter over the trailing window, with
    counter-reset detection (never negative): ``[{labels, value,
    resets}]``.  Detected resets count into iotml_tsdb_resets_total."""
    out = []
    for s in select(series, name, matchers):
        hi = at_ms if at_ms is not None \
            else (s["samples"][-1][0] if s["samples"] else 0)
        lo = hi - window_ms
        win = [(t, v) for t, v in s["samples"] if lo <= t <= hi]
        if len(win) < 2:
            continue
        inc, resets = _reset_corrected_increase(win)
        if resets:
            tsdb_resets.inc(resets)
        span_s = (win[-1][0] - win[0][0]) / 1000.0
        if span_s <= 0:
            continue
        out.append({"labels": s["l"], "value": inc / span_s,
                    "resets": resets})
    return out


def increase(series: Dict[str, dict], name: str,
             matchers: Sequence[Matcher] = (),
             window_ms: int = 300_000,
             at_ms: Optional[int] = None) -> List[dict]:
    """Reset-corrected total increase over the trailing window —
    ``rate() * span`` without the division; what burn-rate ratios
    consume (``[{labels, value, resets}]``)."""
    out = []
    for s in select(series, name, matchers):
        hi = at_ms if at_ms is not None \
            else (s["samples"][-1][0] if s["samples"] else 0)
        lo = hi - window_ms
        win = [(t, v) for t, v in s["samples"] if lo <= t <= hi]
        if not win:
            continue
        if len(win) == 1:
            # one sample inside the window: the increase since the
            # window opened is unknowable; treat as zero (conservative)
            out.append({"labels": s["l"], "value": 0.0, "resets": 0})
            continue
        inc, resets = _reset_corrected_increase(win)
        if resets:
            tsdb_resets.inc(resets)
        out.append({"labels": s["l"], "value": inc, "resets": resets})
    return out


def histogram_quantile(series: Dict[str, dict], q: float, family: str,
                       matchers: Sequence[Matcher] = (),
                       at_ms: Optional[int] = None,
                       window_ms: Optional[int] = None) -> List[dict]:
    """Prometheus-style quantile interpolation from a native Histogram's
    cumulative ``<family>_bucket{le=...}`` series.

    ``window_ms`` set: quantile of the OBSERVATIONS INSIDE the window
    (bucket counts as reset-corrected increases — the burn-rate /
    drill shape).  Unset: quantile of the all-time cumulative counts
    at ``at_ms``.  Grouped by the non-``le`` label sets:
    ``[{labels, value}]``; linear interpolation inside the winning
    bucket, so the answer is exact to bucket width."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    bname = family if family.endswith("_bucket") else family + "_bucket"
    groups: Dict[tuple, List[Tuple[float, float]]] = {}
    for s in select(series, bname, matchers):
        le = s["l"].get("le")
        if le is None:
            continue
        try:
            edge = float(le)
        except ValueError:
            continue
        if window_ms is not None:
            res = increase({series_id(s["n"], s["l"]): s}, bname,
                           window_ms=window_ms, at_ms=at_ms)
            if not res:
                continue
            count = res[0]["value"]
        else:
            snap = instant({series_id(s["n"], s["l"]): s}, bname,
                           at_ms=at_ms)
            if not snap:
                continue
            count = snap[0]["value"]
        key = tuple(sorted((k, v) for k, v in s["l"].items()
                           if k != "le"))
        groups.setdefault(key, []).append((edge, count))
    out = []
    for key, buckets in sorted(groups.items()):
        buckets.sort()
        if not buckets:
            continue
        total = buckets[-1][1]  # +Inf bucket is the observation count
        if total <= 0:
            continue
        rank = q * total
        value = None
        prev_edge, prev_count = 0.0, 0.0
        for edge, count in buckets:
            if count >= rank:
                if edge == float("inf"):
                    # quantile lands in the overflow bucket: the best
                    # honest answer is the highest finite edge
                    value = prev_edge
                else:
                    span = count - prev_count
                    frac = (rank - prev_count) / span if span > 0 else 0.0
                    value = prev_edge + (edge - prev_edge) * frac
                break
            prev_edge, prev_count = edge, count
        if value is not None:
            out.append({"labels": dict(key), "value": value})
    return out


# --------------------------------------------------------- expression API
_FUNC_RE = re.compile(
    r"\s*(?P<fn>rate|increase)\s*\(\s*(?P<sel>[^()]+)\s*\)\s*\Z")
_QUANTILE_RE = re.compile(
    r"\s*histogram_quantile\s*\(\s*(?P<q>[0-9.]+)\s*,"
    r"\s*(?P<sel>[^()]+)\s*\)\s*\Z")


def query(series: Dict[str, dict], expr: str,
          at_ms: Optional[int] = None,
          start_ms: Optional[int] = None, end_ms: Optional[int] = None,
          step_ms: int = 15_000) -> List[dict]:
    """The one expression entry point the REST surface and the CLI
    share.  Supported forms::

        metric{label="v",other=~"regex"}
        rate(metric_total{...}[5m])
        increase(metric_total{...}[5m])
        histogram_quantile(0.95, metric_seconds{...})
        histogram_quantile(0.95, metric_seconds{...}[5m])

    Instant evaluation unless BOTH start_ms and end_ms are given, in
    which case the plain-selector form evaluates as a range query and
    the function forms evaluate at every step."""
    ranged = start_ms is not None and end_ms is not None
    qm = _QUANTILE_RE.match(expr)
    if qm:
        name, matchers, window = parse_selector(qm.group("sel"))
        if name.endswith("_bucket"):
            name = name[:-len("_bucket")]
        qv = float(qm.group("q"))
        if not ranged:
            return histogram_quantile(series, qv, name, matchers,
                                      at_ms=at_ms, window_ms=window)
        return _stepped(lambda t: histogram_quantile(
            series, qv, name, matchers, at_ms=t, window_ms=window),
            start_ms, end_ms, step_ms)
    fm = _FUNC_RE.match(expr)
    if fm:
        name, matchers, window = parse_selector(fm.group("sel"))
        if window is None:
            raise ValueError(
                f"{fm.group('fn')}() needs a [window], e.g. "
                f"{fm.group('fn')}({name}[5m])")
        fn = rate if fm.group("fn") == "rate" else increase
        if not ranged:
            return fn(series, name, matchers, window_ms=window,
                      at_ms=at_ms)
        return _stepped(lambda t: fn(series, name, matchers,
                                     window_ms=window, at_ms=t),
                        start_ms, end_ms, step_ms)
    name, matchers, window = parse_selector(expr)
    if window is not None:
        raise ValueError("a bare selector takes no [window] — use "
                         "rate()/increase(), or query_range")
    if not ranged:
        return instant(series, name, matchers, at_ms=at_ms)
    return range_query(series, name, matchers, start_ms=start_ms,
                       end_ms=end_ms, step_ms=step_ms)


def _stepped(evaluate, start_ms: int, end_ms: int,
             step_ms: int) -> List[dict]:
    """Evaluate an instant function at every step; regroup per label
    set into range-shaped ``[{labels, values}]``."""
    step_ms = max(int(step_ms), 1)
    acc: Dict[tuple, List[tuple]] = {}
    labels_of: Dict[tuple, dict] = {}
    t = start_ms
    while t <= end_ms:
        for r in evaluate(t):
            key = tuple(sorted(r["labels"].items()))
            labels_of[key] = r["labels"]
            acc.setdefault(key, []).append((t, r["value"]))
        t += step_ms
    return [{"labels": labels_of[k], "values": v}
            for k, v in sorted(acc.items())]
