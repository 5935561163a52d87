"""Cluster metrics federation — one merged view of a fleet of processes
(``iotml.obs.federate``'s copy: the same manifest, merged text and
roll-ups).

The reference operates through ONE Prometheus that scrapes every pod
(SURVEY §5); the obs layer serves per process while the system runs as
many — a trainer, scorers, an MQTT front, supervised children — each
serving its own /metrics that nobody aggregates.  This module is the
missing collector:

- an **endpoints manifest** (JSON, atomically rewritten) that every
  process publishes its metrics address into at startup (the file twin
  of the supervise ``Topology``: the supervisor publishes leadership,
  processes publish observability endpoints) — also mirrored into the
  in-process ``supervise.registry`` so a single-process deployment
  needs no file at all;
- a **FleetCollector** that scrapes every manifest endpoint, re-labels
  every sample with ``process=<name>`` (Prometheus federation shape)
  and synthesizes cluster-level series: ``iotml_cluster_up``,
  counter sums (records consumed/scored/trained fleet-wide), consumer-
  group lag rollups summed over partitions and processes, replica-lag
  and watermark-lag worst-of;
- a **FleetServer** (``python -m iotml_torch.obs fleet``) serving the merged
  ``/metrics`` + ``/healthz`` on one port, scraping on a cadence;
- a compacted ``_IOTML_METRICS`` **changelog**: each scrape snapshots
  per-process fleet state keyed by process name, so dashboards replay
  cluster history from the log like everything else (latest-per-key
  compaction bounds it at ~one record per process).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from . import metrics as _metrics

#: the compacted fleet-state changelog (key = process name), with ONE
#: writer family: federation collectors.
METRICS_TOPIC = "_IOTML_METRICS"

federation_scrapes = _metrics.default_registry.counter(
    "iotml_federation_scrapes_total",
    "endpoint scrapes performed by the federation collector")
federation_scrape_errors = _metrics.default_registry.counter(
    "iotml_federation_scrape_errors_total",
    "endpoint scrapes that failed (process down/unreachable)")
federation_snapshots = _metrics.default_registry.counter(
    "iotml_federation_snapshots_total",
    "fleet-state snapshots appended to the _IOTML_METRICS changelog")


# -------------------------------------------------- endpoints manifest
def manifest_path(env: Optional[dict] = None) -> Optional[str]:
    """The fleet's endpoints manifest path (IOTML_OBS_ENDPOINTS), None
    when federation is not configured for this process."""
    env = os.environ if env is None else env
    return env.get("IOTML_OBS_ENDPOINTS") or None


def load_manifest(path: str) -> List[dict]:
    """[{name, address}] from the manifest; [] when absent/torn (a
    half-written manifest must degrade to 'scrape nothing yet', never
    crash the collector)."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return []
    out = []
    for e in doc if isinstance(doc, list) else []:
        if isinstance(e, dict) and e.get("name") and e.get("address"):
            out.append({"name": str(e["name"]),
                        "address": str(e["address"])})
    return out


def publish_endpoint(path: str, name: str, address: str) -> None:
    """Register (name, address) in the manifest — read-modify-write
    under an fcntl lock, atomic rename, replace-by-name (a restarted
    process re-publishes its new port under its old name).  Also
    mirrored into the in-process supervise registry so same-process
    collectors need no file."""
    register_local_endpoint(name, address)
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    import fcntl

    with open(lock_path, "a+") as lk:
        fcntl.lockf(lk, fcntl.LOCK_EX)
        try:
            entries = [e for e in load_manifest(path)
                       if e["name"] != name]
            entries.append({"name": name, "address": address})
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(sorted(entries, key=lambda e: e["name"]), fh,
                          indent=2)
            os.replace(tmp, path)
        finally:
            fcntl.lockf(lk, fcntl.LOCK_UN)


#: in-process endpoint registry — the Topology-style cell for
#: single-process fleets (cli.up runs broker+scorer+trainer in one
#: process: one /metrics, but drills register logical roles too)
_local_endpoints: Dict[str, str] = {}
_local_lock = threading.Lock()


def register_local_endpoint(name: str, address: str) -> None:
    with _local_lock:
        _local_endpoints[name] = address


def local_endpoints() -> List[dict]:
    with _local_lock:
        return [{"name": n, "address": a}
                for n, a in sorted(_local_endpoints.items())]


# ------------------------------------------------ prometheus text parse
def parse_prom_text(text: str) -> Tuple[Dict[str, str], List[tuple]]:
    """Prometheus text exposition → ({family: type}, [(name, labels,
    value)]).  Tolerant: unparsable lines are skipped (a scrape must
    merge what it can, not die on one odd line)."""
    types: Dict[str, str] = {}
    samples: List[tuple] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        try:
            name, labels, value = _parse_sample(line)
        except ValueError:
            continue
        samples.append((name, labels, value))
    return types, samples


def _parse_sample(line: str) -> tuple:
    if "{" in line:
        name, rest = line.split("{", 1)
        # the value follows the LAST close brace; a `}` INSIDE a quoted
        # label value cannot be last (escape-aware label parsing below
        # rejects a truncated pair, so a mis-split fails loudly instead
        # of yielding a corrupt sample)
        lab_str, brace, val_str = rest.rpartition("}")
        if not brace:
            raise ValueError(line)  # `{` without `}` — truncated line
        labels = _parse_labels(lab_str)
    else:
        parts = line.split(None, 1)  # any whitespace run separates
        if len(parts) != 2:
            raise ValueError(line)
        name, val_str = parts
        labels = {}
    val_str = val_str.strip()
    if not val_str:
        raise ValueError(line)
    # optional trailing timestamp (Prometheus exposition): value is the
    # first field.  float() covers NaN / +Inf / -Inf spellings.
    return name.strip(), labels, float(val_str.split()[0])


#: exposition escape sequences (the render-side _escape_label_value
#: inverse): backslash, double-quote, line feed.  Unknown escapes pass
#: the escaped character through (OpenMetrics's lenient reading).
_LABEL_ESCAPES = {"n": "\n", "\\": "\\", '"': '"'}


def _parse_labels(lab_str: str) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    i, n = 0, len(lab_str)
    while i < n:
        eq = lab_str.find("=", i)
        if eq < 0:
            if lab_str[i:].strip(", \t"):
                raise ValueError(lab_str)  # trailing garbage, not a pair
            break
        key = lab_str[i:eq].strip().lstrip(",").strip()
        if not key:
            raise ValueError(lab_str)
        if eq + 1 >= n or lab_str[eq + 1] != '"':
            raise ValueError(lab_str)
        j = eq + 2
        out = []
        closed = False
        while j < n:
            c = lab_str[j]
            if c == "\\" and j + 1 < n:
                nxt = lab_str[j + 1]
                out.append(_LABEL_ESCAPES.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                closed = True
                break
            out.append(c)
            j += 1
        if not closed:
            # unterminated value: the line was truncated (or the value
            # sample-split above mis-fired on a `}` inside a quote) —
            # reject the whole sample rather than store a corrupt tail
            raise ValueError(lab_str)
        labels[key] = "".join(out)
        i = j + 1
    return labels


def _fmt(labels: Dict[str, str]) -> str:
    return _metrics._fmt_labels(labels)


# ----------------------------------------------------------- collector
class FleetCollector:
    """Scrape a fleet's /metrics endpoints and merge them.

    ``endpoints``: [{name, address}] (a loaded manifest), or None to
    re-read ``manifest_path()`` + the in-process registry every pass —
    the live mode, where processes may join after the collector."""

    def __init__(self, endpoints: Optional[List[dict]] = None,
                 manifest: Optional[str] = None, timeout_s: float = 3.0):
        self._static = endpoints
        self.manifest = manifest
        self.timeout_s = timeout_s
        self.snapshots: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def endpoints(self) -> List[dict]:
        if self._static is not None:
            return list(self._static)
        out = {e["name"]: e for e in local_endpoints()}
        if self.manifest:
            for e in load_manifest(self.manifest):
                out[e["name"]] = e  # manifest wins: it carries the port
        return [out[k] for k in sorted(out)]

    # ------------------------------------------------------------ scrape
    def _get(self, address: str, path: str) -> Optional[str]:
        import http.client

        host, _, port = address.rpartition(":")
        try:
            conn = http.client.HTTPConnection(host or "127.0.0.1",
                                              int(port),
                                              timeout=self.timeout_s)
            try:
                conn.request("GET", path)
                resp = conn.getresponse()
                if resp.status != 200:
                    return None
                return resp.read().decode("utf-8", "replace")
            finally:
                conn.close()
        except (OSError, ValueError):
            return None

    def collect(self) -> Dict[str, dict]:
        """One scrape pass over every endpoint; returns (and stores)
        per-process snapshots {name: {up, address, types, samples,
        healthz, ts}}."""
        snaps: Dict[str, dict] = {}
        for e in self.endpoints():
            name, addr = e["name"], e["address"]
            federation_scrapes.inc()
            text = self._get(addr, "/metrics")
            snap = {"up": text is not None, "address": addr,
                    "types": {}, "samples": [], "healthz": None,
                    "ts": time.time()}  # wallclock-ok: snapshot stamp
            if text is None:
                federation_scrape_errors.inc()
            else:
                snap["types"], snap["samples"] = parse_prom_text(text)
                hz = self._get(addr, "/healthz")
                if hz:
                    try:
                        snap["healthz"] = json.loads(hz)
                    except ValueError:
                        pass
            snaps[name] = snap
        with self._lock:
            self.snapshots = snaps
        return snaps

    # ------------------------------------------------------------ render
    #: counter families summed fleet-wide into iotml_cluster_<family>
    SUM_FAMILIES = (
        "iotml_records_consumed_total", "iotml_records_scored_total",
        "iotml_records_trained_total", "iotml_raw_produce_records_total",
        "iotml_dlq_total", "iotml_online_updates_total",
        "iotml_trace_spans_dropped_total",
    )

    def render(self, snapshots: Optional[Dict[str, dict]] = None) -> str:
        """The merged exposition: every scraped sample re-labeled with
        ``process=<name>`` (Prometheus federation shape), then the
        synthesized ``iotml_cluster_*`` rollups."""
        if snapshots is None:
            with self._lock:
                snapshots = dict(self.snapshots)
        out: List[str] = []
        emitted_type: set = set()
        for name in sorted(snapshots):
            snap = snapshots[name]
            for fam, typ in sorted(snap["types"].items()):
                if fam not in emitted_type:
                    out.append(f"# TYPE {fam} {typ}")
                    emitted_type.add(fam)
            for mname, labels, value in snap["samples"]:
                labels = dict(labels)
                labels["process"] = name
                out.append(f"{mname}{_fmt(labels)} {value}")
        out.extend(self._rollups(snapshots))
        return "\n".join(out) + "\n"

    def _rollups(self, snapshots: Dict[str, dict]) -> List[str]:
        up = {n: s["up"] for n, s in snapshots.items()}
        lines = ["# TYPE iotml_cluster_up gauge"]
        for n in sorted(up):
            lines.append(f"iotml_cluster_up{_fmt({'process': n})} "
                         f"{1 if up[n] else 0}")
        lines.append("# TYPE iotml_cluster_processes gauge")
        lines.append(f"iotml_cluster_processes {sum(up.values())}")
        # counter sums: fleet-wide totals per family, with a process
        # breakdown already present above — these are the one-line
        # dashboard numbers
        sums: Dict[str, float] = {}
        lag: Dict[tuple, float] = {}       # (group, topic) → records
        replica_worst: Dict[str, float] = {}   # topic → records
        wm_worst: Dict[str, float] = {}        # stage → newest event ms
        isr_worst: Dict[str, float] = {}       # topic → min |ISR|
        qlag_worst: Dict[str, float] = {}      # topic → max hwm lag
        under_replicated = 0.0                 # fleet-wide sum
        for s in snapshots.values():
            for mname, labels, value in s["samples"]:
                if mname in self.SUM_FAMILIES:
                    sums[mname] = sums.get(mname, 0.0) + value
                elif mname == "iotml_consumer_lag_records":
                    key = (labels.get("group", ""),
                           labels.get("topic", ""))
                    lag[key] = lag.get(key, 0.0) + value
                elif mname == "iotml_replica_lag_records":
                    t = labels.get("topic", "")
                    replica_worst[t] = max(replica_worst.get(t, 0.0),
                                           value)
                elif mname == "iotml_isr_size":
                    # worst-of = the NARROWEST ISR across partitions
                    # and processes: the fleet's durability margin is
                    # its most under-replicated partition's
                    t = labels.get("topic", "")
                    cur = isr_worst.get(t)
                    isr_worst[t] = value if cur is None \
                        else min(cur, value)
                elif mname == "iotml_quorum_hwm_lag_records":
                    t = labels.get("topic", "")
                    qlag_worst[t] = max(qlag_worst.get(t, 0.0), value)
                elif mname == "iotml_under_replicated_partitions":
                    # each leader process reports its own partitions:
                    # the fleet total is the sum
                    under_replicated += value
                elif mname == "iotml_watermark_event_time_ms":
                    st = labels.get("stage", "")
                    # worst-of = the OLDEST frontier across processes:
                    # the fleet's e2e staleness is its slowest member's
                    cur = wm_worst.get(st)
                    wm_worst[st] = value if cur is None \
                        else min(cur, value)
        for fam in sorted(sums):
            cname = "iotml_cluster_" + fam[len("iotml_"):]
            lines.append(f"# TYPE {cname} counter")
            lines.append(f"{cname} {sums[fam]}")
        if lag:
            lines.append("# TYPE iotml_cluster_consumer_lag_records gauge")
            for (g, t) in sorted(lag):
                lines.append(
                    "iotml_cluster_consumer_lag_records"
                    f"{_fmt({'group': g, 'topic': t})} {lag[(g, t)]}")
        if replica_worst:
            lines.append(
                "# TYPE iotml_cluster_replica_lag_worst_records gauge")
            for t in sorted(replica_worst):
                lines.append(
                    "iotml_cluster_replica_lag_worst_records"
                    f"{_fmt({'topic': t})} {replica_worst[t]}")
        if isr_worst:
            lines.append("# TYPE iotml_cluster_isr_size_worst gauge")
            for t in sorted(isr_worst):
                lines.append("iotml_cluster_isr_size_worst"
                             f"{_fmt({'topic': t})} {isr_worst[t]}")
            lines.append(
                "# TYPE iotml_cluster_under_replicated_partitions gauge")
            lines.append("iotml_cluster_under_replicated_partitions "
                         f"{under_replicated}")
        if qlag_worst:
            lines.append(
                "# TYPE iotml_cluster_quorum_hwm_lag_worst_records gauge")
            for t in sorted(qlag_worst):
                lines.append(
                    "iotml_cluster_quorum_hwm_lag_worst_records"
                    f"{_fmt({'topic': t})} {qlag_worst[t]}")
        if wm_worst:
            now_ms = time.time() * 1000.0  # wallclock-ok: event domain
            lines.append(
                "# TYPE iotml_cluster_watermark_lag_worst_seconds gauge")
            for st in sorted(wm_worst):
                lag_s = max(now_ms - wm_worst[st], 0.0) / 1000.0
                lines.append(
                    "iotml_cluster_watermark_lag_worst_seconds"
                    f"{_fmt({'stage': st})} {round(lag_s, 3)}")
        return lines

    def healthz(self, snapshots: Optional[Dict[str, dict]] = None) -> dict:
        if snapshots is None:
            with self._lock:
                snapshots = dict(self.snapshots)
        procs = {}
        degraded = []
        for name in sorted(snapshots):
            s = snapshots[name]
            status = "down" if not s["up"] else \
                (s["healthz"] or {}).get("status", "ok")
            procs[name] = {"address": s["address"], "status": status}
            if status != "ok":
                degraded.append(name)
        return {"status": "ok" if not degraded else "degraded",
                "processes": procs, "degraded": degraded,
                "process_count": len(procs),
                "up_count": sum(1 for s in snapshots.values()
                                if s["up"])}

    # -------------------------------------------------------- changelog
    def fleet_state(self, snapshots: Optional[Dict[str, dict]] = None
                    ) -> Dict[str, dict]:
        """Per-process compact state docs — what the _IOTML_METRICS
        changelog carries (small, keyed, compaction-friendly)."""
        if snapshots is None:
            with self._lock:
                snapshots = dict(self.snapshots)
        out = {}
        for name, s in snapshots.items():
            doc = {"ts_ms": int(s["ts"] * 1000), "up": s["up"],
                   "address": s["address"]}
            for mname, labels, value in s["samples"]:
                if mname in self.SUM_FAMILIES:
                    doc[mname[len("iotml_"):]] = \
                        doc.get(mname[len("iotml_"):], 0.0) + value
                elif mname == "iotml_consumer_lag_records":
                    doc["consumer_lag"] = \
                        doc.get("consumer_lag", 0.0) + value
            hz = s.get("healthz") or {}
            if hz.get("status"):
                doc["status"] = hz["status"]
            out[name] = doc
        return out

    def append_tsdb(self, appender,
                    snapshots: Optional[Dict[str, dict]] = None) -> int:
        """Append every scraped sample to the log-native TSDB, one
        chunked write set per process with the federation
        ``process=`` relabel applied at write time — history for the
        query engine beside the latest-only _IOTML_METRICS snapshot.
        Returns chunk records appended."""
        if snapshots is None:
            with self._lock:
                snapshots = dict(self.snapshots)
        n = 0
        for name in sorted(snapshots):
            s = snapshots[name]
            if not s["up"] or not s["samples"]:
                continue
            n += appender.append(s["samples"],
                                 ts_ms=int(s["ts"] * 1000),
                                 process=name)
        return n

    def snapshot_changelog(self, broker,
                           snapshots: Optional[Dict[str, dict]] = None
                           ) -> int:
        """Append the fleet state to the compacted _IOTML_METRICS
        changelog (key = process name): dashboards replay cluster
        history from the log like every other materialised view, and
        latest-per-key compaction bounds it at ~one record per
        process."""
        state = self.fleet_state(snapshots)
        if not state:
            return 0
        broker.create_topic(METRICS_TOPIC, cleanup_policy="compact")
        entries = [(name.encode(), json.dumps(doc, sort_keys=True)
                    .encode(), doc["ts_ms"])
                   for name, doc in sorted(state.items())]
        produce_many = getattr(broker, "produce_many", None)
        if produce_many is not None:
            produce_many(METRICS_TOPIC, entries, partition=0)
        else:
            for k, v, ts in entries:
                broker.produce(METRICS_TOPIC, v, key=k, partition=0)
        federation_snapshots.inc(len(entries))
        return len(entries)


def read_fleet_state(broker, partition: int = 0) -> Dict[str, dict]:
    """Latest fleet-state doc per process, replayed from the compacted
    _IOTML_METRICS changelog — the dashboard's cold-start read."""
    if METRICS_TOPIC not in broker.topics():
        return {}
    out: Dict[str, dict] = {}
    off = broker.begin_offset(METRICS_TOPIC, partition)
    end = broker.end_offset(METRICS_TOPIC, partition)
    while off < end:
        batch = broker.fetch(METRICS_TOPIC, partition, off, 4096)
        if not batch:
            break
        for m in batch:
            off = m.offset + 1
            if m.key is None:
                continue
            if m.value is None:
                out.pop(m.key.decode(), None)  # retired process
                continue
            try:
                out[m.key.decode()] = json.loads(m.value)
            except ValueError:
                continue
    return out


# -------------------------------------------------------------- server
class FleetServer:
    """One merged /metrics + /healthz for the whole fleet, scraping the
    manifest endpoints on a cadence (the `python -m iotml_torch.obs fleet`
    runtime)."""

    def __init__(self, collector: FleetCollector, port: int = 9200,
                 interval_s: float = 2.0, broker=None, tsdb=None):
        self.collector = collector
        self.interval_s = interval_s
        self.broker = broker
        #: optional tsdb.TsdbAppender: every scrape's samples append to
        #: the log-native TSDB beside the latest-only changelog
        self.tsdb = tsdb
        self._stop = threading.Event()
        import http.server

        col = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/metrics":
                    body = col.collector.render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path == "/healthz":
                    body = json.dumps(col.collector.healthz(), indent=2,
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

        self.srv = http.server.ThreadingHTTPServer(("0.0.0.0", port),
                                                   Handler)
        self.port = self.srv.server_address[1]

    def scrape_once(self) -> Dict[str, dict]:
        snaps = self.collector.collect()
        if self.broker is not None:
            try:
                self.collector.snapshot_changelog(self.broker, snaps)
            except (ConnectionError, OSError):
                pass  # broker down: the merged /metrics still serves
        if self.tsdb is not None:
            try:
                self.collector.append_tsdb(self.tsdb, snaps)
            except (ConnectionError, OSError):
                pass  # same degradation contract as the changelog
        return snaps

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.scrape_once()
            self._stop.wait(self.interval_s)

    def start(self) -> "FleetServer":
        from ..supervise.registry import register_thread

        self._srv_thread = register_thread(threading.Thread(
            target=self.srv.serve_forever, daemon=True,
            name=f"iotml-fleet-metrics-{self.port}"))
        self._srv_thread.start()
        self._scrape_thread = register_thread(threading.Thread(
            target=self._loop, daemon=True,
            name="iotml-fleet-scraper"))
        self._scrape_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.srv.shutdown()
        self.srv.server_close()
