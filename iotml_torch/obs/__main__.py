"""``python -m iotml_torch.obs`` — the observability CLI (``iotml.obs``'s
twin, with its subcommands, arguments and exit codes):

    python -m iotml_torch.obs trace SPANS.jsonl [--json] [--top N]
                              [--min-stages N] [--require-e2e]
                              [--require-cross-process N] [--show-trace]
    python -m iotml_torch.obs fleet [--endpoints MANIFEST] [--port 9200]
                              [--interval S] [--bootstrap HOST:PORT]
                              [--once [--json] [--min-processes N]]
                              [--follow-manifest]
    python -m iotml_torch.obs tsdb query EXPR --bootstrap HOST:PORT
                              [--time-ms T | --start-ms A --end-ms B
                               --step-ms S] [--json]
    python -m iotml_torch.obs tsdb slo-status --bootstrap HOST:PORT [--json]
    python -m iotml_torch.obs tsdb canary-report --bootstrap HOST:PORT
                              [--window 5m] [--json]
    python -m iotml_torch.obs tsdb drill [--seed 7] [--records 600] [--json]
    python -m iotml_torch.obs dlq --bootstrap HOST:PORT [--topic T]
                              [--limit N] [--json]

``trace`` summarizes a span log written by ``iotml_torch.obs.tracing``
(``IOTML_TRACE=1 IOTML_TRACE_PATH=spans.jsonl``), or by the JAX
package's (the same JSON lines), into a per-stage latency breakdown and
names the stage that took the most time.  ``--min-stages``,
``--require-e2e`` and ``--require-cross-process`` turn it into an
assertion (exit 1 on a violation).  ``fleet`` scrapes every process in
the endpoints manifest (``IOTML_OBS_ENDPOINTS``) and serves one merged
``/metrics`` + ``/healthz``; with ``--bootstrap`` it snapshots the fleet
into ``_IOTML_METRICS`` and, as a server, appends every scrape to the
``_IOTML_TSDB`` history with the burn-rate SLO engine (rules from the
``slo`` config section) supervised beside it.  ``tsdb`` queries that
history over the wire, shows SLO and canary status (``slo-status`` exits
1 while an alert fires), or runs the alert-burn drill in-process (on the
card; ``main(argv, device="cpu")`` runs it on the CPU).  ``dlq`` peeks a
dead-letter topic over the Kafka wire protocol: it decodes the JSON
envelopes the stream processor's tasks write (``streamproc.dlq``) and
shows what poisoned the pipeline.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

def _percentile(sorted_vals: List[int], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def load_spans(path: str):
    """Parse a span log: returns (stages, e2e) aggregation dicts."""
    stages, e2e, _traces = load_spans_traces(path)
    return stages, e2e


def load_spans_traces(path: str):
    """Parse a span log with per-trace reconstruction: returns
    (stages, e2e, traces) where traces maps trace id → {spans:
    [(start_us, stage, dur_us, proc)], e2e: [(closer, dur_us, proc)],
    batches: [batch docs], procs: set} — the cross-process view a
    fleet run appends into ONE log (O_APPEND lines from every
    process, disambiguated by the `proc` field)."""
    stages: Dict[str, List[int]] = {}
    e2e: Dict[str, List[int]] = {}
    traces: Dict[str, dict] = {}

    def tr(tid):
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = {"spans": [], "e2e": [], "batches": [],
                               "procs": set()}
        return t

    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail line of a live run: skip
            kind = doc.get("kind")
            proc = doc.get("proc", "?")
            if kind == "span":
                stages.setdefault(doc["stage"], []).append(int(doc["dur_us"]))
                t = tr(doc.get("trace", "?"))
                t["spans"].append((int(doc.get("start_us", 0)),
                                   doc["stage"], int(doc["dur_us"]),
                                   proc))
                t["procs"].add(proc)
            elif kind == "e2e":
                e2e.setdefault(doc["closer"], []).append(int(doc["dur_us"]))
                t = tr(doc.get("trace", "?"))
                t["e2e"].append((doc["closer"], int(doc["dur_us"]),
                                 proc))
                t["procs"].add(proc)
            elif kind == "batch":
                t = tr(doc.get("trace", "?"))
                t["batches"].append(doc)
                t["procs"].add(proc)
    return stages, e2e, traces


def best_cross_process_trace(traces: Dict[str, dict]):
    """(trace_id, trace) spanning the most processes — closed e2e
    traces preferred, then span count; None when the log has none."""
    best = None
    for tid, t in traces.items():
        key = (len(t["procs"]), 1 if t["e2e"] else 0, len(t["spans"]))
        if best is None or key > best[0]:
            best = (key, tid, t)
    if best is None:
        return None, None
    return best[1], best[2]


def print_trace(tid: str, t: dict) -> None:
    """One trace's cross-process breakdown, stages in birth-relative
    order with the process that ran each."""
    procs = sorted(t["procs"])
    print(f"\ntrace {tid} across {len(procs)} process(es): "
          f"{', '.join(procs)}")
    for start_us, stage, dur_us, proc in sorted(t["spans"]):
        print(f"  +{start_us / 1000.0:9.3f} ms  {stage:<18} "
              f"{dur_us / 1000.0:9.3f} ms  [{proc}]")
    for doc in sorted(t["batches"],
                      key=lambda d: (d.get("topic", ""),
                                     d.get("first_offset", -1))):
        print(f"      batch {doc.get('topic')}:{doc.get('partition')}"
              f" offsets {doc.get('first_offset')}-"
              f"{doc.get('last_offset')} n={doc.get('n')} "
              f"stage={doc.get('stage')} [{doc.get('proc')}]")
    for closer, dur_us, proc in t["e2e"]:
        print(f"  e2e ingest->{closer}: {dur_us / 1000.0:.3f} ms "
              f"[{proc}]")


def summarize(stages: Dict[str, List[int]], e2e: Dict[str, List[int]]) -> dict:
    rows = []
    for stage, durs in stages.items():
        durs = sorted(durs)
        rows.append({
            "stage": stage,
            "count": len(durs),
            "mean_ms": sum(durs) / len(durs) / 1000.0,
            "p50_ms": _percentile(durs, 0.50) / 1000.0,
            "p95_ms": _percentile(durs, 0.95) / 1000.0,
            "max_ms": durs[-1] / 1000.0,
            "total_ms": sum(durs) / 1000.0,
        })
    # attribution by total time: the bottleneck is where the stream's
    # aggregate latency budget went, not one unlucky record's max
    rows.sort(key=lambda r: -r["total_ms"])
    bottleneck = rows[0]["stage"] if rows else None
    grand = sum(r["total_ms"] for r in rows) or 1.0
    for r in rows:
        r["share"] = r["total_ms"] / grand
    e2e_rows = {closer: {
        "count": len(durs),
        "mean_ms": sum(durs) / len(durs) / 1000.0,
        "p95_ms": _percentile(sorted(durs), 0.95) / 1000.0,
        "max_ms": max(durs) / 1000.0,
    } for closer, durs in e2e.items()}
    return {"stages": rows, "e2e": e2e_rows, "bottleneck": bottleneck}


def print_table(summary: dict) -> None:
    rows = summary["stages"]
    if not rows:
        print("no spans found")
        return
    hdr = f"{'stage':<16} {'count':>8} {'mean_ms':>10} {'p50_ms':>10} " \
          f"{'p95_ms':>10} {'max_ms':>10} {'total_ms':>11} {'share':>7}"
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['stage']:<16} {r['count']:>8} {r['mean_ms']:>10.3f} "
              f"{r['p50_ms']:>10.3f} {r['p95_ms']:>10.3f} "
              f"{r['max_ms']:>10.3f} {r['total_ms']:>11.3f} "
              f"{r['share']:>6.1%}")
    for closer, r in sorted(summary["e2e"].items()):
        print(f"\ne2e ingest->{closer}: {r['count']} records, "
              f"mean {r['mean_ms']:.3f} ms, p95 {r['p95_ms']:.3f} ms, "
              f"max {r['max_ms']:.3f} ms")
    if summary["bottleneck"]:
        b = rows[0]
        print(f"\nbottleneck: {b['stage']} "
              f"({b['share']:.0%} of aggregate stage time)")


def cmd_trace(args) -> int:
    try:
        stages, e2e, traces = load_spans_traces(args.path)
    except OSError as e:
        print(f"cannot read span log: {e}", file=sys.stderr)
        return 2
    if args.top:
        # keep the N slowest stages by total time (post-aggregation cap)
        keep = sorted(stages, key=lambda s: -sum(stages[s]))[: args.top]
        stages = {s: stages[s] for s in keep}
    summary = summarize(stages, e2e)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print_table(summary)
    failures = []
    if args.min_stages and len(summary["stages"]) < args.min_stages:
        failures.append(f"expected >= {args.min_stages} distinct stages, "
                        f"saw {len(summary['stages'])}: "
                        f"{sorted(s['stage'] for s in summary['stages'])}")
    if args.require_e2e:
        closed = sum(r["count"] for r in summary["e2e"].values())
        nonzero = any(r["max_ms"] > 0 for r in summary["e2e"].values())
        if not closed or not nonzero:
            failures.append("expected closed e2e spans with nonzero latency")
    if args.show_trace or args.require_cross_process:
        tid, t = best_cross_process_trace(traces)
        if not args.json and tid is not None and args.show_trace:
            print_trace(tid, t)
        if args.require_cross_process:
            # at least one CLOSED trace whose stages were recorded by
            # >= N distinct processes: the context crossed the wire
            ok = any(len(tr["procs"]) >= args.require_cross_process
                     and tr["e2e"]
                     for tr in traces.values())
            if not ok:
                have = max((len(tr["procs"]) for tr in traces.values()
                            if tr["e2e"]), default=0)
                failures.append(
                    f"expected a closed e2e trace spanning >= "
                    f"{args.require_cross_process} processes; best "
                    f"closed trace spans {have}")
    for f in failures:
        print(f"TRACE CHECK FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def cmd_fleet(args) -> int:
    """Run (or one-shot) the metrics federation collector."""
    from .federate import FleetCollector, FleetServer, load_manifest

    endpoints = None
    if args.endpoints:
        endpoints = load_manifest(args.endpoints)
        if not endpoints and args.once:
            print(f"no endpoints in manifest {args.endpoints!r}",
                  file=sys.stderr)
            return 2
    collector = FleetCollector(
        endpoints=None if args.follow_manifest else endpoints,
        manifest=args.endpoints)
    broker = None
    if args.bootstrap:
        from ..stream.kafka_wire import KafkaWireBroker

        try:
            broker = KafkaWireBroker(args.bootstrap,
                                     client_id="iotml-obs-fleet")
        except OSError as e:
            print(f"cannot reach broker {args.bootstrap!r}: {e}",
                  file=sys.stderr)
            if args.once:
                return 2
    if args.once:
        snaps = collector.collect()
        if broker is not None:
            collector.snapshot_changelog(broker, snaps)
        hz = collector.healthz(snaps)
        if args.json:
            print(json.dumps(hz, indent=2, sort_keys=True))
        else:
            print(collector.render(snaps), end="")
            print(f"# fleet: {hz['up_count']}/{hz['process_count']} "
                  f"processes up, status={hz['status']}",
                  file=sys.stderr)
        if args.min_processes and hz["up_count"] < args.min_processes:
            print(f"FLEET CHECK FAILED: {hz['up_count']} processes up, "
                  f"expected >= {args.min_processes}", file=sys.stderr)
            return 1
        return 0
    # with a broker attached the long-running server is the full
    # telemetry plane: scrapes append TSDB history and the burn-rate
    # SLO engine (rules from config: IOTML_SLO_*) evaluates beside it
    appender = engine = sup = None
    if broker is not None:
        from ..config import load_config, slo_rules
        from ..supervise.supervisor import Supervisor
        from . import slo as _slo
        from . import tsdb as _tsdb

        cfg, _ = load_config([])
        appender = _tsdb.TsdbAppender(broker,
                                      chunk_ms=cfg.slo.tsdb_chunk_ms)
        engine = _slo.SloEngine(broker, slo_rules(cfg.slo),
                                interval_s=cfg.slo.interval_s)
        sup = Supervisor(name="obs-fleet-supervisor")
        sup.add_loop("slo-engine", engine.loop)
        sup.start()
    srv = FleetServer(collector, port=args.port,
                      interval_s=args.interval, broker=broker,
                      tsdb=appender).start()
    print(f"fleet metrics on :{srv.port}/metrics (+ /healthz), "
          f"scraping every {args.interval}s"
          + ("; TSDB + SLO engine attached" if appender else "")
          + "; ctrl-c to stop")
    try:
        import time as _time

        while True:
            _time.sleep(3600)
    except KeyboardInterrupt:
        if sup is not None:
            sup.stop()
        srv.stop()
    return 0


def cmd_dlq(args) -> int:
    """Peek a dead-letter topic: decode the JSON envelopes the stream
    processor's DLQ writes and show what poisoned the pipeline."""
    from ..stream.broker import OffsetOutOfRangeError
    from ..stream.kafka_wire import KafkaWireBroker
    from ..streamproc.dlq import DLQ_SUFFIX, decode_envelope

    topic = args.topic if args.topic.endswith(DLQ_SUFFIX) \
        else args.topic + DLQ_SUFFIX
    try:
        client = KafkaWireBroker(args.bootstrap, client_id="iotml-dlq-peek")
    except OSError as e:
        print(f"cannot reach broker {args.bootstrap!r}: {e}",
              file=sys.stderr)
        return 2
    try:
        try:
            parts = client.topic(topic).partitions
        except KeyError:
            print(f"no dead letters: topic {topic!r} does not exist")
            return 0
        rows = []
        for p in range(parts):
            off = client.begin_offset(topic, p)
            end = client.end_offset(topic, p)
            resets = 0
            while off < end and len(rows) < args.limit:
                try:
                    msgs = client.fetch(topic, p, off, max_messages=256)
                except OffsetOutOfRangeError as e:  # raced a retention trim
                    # bounded: a broker that reports earliest=0 on this
                    # error must not spin the CLI forever
                    resets += 1
                    if resets > 3:
                        break
                    off = max(e.earliest, client.begin_offset(topic, p))
                    continue
                resets = 0
                if not msgs:
                    break
                for m in msgs:
                    off = m.offset + 1
                    try:
                        rows.append(decode_envelope(m.value))
                    except (ValueError, KeyError, TypeError):
                        rows.append({"source": topic, "partition": p,
                                     "offset": m.offset,
                                     "error": "unparseable DLQ envelope",
                                     "raw": m.value})
                    if len(rows) >= args.limit:
                        break
    finally:
        client.close()
    if args.json:
        for doc in rows:
            doc = dict(doc)
            doc["raw"] = doc.get("raw", b"")[:256].decode(errors="replace")
            print(json.dumps(doc, sort_keys=True))
        return 0
    if not rows:
        print(f"{topic}: empty")
        return 0
    print(f"{topic}: showing {len(rows)} dead letter(s)")
    for doc in rows:
        raw = doc.get("raw", b"")[:80]
        print(f"  {doc.get('source')}:{doc.get('partition')}"
              f"@{doc.get('offset')} [{doc.get('task') or '-'}] "
              f"{doc.get('error')}"
              + (f" trace={doc['trace']}" if doc.get("trace") else ""))
        print(f"    raw[:80]: {raw!r}")
    return 0


def _tsdb_client(bootstrap: str):
    from ..stream.kafka_wire import KafkaWireBroker

    try:
        return KafkaWireBroker(bootstrap, client_id="iotml-obs-tsdb")
    except OSError as e:
        print(f"cannot reach broker {bootstrap!r}: {e}", file=sys.stderr)
        return None


def cmd_tsdb(args, device=None) -> int:
    """The log-native TSDB surface: query / slo-status / canary-report
    over the wire, or the live alert-burn drill in-process (its scorer on
    ``device``: the card unless the caller names another)."""
    from . import tsdb as _tsdb

    if args.tsdb_cmd == "drill":
        from .drill import drill_alert_burn

        rep = drill_alert_burn(seed=args.seed, records=args.records,
                               device=device)
        if args.json:
            print(json.dumps(rep.to_dict(), indent=2, sort_keys=True,
                             default=str))
        else:
            for line in rep.lines():
                print(line)
        return 0 if rep.ok else 1

    client = _tsdb_client(args.bootstrap)
    if client is None:
        return 2
    try:
        series = _tsdb.read_series(client)
        if args.tsdb_cmd == "query":
            try:
                if args.start_ms is not None and args.end_ms is not None:
                    result = _tsdb.query(series, args.expr,
                                         start_ms=args.start_ms,
                                         end_ms=args.end_ms,
                                         step_ms=args.step_ms)
                else:
                    result = _tsdb.query(series, args.expr,
                                         at_ms=args.time_ms)
            except ValueError as e:
                print(f"bad query: {e}", file=sys.stderr)
                return 2
            if args.json:
                print(json.dumps(result, indent=2, sort_keys=True))
            else:
                if not result:
                    print("empty result")
                for r in result:
                    labels = ",".join(f"{k}={v}" for k, v in
                                      sorted(r["labels"].items()))
                    if "values" in r:
                        pts = " ".join(f"{t}:{v:.6g}"
                                       for t, v in r["values"])
                        print(f"{{{labels}}} {pts}")
                    else:
                        print(f"{{{labels}}} {r['value']:.6g}")
            return 0
        if args.tsdb_cmd == "slo-status":
            from . import slo as _slo

            alerts = _slo.read_alerts(client)
            burns = _tsdb.instant(series, "iotml_slo_burn_rate")
            doc = {"alerts": alerts,
                   "burn_rates": [
                       {"slo": r["labels"].get("slo", ""),
                        "window": r["labels"].get("window", ""),
                        "process": r["labels"].get("process", ""),
                        "burn": r["value"]} for r in burns]}
            if args.json:
                print(json.dumps(doc, indent=2, sort_keys=True))
            else:
                if not burns and not alerts:
                    print("no SLO telemetry in the TSDB")
                for r in doc["burn_rates"]:
                    print(f"burn {r['slo']}/{r['window']}: "
                          f"{r['burn']:.2f} [{r['process']}]")
                for name, a in sorted(alerts.items()):
                    state = "FIRING" if a.get("firing") else "resolved"
                    print(f"alert {name}: {state} "
                          f"(last {a.get('action')} window="
                          f"{a.get('window') or '-'}) {a.get('message')}")
            # a firing alert makes the status check itself fail — the
            # CI/cron shape (like fleet --min-processes)
            return 1 if any(a.get("firing")
                            for a in alerts.values()) else 0
        # canary-report: probe outcomes + e2e quantiles from the TSDB
        window_ms = _tsdb.parse_duration_ms(args.window)
        outcomes = {}
        for r in _tsdb.increase(series, "iotml_canary_probes_total",
                                window_ms=window_ms):
            out = r["labels"].get("outcome", "?")
            outcomes[out] = outcomes.get(out, 0.0) + r["value"]
        quantiles = {}
        for q in (0.5, 0.95, 0.99):
            res = _tsdb.histogram_quantile(
                series, q, "iotml_canary_e2e_seconds",
                window_ms=window_ms)
            if res:
                quantiles[f"p{int(q * 100)}"] = max(
                    r["value"] for r in res)
        doc = {"window": args.window, "outcomes": outcomes,
               "e2e_quantiles_s": quantiles}
        if args.json:
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            if not outcomes:
                print(f"no canary probes in the last {args.window}")
            else:
                sent = outcomes.get("sent", 0.0)
                ok = outcomes.get("ok", 0.0)
                lost = outcomes.get("lost", 0.0)
                print(f"canaries last {args.window}: sent={sent:.0f} "
                      f"ok={ok:.0f} lost={lost:.0f}"
                      + (f" delivery={ok / sent:.4f}" if sent else ""))
                for name, v in sorted(quantiles.items()):
                    print(f"  e2e {name}: {v * 1000:.1f} ms")
        return 0
    finally:
        client.close()


def main(argv=None, device=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.obs",
        description="observability tools (span-log analysis, fleet "
                    "federation, the log-native TSDB, dead-letter topics)")
    sub = ap.add_subparsers(dest="cmd")
    tp = sub.add_parser(
        "trace", help="summarize a JSONL span log into a per-stage "
                      "latency breakdown and flag the bottleneck stage")
    tp.add_argument("path", help="span log written under IOTML_TRACE_PATH")
    tp.add_argument("--json", action="store_true",
                    help="machine-readable summary")
    tp.add_argument("--top", type=int, default=0,
                    help="only the N slowest stages by total time")
    tp.add_argument("--min-stages", type=int, default=0,
                    help="exit 1 unless at least N distinct stages appear")
    tp.add_argument("--require-e2e", action="store_true",
                    help="exit 1 unless closed e2e spans with nonzero "
                         "latency appear")
    tp.add_argument("--require-cross-process", type=int, default=0,
                    metavar="N",
                    help="exit 1 unless a closed e2e trace spans >= N "
                         "distinct processes")
    tp.add_argument("--show-trace", action="store_true",
                    help="print the breakdown of the trace spanning "
                         "the most processes")
    fp = sub.add_parser(
        "fleet", help="metrics federation: scrape every fleet "
                      "process's /metrics and serve one merged view")
    fp.add_argument("--endpoints", default=None,
                    help="endpoints manifest (JSON [{name, address}]); "
                         "defaults to $IOTML_OBS_ENDPOINTS")
    fp.add_argument("--port", type=int, default=9200,
                    help="merged /metrics + /healthz port")
    fp.add_argument("--interval", type=float, default=2.0,
                    help="scrape cadence seconds")
    fp.add_argument("--bootstrap", default=None,
                    help="broker address: snapshot fleet state into "
                         "the compacted _IOTML_METRICS changelog")
    fp.add_argument("--once", action="store_true",
                    help="scrape once, print the merged exposition, "
                         "exit (CI smoke mode)")
    fp.add_argument("--json", action="store_true",
                    help="with --once: print the merged healthz JSON")
    fp.add_argument("--min-processes", type=int, default=0,
                    help="with --once: exit 1 unless >= N processes "
                         "answered their scrape")
    fp.add_argument("--follow-manifest", action="store_true",
                    help="re-read the manifest every pass (processes "
                         "may join after the collector starts)")
    tsp = sub.add_parser(
        "tsdb", help="log-native TSDB: query the _IOTML_TSDB history, "
                     "show SLO/canary status, or run the alert-burn "
                     "drill")
    tsub = tsp.add_subparsers(dest="tsdb_cmd")
    qp = tsub.add_parser(
        "query", help="evaluate a PromQL-shaped expression (selector, "
                      "rate(), increase(), histogram_quantile())")
    qp.add_argument("expr", help='e.g. \'rate(iotml_records_scored_'
                                 'total[5m])\'')
    qp.add_argument("--bootstrap", required=True,
                    help="broker address host:port")
    qp.add_argument("--time-ms", type=int, default=None,
                    help="instant evaluation timestamp (default: newest)")
    qp.add_argument("--start-ms", type=int, default=None)
    qp.add_argument("--end-ms", type=int, default=None,
                    help="with --start-ms: range query")
    qp.add_argument("--step-ms", type=int, default=15_000)
    qp.add_argument("--json", action="store_true")
    sp = tsub.add_parser(
        "slo-status", help="burn-rate gauges + latest _IOTML_ALERTS "
                           "state per SLO (exit 1 while any alert "
                           "fires)")
    sp.add_argument("--bootstrap", required=True)
    sp.add_argument("--json", action="store_true")
    cp = tsub.add_parser(
        "canary-report", help="synthetic-probe outcomes and e2e "
                              "latency quantiles from the TSDB")
    cp.add_argument("--bootstrap", required=True)
    cp.add_argument("--window", default="5m",
                    help="trailing window (e.g. 30s, 5m, 1h)")
    cp.add_argument("--json", action="store_true")
    drp = tsub.add_parser(
        "drill", help="live alert-burn drill: degrade the bridge, "
                      "prove the fast burn pair fires + resolves "
                      "(exit status is the verdict)")
    drp.add_argument("--seed", type=int, default=7)
    drp.add_argument("--records", type=int, default=600)
    drp.add_argument("--json", action="store_true")
    dp = sub.add_parser(
        "dlq", help="peek a dead-letter topic's poisoned-record "
                    "envelopes over the Kafka wire protocol")
    dp.add_argument("--bootstrap", required=True,
                    help="broker address host:port[,host:port...]")
    dp.add_argument("--topic", default="sensor-data",
                    help="source topic (the _DLQ suffix is appended "
                         "unless already present)")
    dp.add_argument("--limit", type=int, default=20,
                    help="show at most N dead letters")
    dp.add_argument("--json", action="store_true",
                    help="one JSON envelope per line")
    args = ap.parse_args(argv)
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "fleet":
        import os

        if args.endpoints is None:
            args.endpoints = os.environ.get("IOTML_OBS_ENDPOINTS")
        return cmd_fleet(args)
    if args.cmd == "dlq":
        return cmd_dlq(args)
    if args.cmd == "tsdb":
        if not getattr(args, "tsdb_cmd", None):
            tsp.print_help()
            return 2
        return cmd_tsdb(args, device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
