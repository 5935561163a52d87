"""``python -m iotml_torch.obs`` — the observability CLI (``iotml.obs``'s
twin, cut to ``trace`` and ``dlq``):

    python -m iotml_torch.obs trace SPANS.jsonl [--json] [--top N]
                              [--min-stages N] [--require-e2e]
                              [--require-cross-process N] [--show-trace]
    python -m iotml_torch.obs dlq --bootstrap HOST:PORT [--topic T]
                              [--limit N] [--json]

``trace`` summarizes a span log written by ``iotml_torch.obs.tracing``
(``IOTML_TRACE=1 IOTML_TRACE_PATH=spans.jsonl``), or by the JAX
package's (the same JSON lines), into a per-stage latency breakdown and
names the stage that took the most time.  ``--min-stages``,
``--require-e2e`` and ``--require-cross-process`` turn it into an
assertion (exit 1 on a violation).  ``dlq`` peeks a dead-letter topic
over the Kafka wire protocol: it decodes the JSON envelopes the stream
processor's tasks write (``streamproc.dlq``) and shows what poisoned the
pipeline.  ``fleet`` (the metrics federation) and ``tsdb`` are ROADMAP
A13: each raises NotImplementedError naming its item.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

#: subcommands of the JAX CLI the port has not got → the ROADMAP item
UNPORTED = {"fleet": "A13", "tsdb": "A13"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m iotml_torch.obs",
        description="observability tools (span-log analysis, "
                    "dead-letter topics)")
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
    for name, item in UNPORTED.items():
        sub.add_parser(name, help=f"not ported (ROADMAP {item})",
                       add_help=False)
    args, rest = ap.parse_known_args(argv)
    if args.cmd in UNPORTED:
        raise NotImplementedError(
            f"python -m iotml_torch.obs {args.cmd} is not ported yet "
            f"(ROADMAP {UNPORTED[args.cmd]})")
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    if args.cmd == "trace":
        return cmd_trace(args)
    if args.cmd == "dlq":
        return cmd_dlq(args)
    ap.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
