#!/usr/bin/env python3
"""Time the CLI drains of one checkout of the port: ``cardata`` predict
and ``serve ... committed``, on ``emulator:30000`` and over the Kafka wire
protocol on ``127.0.0.1``.

    python3 scripts/cli_drain_timing.py [--root DIR] [--tag NAME] [--reps N]
        [--gc on|freeze|off] [--poll-reps N]

Run on a machine with an H100 and ``nvcc``.  Imports ``iotml_torch`` from
``--root`` (default: the checkout holding this script), so that two
checkouts (a parent commit unpacked with ``git archive``, and the change)
can be timed in one call, in turns: parent, change, change, parent.  Uses
only entry points both sides have: ``cli.cardata.main``,
``cli.serve.main``, ``cli._app._broker_for`` and ``KafkaWireServer``.

As ``chip_smoke.py``'s ``wire_path`` runs them: the port's wire server
on 127.0.0.1:0 with SASL/PLAIN over ``emulator:30000``'s records;
``cardata`` train once (its fit, the checkpoint), then ``predict`` ``--reps``
times (10,000 rows each, the drain's rows/s from its ``stats:`` line),
then ``serve ... committed`` ``--reps`` times, each over a fresh log of
the same 30,000 records (rows/s from ``serve_seconds``).  Then, as
``cli_path`` and ``serve_path`` run them, the same predict and serve on
``emulator:30000`` (a new in-process log each call) ``--reps`` times.  Every call runs
on the card and must return 0 and score every row.  Prints one JSON line
with the card's name and power limit as ``nvidia-smi`` gives them, and
the seconds of full garbage collections inside each call
(``gc2_seconds_per_call``), which decide which drain a ~0.1 s pause
lands in.

``--gc`` holds the collector fixed on both sides of a comparison:
``freeze`` runs ``gc.collect(); gc.freeze()`` once after start-up (the
train call), so a full collection no longer walks what start-up left;
``off`` disables the collector inside every timed call and collects
between calls, outside the timing.  ``--poll-reps N`` also times the
poll leg alone, ``N`` times: a ``StreamConsumer`` reading the 30,000
``emulator:30000`` records in 4,096-record polls (the batcher's chunk),
as the serve drain polls them, with the consume watermark on and off in
turns where the checkout has ``obs.watermark`` (``poll_leg_seconds``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CREDS = ("smoke", "smoke-secret")
TOPIC = "SENSOR_DATA_S_AVRO"
FLAGS = (f"--broker.sasl_username={CREDS[0]}",
         f"--broker.sasl_password={CREDS[1]}")


#: seconds of full (generation 2) garbage collections in each ``_stats``
#: call, in call order: a full collection walks every object the process
#: holds, and landing inside one drain and not the other it moves ~0.1 s
GC2_SECONDS: list = []
_gc_start = [0.0]


def _gc_watch(phase, info):
    if info["generation"] != 2:
        return
    if phase == "start":
        _gc_start[0] = time.perf_counter()
    else:
        GC2_SECONDS[-1] += time.perf_counter() - _gc_start[0]


def _stats(main, argv, gc_mode="on", **kw) -> dict:
    out = io.StringIO()
    GC2_SECONDS.append(0.0)
    if gc_mode == "off":
        gc.disable()
    try:
        with contextlib.redirect_stdout(out):
            rc = main(argv, **kw)
    finally:
        if gc_mode == "off":
            inside = GC2_SECONDS[-1]
            gc.enable()
            gc.collect()  # outside the call: not counted in it
            GC2_SECONDS[-1] = inside
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"{argv[:6]} returned {rc}:\n{text}")
    lines = [line for line in text.splitlines() if line.startswith("stats: ")]
    return json.loads(lines[-1][len("stats: "):])


def _poll_leg(reps: int, gc_mode: str) -> dict:
    """Seconds of each full poll of ``emulator:30000``'s 30,000 records,
    by watermark state, the states in turns within each rep."""
    from iotml_torch.cli import _app
    from iotml_torch.stream.consumer import StreamConsumer
    try:
        from iotml_torch.obs import watermark
    except ImportError:  # a checkout from before the watermarks
        watermark = None
    states = ("watermark_on", "watermark_off") if watermark else \
        ("no_watermark",)
    broker = _app._broker_for("emulator:30000", TOPIC)
    out = {s: [] for s in states}
    for i in range(reps):
        for state in states:
            if watermark:
                watermark.configure(enabled=state == "watermark_on")
            consumer = StreamConsumer(broker, [f"{TOPIC}:0:0"],
                                      group=f"poll-leg-{i}")
            if gc_mode == "off":
                gc.disable()
            t0 = time.perf_counter()
            rows = 0
            while True:
                msgs = consumer.poll(4096)
                if not msgs:
                    break
                rows += len(msgs)
            out[state].append(time.perf_counter() - t0)
            if gc_mode == "off":
                gc.enable()
                gc.collect()
            if rows != 30_000:
                raise AssertionError(f"the poll leg read {rows} records")
    if watermark:
        watermark.configure(enabled=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--gc", choices=("on", "freeze", "off"),
                        default="on")
    parser.add_argument("--poll-reps", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from iotml_torch.cli import _app, cardata, serve
    from iotml_torch.stream.kafka_wire import KafkaWireServer

    if not torch.cuda.is_available():
        raise SystemExit("cli_drain_timing: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    gc.callbacks.append(_gc_watch)
    store = tempfile.mkdtemp(prefix="cli_drain_timing_")
    predict, serve_rates = [], []
    gc2 = {k: [] for k in ("wire_predict", "wire_serve", "emulator_predict",
                           "emulator_serve")}
    backing = _app._broker_for("emulator:30000", TOPIC)
    with KafkaWireServer(backing, credentials=CREDS) as srv:
        servers = f"127.0.0.1:{srv.port}"
        base = [servers, TOPIC, "0", "model-predictions"]
        _stats(cardata.main, [*base, "train", "m1", store, *FLAGS],
               gc_mode=args.gc)
        if args.gc == "freeze":
            gc.collect()
            gc.freeze()
        for _ in range(args.reps):
            st = _stats(cardata.main, [*base, "predict", "m1", store, *FLAGS],
                        gc_mode=args.gc)
            if st["rows"] != 10_000:
                raise AssertionError(f"predict scored {st['rows']} rows")
            predict.append(st["rows"] / st["score_seconds"])
            gc2["wire_predict"].append(GC2_SECONDS[-1])
    for _ in range(args.reps):
        log = _app._broker_for("emulator:30000", TOPIC)
        with KafkaWireServer(log, credentials=CREDS) as srv:
            st = _stats(serve.main,
                        [f"127.0.0.1:{srv.port}", TOPIC, "committed",
                         "model-predictions", "m1", store,
                         "--serve.poll_interval_s=0", "--serve.threshold=5",
                         *FLAGS], gc_mode=args.gc, max_rounds=2)
        if st["rows"] != 30_000:
            raise AssertionError(f"serve scored {st['rows']} rows")
        serve_rates.append(st["rows"] / st["serve_seconds"])
        gc2["wire_serve"].append(GC2_SECONDS[-1])
    emu_predict, emu_serve = [], []
    for _ in range(args.reps):
        st = _stats(cardata.main, ["emulator:30000", TOPIC, "0",
                                   "model-predictions", "predict", "m1",
                                   store], gc_mode=args.gc)
        if st["rows"] != 10_000:
            raise AssertionError(f"emulator predict scored {st['rows']}")
        emu_predict.append(st["rows"] / st["score_seconds"])
        gc2["emulator_predict"].append(GC2_SECONDS[-1])
        st = _stats(serve.main,
                    ["emulator:30000", TOPIC, "committed",
                     "model-predictions", "m1", store,
                     "--serve.poll_interval_s=0", "--serve.threshold=5"],
                    gc_mode=args.gc, max_rounds=2)
        if st["rows"] != 30_000:
            raise AssertionError(f"emulator serve scored {st['rows']}")
        emu_serve.append(st["rows"] / st["serve_seconds"])
        gc2["emulator_serve"].append(GC2_SECONDS[-1])
    poll = _poll_leg(args.poll_reps, args.gc) if args.poll_reps else {}
    print(json.dumps({"tag": args.tag or str(args.root), "card": card,
                      "gc": args.gc, "poll_leg_seconds": poll,
                      "wire_predict_drain_rows_per_s": predict,
                      "wire_serve_drain_rows_per_s": serve_rates,
                      "emulator_predict_drain_rows_per_s": emu_predict,
                      "emulator_serve_drain_rows_per_s": emu_serve,
                      "gc2_seconds_per_call": gc2}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
