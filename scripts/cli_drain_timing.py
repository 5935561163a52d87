#!/usr/bin/env python3
"""Time the CLI drains of one checkout of the port: ``cardata`` predict
and ``serve ... committed``, on ``emulator:30000`` and over the Kafka wire
protocol on ``127.0.0.1``.

    python3 scripts/cli_drain_timing.py [--root DIR] [--tag NAME] [--reps N]

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
with the card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
from pathlib import Path

CREDS = ("smoke", "smoke-secret")
TOPIC = "SENSOR_DATA_S_AVRO"
FLAGS = (f"--broker.sasl_username={CREDS[0]}",
         f"--broker.sasl_password={CREDS[1]}")


def _stats(main, argv, **kw) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"{argv[:6]} returned {rc}:\n{text}")
    lines = [line for line in text.splitlines() if line.startswith("stats: ")]
    return json.loads(lines[-1][len("stats: "):])


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--reps", type=int, default=3)
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
    store = tempfile.mkdtemp(prefix="cli_drain_timing_")
    predict, serve_rates = [], []
    backing = _app._broker_for("emulator:30000", TOPIC)
    with KafkaWireServer(backing, credentials=CREDS) as srv:
        servers = f"127.0.0.1:{srv.port}"
        base = [servers, TOPIC, "0", "model-predictions"]
        _stats(cardata.main, [*base, "train", "m1", store, *FLAGS])
        for _ in range(args.reps):
            st = _stats(cardata.main, [*base, "predict", "m1", store, *FLAGS])
            if st["rows"] != 10_000:
                raise AssertionError(f"predict scored {st['rows']} rows")
            predict.append(st["rows"] / st["score_seconds"])
    for _ in range(args.reps):
        log = _app._broker_for("emulator:30000", TOPIC)
        with KafkaWireServer(log, credentials=CREDS) as srv:
            st = _stats(serve.main,
                        [f"127.0.0.1:{srv.port}", TOPIC, "committed",
                         "model-predictions", "m1", store,
                         "--serve.poll_interval_s=0", "--serve.threshold=5",
                         *FLAGS], max_rounds=2)
        if st["rows"] != 30_000:
            raise AssertionError(f"serve scored {st['rows']} rows")
        serve_rates.append(st["rows"] / st["serve_seconds"])
    emu_predict, emu_serve = [], []
    for _ in range(args.reps):
        st = _stats(cardata.main, ["emulator:30000", TOPIC, "0",
                                   "model-predictions", "predict", "m1",
                                   store])
        if st["rows"] != 10_000:
            raise AssertionError(f"emulator predict scored {st['rows']}")
        emu_predict.append(st["rows"] / st["score_seconds"])
        st = _stats(serve.main,
                    ["emulator:30000", TOPIC, "committed",
                     "model-predictions", "m1", store,
                     "--serve.poll_interval_s=0", "--serve.threshold=5"],
                    max_rounds=2)
        if st["rows"] != 30_000:
            raise AssertionError(f"emulator serve scored {st['rows']}")
        emu_serve.append(st["rows"] / st["serve_seconds"])
    print(json.dumps({"tag": args.tag or str(args.root), "card": card,
                      "wire_predict_drain_rows_per_s": predict,
                      "wire_serve_drain_rows_per_s": serve_rates,
                      "emulator_predict_drain_rows_per_s": emu_predict,
                      "emulator_serve_drain_rows_per_s": emu_serve}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
