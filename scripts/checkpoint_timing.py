#!/usr/bin/env python3
"""Time the model checkpointer of one checkout of the port on the card:
the train-thread snapshot (``AsyncCheckpointer.snapshot``: one
device-to-host copy of the params and the Adam moments, then the queue)
and the writer (``write_once``: Keras h5 + ``state.npz`` serialized, the
registry publish with its fsyncs).

    python3 scripts/checkpoint_timing.py [--root DIR] [--tag NAME] [--reps N]

Run on a machine with an H100.  Imports ``iotml_torch`` from ``--root``
(default: the checkout holding this script), so that two checkouts (a
parent commit unpacked with ``git archive``, and the change) can be timed
in one call, in turns: parent, change, change, parent.  Uses only entry
points both sides have: ``Trainer``, ``AsyncCheckpointer`` and
``ModelRegistry``.

A ``Trainer`` on the card (the reference autoencoder, plain Adam) takes
one ``fit_compiled`` over 20 batches of 100 seeded rows (a
``RowSource``), so the moments hold real values; then ``--reps``
snapshots of that state, each timed alone on the host clock after a
``torch.cuda.synchronize()``, and ``--reps`` writes.  Prints one JSON
line: median and smallest snapshot ms, median write ms, and the writer's
serialize and fsync ms a version, with the card's name and power limit
as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from iotml_torch.data.dataset import RowSource, SensorBatches
    from iotml_torch.mlops import AsyncCheckpointer, ModelRegistry
    from iotml_torch.models.autoencoder import CAR_AUTOENCODER
    from iotml_torch.train.loop import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("checkpoint_timing: no CUDA card")
    source = RowSource()
    source.append(np.random.default_rng(7).uniform(0.0, 50.0, (2000, 18)),
                  np.full((2000,), "false", object))
    trainer = Trainer(CAR_AUTOENCODER)  # the card
    trainer.fit_compiled(SensorBatches(source, batch_size=100))
    torch.cuda.synchronize()
    snap_ms, write_ms = [], []
    with tempfile.TemporaryDirectory(prefix="ckpt_timing_") as root:
        ck = AsyncCheckpointer(ModelRegistry(root),
                               queue_depth=args.reps + 1)
        for i in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.snapshot(trainer.state, [("T", 0, i)])
            snap_ms.append(1e3 * (time.perf_counter() - t0))
        for _ in range(args.reps):
            t0 = time.perf_counter()
            if ck.write_once() is None:
                raise AssertionError("a snapshot was dropped")
            write_ms.append(1e3 * (time.perf_counter() - t0))
        seconds = dict(ck.seconds)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({
        "tag": args.tag, "root": str(args.root), "card": card,
        "reps": args.reps,
        "snapshot_ms_median": float(np.median(snap_ms)),
        "snapshot_ms_min": float(np.min(snap_ms)),
        "write_ms_median": float(np.median(write_ms)),
        "serialize_ms": 1e3 * seconds["serialize"] / args.reps,
        "fsync_ms": 1e3 * seconds["fsync"] / args.reps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
