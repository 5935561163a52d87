#!/usr/bin/env python3
"""Time the data-parallel step of one checkout of the port on the card:
``ShardedTrainer.fit`` over two logical shards and over one, and the
single-device ``Trainer.fit``, on the same rows.

    python3 scripts/mesh_step_timing.py [--root DIR] [--tag NAME] [--reps N]

Run on a machine with an H100.  Imports ``iotml_torch`` from ``--root``
(default: the checkout holding this script), so that two checkouts (an
earlier tree unpacked with ``git archive``, and the change) can be timed
in one call, in turns: earlier, change, change, earlier.  Uses only
entry points both sides have: ``make_mesh``, ``ShardedTrainer``,
``Trainer`` and ``SensorBatches`` over a ``RowSource``.

The slice is ``chip_smoke.py``'s main one: 100 batches of 100 normal rows
of a 100-car fleet, the reference autoencoder (18 → 14 → 7 → 7 → 18).
Each of ``--reps`` repetitions fits each trainer for one epoch, from its
own seeded init, timed on the host clock between two
``torch.cuda.synchronize()`` calls; the first repetition warms up and is
not kept.  Prints one JSON line: the median and smallest ms a step of
each trainer, with the card's name and power limit as ``nvidia-smi``
gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default=None)
    parser.add_argument("--reps", type=int, default=4)
    args = parser.parse_args()
    sys.path.insert(0, str(args.root.resolve()))
    import torch

    from iotml_torch.data.dataset import RowSource, SensorBatches
    from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
    from iotml_torch.models.autoencoder import CAR_AUTOENCODER
    from iotml_torch.parallel.data_parallel import ShardedTrainer
    from iotml_torch.parallel.mesh import make_mesh
    from iotml_torch.train.loop import Trainer

    if not torch.cuda.is_available():
        raise SystemExit("mesh_step_timing: no CUDA card")
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    batches = list(SensorBatches(RowSource.from_fleet(gen, n_ticks=300),
                                 batch_size=100, take=100, only_normal=True))
    card = torch.device("cuda", 0)

    def sharded(n):
        return lambda: ShardedTrainer(
            CAR_AUTOENCODER, make_mesh((n,), ("data",), devices=[card] * n))

    makers = {"2 shards": sharded(2), "1 shard": sharded(1),
              "Trainer": lambda: Trainer(CAR_AUTOENCODER)}
    ms = {tag: [] for tag in makers}
    for rep in range(args.reps + 1):
        for tag, make in makers.items():
            tr = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.fit(batches, epochs=1)
            torch.cuda.synchronize()
            if rep:
                ms[tag].append(1e3 * (time.perf_counter() - t0)
                               / len(batches))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "tag": args.tag, "root": str(args.root), "steps": len(batches),
        "ms_per_step_median": {k: float(np.median(v)) for k, v in ms.items()},
        "ms_per_step_min": {k: float(np.min(v)) for k, v in ms.items()},
        "card": smi.strip()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
