#!/usr/bin/env python3
"""How the fused fit (B1, "rows") and its plain version drift apart as the
order of the same rows changes, against a float64 run of the plain
version.

    python3 scripts/fit_order_sensitivity.py [--orders N] [--epochs E]

Run on a machine with an H100.  One tick of the reference's 100,000-car
fleet (the generator of ``chip_smoke.py``'s ``ksql_path``) gives 10,000
normal rows, normalized; order 0 keeps the generator's order, order k > 0
permutes the rows with seed k, as an MQTT front's connections interleave
them.  Each order is cut into 100 batches of 100 rows and fit for E
epochs from one seeded start state three ways: the kernel
(``fused_fit`` on the card), its plain version in float32
(``fused_fit_reference`` on the card) and the plain version with the
params, moments and rows in float64.  Prints one JSON line an order:
each epoch's loss from the three fits, the largest relative loss
difference of kernel vs plain, kernel vs float64 and plain vs float64,
whether the kernel passes ``chip_smoke.check_fit``'s bounds against the
plain version, and its first failing epoch; then a summary line with the
card's name and power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from iotml_torch.core.normalize import CAR_NORMALIZER  # noqa: E402
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario  # noqa: E402
from iotml_torch.models.autoencoder import CAR_AUTOENCODER, PARAM_NAMES  # noqa: E402
from iotml_torch.ops import fused_train  # noqa: E402
from iotml_torch.train.loop import Trainer, TrainState  # noqa: E402
from iotml_torch.train.optim import AdamState  # noqa: E402

METRIC_TOL = dict(rtol=2e-4, atol=1e-6)  # chip_smoke.py's fit bounds
STATE_TOL = dict(rtol=5e-3, atol=2e-5)


def _rows() -> np.ndarray:
    gen = FleetGenerator(FleetScenario(num_cars=100_000, failure_rate=0.01))
    cols = gen.step_columns()
    x = CAR_NORMALIZER.np(gen.sensor_matrix(cols))
    return x[cols["failure_occurred"] == "false"][:10_000].astype(np.float32)


def _cast(state: TrainState, dtype) -> TrainState:
    def tree(t):
        return {k: t[k].to(dtype) for k in PARAM_NAMES}
    o = state.opt_state
    return TrainState(step=state.step, params=tree(state.params),
                      opt_state=AdamState(count=o.count, mu=tree(o.mu),
                                          nu=tree(o.nu)))


def _within(got, want, rtol, atol) -> bool:
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--orders", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rows = _rows()
    trainer = Trainer(CAR_AUTOENCODER)
    trainer._ensure_state()
    start = trainer.state
    masks = torch.ones(100, 100, device="cuda")
    fails = 0
    for order in range(args.orders):
        x = rows if order == 0 else \
            rows[np.random.default_rng(order).permutation(len(rows))]
        xs = torch.from_numpy(x.reshape(100, 100, 18)).cuda()
        k_state, k_loss, _ = fused_train.fused_fit(start, xs, masks,
                                                   args.epochs)
        p_state, p_loss, _ = fused_train.fused_fit_reference(
            start, xs, masks, args.epochs)
        d_state, d_loss, _ = fused_train.fused_fit_reference(
            _cast(start, torch.float64), xs.double(), masks.double(),
            args.epochs)
        k, p, d = (t.double().cpu() for t in (k_loss, p_loss, d_loss))

        def rel(a, b):
            return float(((a - b).abs() / b.abs()).max())

        ok_loss = [_within(k[e], p[e], **METRIC_TOL)
                   for e in range(args.epochs)]
        ok_state = all(_within(getattr(k_state, part)[key].double().cpu(),
                               getattr(p_state, part)[key].double().cpu(),
                               **STATE_TOL)
                       for part in ("params",) for key in PARAM_NAMES)
        passed = all(ok_loss) and ok_state
        fails += not passed
        print(json.dumps({
            "order": order, "card": card,
            "loss_kernel": k.tolist(), "loss_plain": p.tolist(),
            "loss_float64": d.tolist(),
            "max_rel_kernel_vs_plain": rel(k, p),
            "max_rel_kernel_vs_float64": rel(k, d),
            "max_rel_plain_vs_float64": rel(p, d),
            "passes_fit_bounds": passed,
            "first_failing_epoch": None if all(ok_loss)
            else ok_loss.index(False)}), flush=True)
    print(json.dumps({"summary": True, "card": card, "orders": args.orders,
                      "epochs": args.epochs, "failing_orders": fails}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
