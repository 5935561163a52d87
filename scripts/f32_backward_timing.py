#!/usr/bin/env python3
"""Time the float32 flash backward kernels and the SensorFormer training
step of one checkout of the port.

    python3 scripts/f32_backward_timing.py [--root DIR] [--tag NAME]

Run on a machine with an H100 and ``nvcc``.  Imports ``iotml_torch`` from
``--root`` (default: the checkout holding this script), so that two
checkouts (a parent commit unpacked with ``git archive``, and the change)
can be timed in one call, in turns: parent, change, change, parent.
Uses only entry points both sides have: ``flash_bwd_inputs``,
``flash_bwd_dkv``, ``flash_bwd_dq``, ``flash_attention_fwd``,
``SensorFormer`` and ``make_sp_train_step``, and the root's own
``chip_smoke.cuda_ms`` and ``chip_smoke.fleet_histories``.

At the SensorFormer layer call (f32, B=100, T=4,096, H=4, D=16, seeded
normal inputs as ``chip_smoke.py`` times them), causal and full: the
dK/dV and dQ kernels, each timed with CUDA events over 5 warm launches in
two windows.  Then SensorFormer at its defaults, trained with
``make_sp_train_step`` (Adam lr 1e-3) on 100 cars' 4,096-tick fleet
histories: one warm step, then 5 timed steps (step ms and trained steps
per second, cars × 4,095 targets over the step time); the losses must be
finite and fall.  Prints one JSON line with the card's name and power
limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

LAYER = (100, 4096, 4, 16)  # B, T, H, D
CARS, TICKS = 100, 4096
REPS, STEPS = 5, 5


def kernel_times() -> dict:
    from chip_smoke import cuda_ms
    from iotml_torch.ops.attention import (flash_attention_fwd,
                                           flash_bwd_dkv, flash_bwd_dq,
                                           flash_bwd_inputs)

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=LAYER).astype(np.float32))
               .cuda() for _ in range(3))
    do = torch.from_numpy(np.random.default_rng(2).normal(
        size=LAYER).astype(np.float32)).cuda()
    out = {}
    for causal in (True, False):
        entry = "causal" if causal else "full"
        o, lse = flash_attention_fwd(q, k, v, causal, 128, 128)
        folded = flash_bwd_inputs(q, k, v, o, lse, do)

        def dkv():
            return flash_bwd_dkv(*folded, causal=causal)

        def dq():
            return flash_bwd_dq(*folded, causal=causal)

        grads = (*dkv(), dq())
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"{entry}: grads not finite")
        out[entry] = {"dkv_ms": [cuda_ms(dkv, REPS), cuda_ms(dkv, REPS)],
                      "dq_ms": [cuda_ms(dq, REPS), cuda_ms(dq, REPS)]}
    return out


def train_step_time() -> dict:
    from chip_smoke import fleet_histories
    from iotml_torch.models.transformer import SensorFormer
    from iotml_torch.parallel.seq_parallel import make_sp_train_step
    from iotml_torch.train.optim import Adam

    model = SensorFormer(attn_mode="flash")
    init, step, put_x = make_sp_train_step(model, Adam(1e-3))
    x = put_x(fleet_histories(CARS, TICKS))
    state = init()
    state, metrics = step(state, x)  # warm
    losses = [metrics["loss"]]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS):
        state, metrics = step(state, x)
        losses.append(metrics["loss"])
    end.record()
    end.synchronize()
    losses = torch.stack(losses).cpu().tolist()
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"training did not converge: {losses}")
    step_ms = start.elapsed_time(end) / STEPS
    return {"step_ms": step_ms,
            "trained_steps_per_s": CARS * (TICKS - 1) / (step_ms / 1e3),
            "losses": losses}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_backward_timing: no CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": args.tag or str(args.root), "card": card,
                      "layer": dict(zip("BTHD", LAYER)),
                      "kernels": kernel_times(), **train_step_time()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
