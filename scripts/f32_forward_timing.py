#!/usr/bin/env python3
"""Time the float32 flash forward kernel, the SensorFormer forward and
the SensorFormer training step of one checkout of the port.

    python3 scripts/f32_forward_timing.py [--root DIR] [--tag NAME]

Run on a machine with an H100 and ``nvcc``.  Imports ``iotml_torch`` from
``--root`` (default: the checkout holding this script), so that two
checkouts (a parent commit unpacked with ``git archive``, and the change)
can be timed in one call, in turns: parent, change, change, parent.
Uses only entry points both sides have: ``flash_attention_fwd``,
``flash_attention_reference``, ``flash_design``, ``SensorFormer`` and
``make_sp_train_step``, and the root's own ``chip_smoke.cuda_ms`` and
``chip_smoke.fleet_histories``.

At the SensorFormer layer call (f32, B=100, T=4,096, H=4, D=16, seeded
normal inputs as ``chip_smoke.py`` times them), causal and full: the
forward kernel, held once against its plain version (O and LSE at rtol =
atol = 2e-5), then timed with CUDA events over 5 warm launches in two
windows.  Then SensorFormer at its defaults on 100 cars' 4,096-tick fleet
histories: the forward (with ``anomaly_scores``, as ``chip_smoke.py``
times it) over 5 warm calls, and ``make_sp_train_step`` (Adam lr 1e-3):
one warm step, then 5 timed steps (step ms and trained steps per second,
cars × 4,095 targets over the step time); the losses must be finite and
fall.  Prints one JSON line with the card's name and power limit as
``nvidia-smi`` gives them.
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
FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def kernel_times() -> dict:
    from chip_smoke import cuda_ms
    from iotml_torch.ops.attention import (flash_attention_fwd,
                                           flash_attention_reference,
                                           flash_design)

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=LAYER).astype(np.float32))
               .cuda() for _ in range(3))
    out = {"design": flash_design(torch.float32, LAYER[3], "forward")}
    for causal in (True, False):
        entry = "causal" if causal else "full"

        def kernel():
            return flash_attention_fwd(q, k, v, causal, 128, 128)

        o, lse = kernel()
        want_o, want_lse = flash_attention_reference(q, k, v, causal, 128,
                                                     128)
        torch.testing.assert_close(o, want_o, **FWD_TOL)
        torch.testing.assert_close(lse, want_lse, **FWD_TOL)
        del want_o, want_lse
        torch.cuda.synchronize()
        out[f"{entry}_ms"] = [cuda_ms(kernel, REPS), cuda_ms(kernel, REPS)]
    return out


def model_times() -> dict:
    from chip_smoke import cuda_ms, fleet_histories
    from iotml_torch.models.transformer import SensorFormer
    from iotml_torch.parallel.seq_parallel import make_sp_train_step
    from iotml_torch.train.optim import Adam

    hist = fleet_histories(CARS, TICKS)
    scorer = SensorFormer(attn_mode="flash").eval()
    x = torch.from_numpy(hist).to(scorer.head.weight.device)

    def forward():
        with torch.no_grad():
            return SensorFormer.anomaly_scores(scorer(x), x)

    scores = forward()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError("scores not finite")
    forward_ms = cuda_ms(forward, REPS)
    del scorer, scores
    torch.cuda.empty_cache()

    model = SensorFormer(attn_mode="flash")
    init, step, put_x = make_sp_train_step(model, Adam(1e-3))
    x = put_x(hist)
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
    steps = CARS * (TICKS - 1)
    return {"forward_ms": forward_ms,
            "scored_steps_per_s": steps / (forward_ms / 1e3),
            "step_ms": step_ms,
            "trained_steps_per_s": steps / (step_ms / 1e3),
            "losses": losses}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--tag", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_forward_timing: no CUDA card")
    sys.path.insert(0, str(args.root.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"tag": args.tag or str(args.root), "card": card,
                      "layer": dict(zip("BTHD", LAYER)),
                      "forward_kernel": kernel_times(), **model_times()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
