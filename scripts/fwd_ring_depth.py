#!/usr/bin/env python3
"""Time the tensor-core flash forward at each depth of its K/V ring.

    python3 scripts/fwd_ring_depth.py [--stages 3 4 5] [--reps 10]

Run from the repository root on a machine with an H100 and ``nvcc``.
Builds ``iotml_torch/ops/csrc/flash_attention.cu`` once per depth, with
its ``constexpr int kStages`` set to the depth in a copy of the source
and headers under ``iotml_torch/ops/build/variants/ring<n>/``
(``_build.build_variant``; one ``nvcc`` each, started together), and
fails on a ptxas spill.  Then, at the
long-context shape (bf16, B=1, T=65,536, H=2, D=128, seeded normal
inputs as ``chip_smoke.py`` times them), causal and full: every depth
must give the same o and lse bit for bit (the depth moves when tiles
load, not what is computed), and each depth is timed with CUDA events in
two windows, in the order of ``--stages`` and then reversed.  Prints one
JSON line per depth and entry (both windows, shared memory a block,
registers), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from iotml_torch.ops import _build  # noqa: E402
from iotml_torch.ops import attention as attn  # noqa: E402

B, T, H, D = 1, 65536, 2, 128
STAGES = re.compile(r"constexpr int kStages = \d+;")


def _wgmma_entry(mangled: str):
    found = re.match(r"\S*flash_fwd_wgmma_kernelILb([01])E", mangled)
    if found:
        return "causal" if found.group(1) == "1" else "full"
    return None


def build(stages: int) -> tuple:
    """The library at ``stages``, and the registers of its two tensor-core
    entries; raises on a failed build or a spill."""
    found = STAGES.findall((_build.CSRC / "flash_attention.cu").read_text())
    if len(found) != 1:
        raise RuntimeError("flash_attention.cu: no single kStages to set")
    out, log = _build.build_variant(
        "flash_attention", f"ring{stages}",
        [("flash_attention.cu", found[0],
          f"constexpr int kStages = {stages};")])
    if re.search(r"[1-9]\d* bytes spill", log):
        raise RuntimeError(f"ring {stages}: ptxas spills\n{log}")
    registers = {entry: v["registers"] for entry, v in
                 _build.ptxas_kernels(log, _wgmma_entry).items()}
    lib = attn._bind(ctypes.CDLL(str(out)), attn._FWD_ENTRIES)
    return lib, registers


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--stages", type=int, nargs="+", default=[3, 4, 5])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_ring_depth: needs a CUDA card")
    with ThreadPoolExecutor(len(args.stages)) as pool:
        libs = dict(zip(args.stages, pool.map(build, args.stages)))

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(B * H, T, D)).astype(
        np.float32)).to("cuda", torch.bfloat16) for _ in range(3))
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib, causal, o, lse):
        err = lib.iotml_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), lse.data_ptr(), B * H, T, D,
                                  1, int(causal), 1.0 / math.sqrt(D), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    def window(lib, causal, o, lse) -> float:
        run(lib, causal, o, lse)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run(lib, causal, o, lse)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    for causal in (True, False):
        entry = "causal" if causal else "full"
        outs = {s: (torch.empty_like(q), torch.empty((B * H, T),
                                                     device="cuda"))
                for s in args.stages}
        for s, (lib, _) in libs.items():
            run(lib, causal, *outs[s])
        torch.cuda.synchronize()
        first = outs[args.stages[0]]
        for s, (o, lse) in outs.items():
            if not (torch.equal(o, first[0]) and torch.equal(lse, first[1])):
                raise AssertionError(f"{entry}: ring {s} differs from ring "
                                     f"{args.stages[0]}")
        times = {s: [] for s in args.stages}
        for s in args.stages + args.stages[::-1]:
            times[s].append(window(libs[s][0], causal, *outs[s]))
        for s, (lib, registers) in libs.items():
            print(json.dumps({
                "entry": entry, "stages": s, "ms": times[s],
                "smem_bytes": lib.iotml_flash_fwd_smem(D, 1),
                "registers": registers.get(entry), "same_bits": True,
                "shape": [B, T, H, D], "card": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
