#!/usr/bin/env python3
"""Time the split-TF32 flash forward kernel against variants of itself,
to see what bounds it.

    python3 scripts/fwd_tf32_variants.py [--reps 5]

Run from the repository root on a machine with an H100 and ``nvcc``.
Builds ``iotml_torch/ops/csrc/flash_attention.cu`` once per variant, each
from a copy of the source and headers under
``iotml_torch/ops/build/variants/<name>/`` with its text edits
(``_build.build_variant``; one ``nvcc`` each, started together), and
fails on an edit that matches nothing or a ptxas spill in the source as
built (the variants report theirs).  The variants:

- ``as_built``: the source as it is (p = exp2f((s − m)·log2 e));
- ``one_tile_a_warp``: each warp holds one m16 query tile, not two (64
  query rows a block, three blocks an SM);
- ``three_blocks``: three blocks an SM (at most 168 registers a thread);
- ``step_32``: key steps of 32 rows, not 64 (half the S registers),
  three blocks an SM;
- ``expf``: p = expf(s − m), the accurate expf, in place of exp2f;
- ``one_mma`` (diagnostic, wrong results): one tf32 product in place of
  three, to see what the mmas cost;
- ``no_exp`` (diagnostic, wrong results): p = s − m, no exp.

Each exact variant must hold O and LSE at rtol = atol = 2e-5 against the
plain forward (f32, D = 8 and 16, B·H = 6, causal T = 65 and 1,000, full
T = 64 and 1,000); one that does not is reported, not shipped.  Then, at
the SensorFormer layer call (f32, B=100, T=4,096, H=4, D=16, seeded
normal inputs as ``chip_smoke.py`` times them), causal and full, every
variant's forward is timed with CUDA events, in the order above and then
reversed.  Prints one JSON line per variant (registers, shared error,
windows), then the card's name and power limit.
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

from chip_smoke import cuda_ms  # noqa: E402
from iotml_torch.ops import _build  # noqa: E402
from iotml_torch.ops import attention as attn  # noqa: E402

NAME = "flash_attention"
SOURCE = f"{NAME}.cu"
HEADER = "mma_tf32.cuh"
P_EXP = "const float p = exp2f((s[i][j][e] - mx) * kLog2e);"
#: name: (exact, [(file, old text, new text)])
VARIANTS = {
    "as_built": (True, []),
    "one_tile_a_warp": (True, [
        (SOURCE, "constexpr int kMT = 2;", "constexpr int kMT = 1;"),
        (SOURCE, "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 3;")]),
    "three_blocks": (True, [(SOURCE, "constexpr int kMinBlocks = 2;",
                             "constexpr int kMinBlocks = 3;")]),
    "step_32": (True, [
        (SOURCE, "constexpr int kStep = 64;", "constexpr int kStep = 32;"),
        (SOURCE, "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 3;")]),
    "expf": (True, [(SOURCE, P_EXP,
                     "const float p = expf(s[i][j][e] - mx);")]),
    "one_mma": (False, [(HEADER, """  mma(d, a_lo, b.hi0, b.hi1);
  mma(d, a_hi, b.lo0, b.lo1);
  mma(d, a_hi, b.hi0, b.hi1);""", """  mma(d, a_hi, b.hi0, b.hi1);""")]),
    "no_exp": (False, [(SOURCE, P_EXP,
                        "const float p = s[i][j][e] - mx;")]),
}
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
LAYER = (100, 4096, 4, 16)


def _split_kernel(mangled: str):
    found = re.match(r"\S*flash_fwd_mma_kernelILi(\d+)ELb([01])E", mangled)
    if found:
        return (f"D={found.group(1)} "
                f"{'causal' if found.group(2) == '1' else 'full'}")
    return None


def build(name: str):
    """The variant's library and the ptxas registers and spilled bytes of
    its split-TF32 forward kernels; raises on a failed build, an edit that
    matches nothing or a spill in the source as built."""
    _, edits = VARIANTS[name]
    lib, log = _build.build_variant(NAME, name, edits)
    regs = _build.ptxas_kernels(log, _split_kernel)
    spilled = [k for k, v in regs.items()
               if v.get("spill_stores") or v.get("spill_loads")]
    if spilled and not edits:
        raise AssertionError(f"{name}: ptxas spills in {spilled}")
    return attn._bind(ctypes.CDLL(str(lib)), attn._FWD_ENTRIES), regs


def launch(lib, folded, causal: bool):
    qf = folded[0]
    BH, T, D = qf.shape
    o = torch.empty_like(qf)
    lse = torch.empty((BH, T), device=qf.device)
    err = lib.iotml_flash_fwd(*(t.data_ptr() for t in (*folded, o, lse)),
                              BH, T, D, 0, int(causal), 1.0 / math.sqrt(D),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"forward launch failed: CUDA error {err}")
    return o, lse


def share_of_tol(lib) -> float:
    """The largest error of a variant's O and LSE, as a share of FWD_TOL."""
    worst = 0.0
    for D in (8, 16):
        for T, causal in ((65, True), (1000, True), (64, False),
                          (1000, False)):
            rng = np.random.default_rng(T + D)
            q, k, v = (torch.from_numpy(rng.normal(
                size=(2, T, 3, D)).astype(np.float32)).cuda()
                for _ in range(3))
            o, lse = launch(lib, [attn._fold(t) for t in (q, k, v)], causal)
            block = 128 if causal else T
            want_o, want_lse = attn.flash_attention_reference(
                q, k, v, causal, block, block)
            for got, w in ((o, attn._fold(want_o)),
                           (lse, want_lse.reshape(lse.shape))):
                share = ((got - w).abs()
                         / (FWD_TOL["atol"] + FWD_TOL["rtol"] * w.abs()))
                worst = max(worst, float(share.max()))
    return worst


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("fwd_tf32_variants: no CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    lines = {name: {"variant": name, "exact": VARIANTS[name][0],
                    "registers": regs}
             for name, (_, regs) in built.items()}
    for name, (lib, _) in built.items():
        if VARIANTS[name][0]:
            share = share_of_tol(lib)
            lines[name]["max_share_of_fwd_tol"] = share
            lines[name]["holds_fwd_tol"] = share <= 1.0
    rng = np.random.default_rng(1)
    folded = [attn._fold(torch.from_numpy(rng.normal(size=LAYER).astype(
        np.float32)).cuda()) for _ in range(3)]
    names = list(VARIANTS)
    for causal in (True, False):
        entry = "causal" if causal else "full"
        for name in names + names[::-1]:
            def fn(lib=built[name][0]):
                return launch(lib, folded, causal)
            fn()
            torch.cuda.synchronize()
            lines[name].setdefault(f"{entry}_ms", []).append(
                cuda_ms(fn, args.reps))
    for line in lines.values():
        print(json.dumps(line), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
