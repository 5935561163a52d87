#!/usr/bin/env python3
"""Time the split-TF32 flash backward kernels against variants of
themselves, to see what bounds them.

    python3 scripts/bwd_tf32_variants.py [--reps 5]

Run from the repository root on a machine with an H100 and ``nvcc``.
Builds ``iotml_torch/ops/csrc/flash_attention_bwd.cu`` once per variant,
each from a copy of the source and headers under
``iotml_torch/ops/build/variants/<name>/`` with its text edits
(``_build.build_variant``; one ``nvcc`` each, started together), and
fails on an edit that matches nothing or a ptxas spill in an exact
variant (a diagnostic one reports its spills).  The variants:

- ``as_built``: the source as it is;
- ``cvt_rna``: the split rounds with ``cvt.rna.tf32.f32`` (ties away,
  emulated by ptxas) in place of ``cvt.rn.tf32.f32`` (one instruction);
- ``one_tile_a_warp``: each warp holds one m16 tile, not two (three
  blocks an SM);
- ``one_mma`` (diagnostic, wrong results): one tf32 product in place of
  three, to see what the mmas cost;
- ``no_expf`` (diagnostic, wrong results): p = s·scale − lse, no exp.

Each exact variant must hold dq, dk and dv at rtol 1e-4 / atol 1e-5
against the plain backward (f32, D = 8 and 16, B·H = 6, causal T = 65 and
1,000, full T = 17 and 1,000).  Then, at the SensorFormer layer call (f32,
B=100, T=4,096, H=4, D=16, seeded normal inputs as ``chip_smoke.py`` times
them), causal and full, every variant's dK/dV and dQ kernels are timed
with CUDA events in two windows, in the order above and then reversed.
Prints one JSON line per variant (registers, windows), then the card's
name and power limit.
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

NAME = "flash_attention_bwd"
SOURCE = f"{NAME}.cu"
HEADER = "mma_tf32.cuh"
#: name: (exact, [(file, old text, new text)])
VARIANTS = {
    "as_built": (True, []),
    "cvt_rna": (True, [(HEADER, "cvt.rn.tf32.f32", "cvt.rna.tf32.f32")]),
    "one_tile_a_warp": (True, [
        (SOURCE, "constexpr int kMT = 2;", "constexpr int kMT = 1;"),
        (SOURCE, "constexpr int kMinBlocks = 2;",
         "constexpr int kMinBlocks = 3;")]),
    "one_mma": (False, [(HEADER, """  mma(d, a_lo, b.hi0, b.hi1);
  mma(d, a_hi, b.lo0, b.lo1);
  mma(d, a_hi, b.hi0, b.hi1);""", """  mma(d, a_hi, b.hi0, b.hi1);""")]),
    "no_expf": (False, [(SOURCE, """      p = in ? expf(in ? arg : 0.f) : 0.f;
    } else {
      p = expf(arg);
    }""", """      p = in ? arg : 0.f;
    } else {
      p = arg;
    }""")]),
}
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LAYER = (100, 4096, 4, 16)


def _split_kernel(mangled: str):
    found = re.match(r"\S*(flash_\w+)_mma_kernelILi(\d+)ELb([01])E", mangled)
    if found:
        return (f"{found.group(1)} D={found.group(2)} "
                f"{'causal' if found.group(3) == '1' else 'full'}")
    return None


def build(name: str):
    """The variant's library and the ptxas registers and spilled bytes of
    its split-TF32 kernels; raises on a failed build, an edit that
    matches nothing or a spill in an exact variant."""
    exact, edits = VARIANTS[name]
    lib, log = _build.build_variant(NAME, name, edits)
    regs = _build.ptxas_kernels(log, _split_kernel)
    spilled = [k for k, v in regs.items()
               if v.get("spill_stores") or v.get("spill_loads")]
    if spilled and exact:
        raise AssertionError(f"{name}: ptxas spills in {spilled}")
    return attn._bind(ctypes.CDLL(str(lib)), attn._BWD_ENTRIES), regs


def launch(lib, kind: str, folded, causal: bool):
    qf = folded[0]
    BH, T, D = qf.shape
    outs = tuple(torch.empty_like(qf)
                 for _ in range(2 if kind == "dkv" else 1))
    fn = lib.iotml_flash_bwd_dkv if kind == "dkv" else lib.iotml_flash_bwd_dq
    err = fn(*(t.data_ptr() for t in (*folded, *outs)), BH, T, D, 0,
             int(causal), 1.0 / math.sqrt(D),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{kind} launch failed: CUDA error {err}")
    return outs


def check(name: str, lib) -> float:
    """The largest error of an exact variant, as a share of GRAD_TOL."""
    worst = 0.0
    for D in (8, 16):
        for T, causal in ((65, True), (1000, True), (17, False),
                          (1000, False)):
            rng = np.random.default_rng(T + D)
            q, k, v, do = (torch.from_numpy(rng.normal(
                size=(2, T, 3, D)).astype(np.float32)).cuda()
                for _ in range(4))
            o, lse = attn.flash_attention_fwd(q, k, v, causal, T, T)
            folded = attn.flash_bwd_inputs(q, k, v, o, lse, do)
            dk, dv = launch(lib, "dkv", folded, causal)
            (dq,) = launch(lib, "dq", folded, causal)
            block = 128 if causal else T
            want = attn.flash_attention_backward_reference(
                q, k, v, o, lse, do, causal, block, block)
            for got, w in zip((dq, dk, dv), want):
                w = attn._fold(w)
                share = ((got - w).abs()
                         / (GRAD_TOL["atol"] + GRAD_TOL["rtol"] * w.abs()))
                worst = max(worst, float(share.max()))
    if worst > 1.0:
        raise AssertionError(f"{name}: {worst:.3f} × the tolerance")
    return worst


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_tf32_variants: no CUDA card")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    lines = {name: {"variant": name, "exact": VARIANTS[name][0],
                    "registers": regs}
             for name, (_, regs) in built.items()}
    for name, (lib, _) in built.items():
        if VARIANTS[name][0]:
            lines[name]["max_share_of_grad_tol"] = check(name, lib)
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=LAYER).astype(np.float32))
               .cuda() for _ in range(3))
    do = torch.from_numpy(np.random.default_rng(2).normal(
        size=LAYER).astype(np.float32)).cuda()
    names = list(VARIANTS)
    for causal in (True, False):
        entry = "causal" if causal else "full"
        o, lse = attn.flash_attention_fwd(q, k, v, causal, 128, 128)
        folded = attn.flash_bwd_inputs(q, k, v, o, lse, do)
        for name in names + names[::-1]:
            for kind in ("dkv", "dq"):
                def fn(lib=built[name][0], kind=kind):
                    return launch(lib, kind, folded, causal)
                fn()
                torch.cuda.synchronize()
                lines[name].setdefault(f"{kind}_{entry}_ms", []).append(
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
