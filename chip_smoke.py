#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``iotml_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each phase prints one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device     — card name, count, ``nvidia-smi`` name and power limit;
                TF32 switched off for matmul and cuDNN.
2. build      — the three CUDA sources built from the checkout, one
                ``nvcc`` each, and the native stream engine (one ``g++``
                of ``iotml_torch/cpp``), started together (seconds per
                source;
                ptxas registers and spills per instantiation, a spill in
                a flash kernel or a rows fit kernel fails the run, and so
                does a missing split-TF32 instantiation, forward (four) or
                backward (eight); the fit kernel's
                shared memory per design at B=100; the flash kernels'
                shared memory per block, dtype and head dim; HGMMA
                instructions in the SASS of each ``wgmma`` instantiation,
                forward and backward, and HMMA…TF32 in each of the twelve
                split-TF32 ones, none fails the run; the fit kernel's
                design over a
                grid of shapes, the library's ``iotml_fused_fit_design``
                and ``fit_design``'s, and the design of each dtype and
                head dim in both attention directions, the libraries'
                and ``flash_design``'s; each pair must agree, and each
                direction must take all three designs).
3. kernel     — the fused-fit kernel against its plain PyTorch version on
                the card: the rows design at B=100, F=18 and F=30, 0/1
                and fractional masks, and at B=256 (its largest), F=30;
                the elements design at B=300, F=18 (each taken by
                ``fit_design``'s rule); 6 batches × 4
                epochs, ragged last batch; runs repeat bit for bit; 2 + 2
                epochs equal 4.
4. main_path  — the reference job at full width and shape: a 100-car
                fleet for 300 ticks (30,000 rows), train on 100 batches
                of 100 normal rows for 20 epochs (``fit_compiled``, one
                kernel launch, through the rows design), then score
                batches 100..199 (10,000 rows) with threshold 5, the
                payloads formatted by the native engine.
5. cli_path   — the same job through its own CLI,
                ``iotml_torch.cli.cardata.main``: ``train`` on
                ``emulator:30000`` (the in-process broker, Avro published
                and decoded by the native engine) to a temporary artifact
                root, then ``predict``.  Train launches the fit kernel
                exactly once, through the rows design (counts set to 0
                just before, read just after), losses finite and falling;
                the stored checkpoint restores to the trained state
                exactly and carries the committed cursor; predict writes
                10,000 payloads to ``model-predictions``, the first 100
                within atol 2e-6 of a CPU recompute from the restored
                params and all 10,000 within 1e-5 (index order), every
                payload the engine's string, byte-identical to
                ``np.array2string`` of the scored rows; the engine
                carried every decode, its decode of predict's 20,000
                messages equal to the pure codec's (``ops.avro``)
                exactly, and it formatted exactly the rows its fast path
                takes (``fastfmt.fast_rows``).  Train and
                predict seconds, ``fit_seconds``, decode and format
                seconds, scored rows/s, and ``format_rows`` against
                per-row ``np.array2string`` and the per-element plain
                version on those 10,000 rows.
6. timing     — each design held against the plain version over the
                whole fit at that shape (all 20 epochs' loss and
                accuracy, the final params, mu and nu), then each
                design's time per fit (CUDA events over warm launches,
                timed in turns: rows, elements, elements, rows) beside
                the plain version's, the autograd step loop's
                (``fused="never"``), the bound and the one-SM bound (the
                same flops at one SM's share of the fp32 rate: a fit is
                one block); the same again at B=256 on the same fleet
                slice (39 batches, 20 epochs).
7. attention_kernel — the flash-attention kernel against its plain
                version on the card, both entry points, O and LSE: f32
                D=8 (causal T=40 with blocks 16, non-causal T=32), f32
                D=16 (causal, B=2, H=4, T=4096), bf16 D=128 H=2 (causal
                T=1000, non-causal T=1024); then the split-TF32 design's
                cases (f32 D=8 and 16, causal and full, T = 1, 15, 16,
                17, 63, 64, 65, 127, 128, 129, 1000 and 4096 at B·H = 1
                and 6, the plain version at blocks 128 when causal and at
                block T when full), each checked to take the
                ``mma_tf32x3`` design, O and LSE at rtol = atol = 2e-5,
                their largest O and LSE errors apart; then the
                tensor-core design's cases (bf16 D=128, the plain
                version at blocks 64, the kernel's key tile: causal
                T = 1, 63, 64, 65, 127, 128,
                129, 1000, 4096 at B·H = 1 and 6, non-causal T = 64 and
                1024 at B·H = 6, and non-causal T = 1,040 with the
                caller's block 16, a ragged key tile), each checked to
                take the ``wgmma`` design, their largest O and LSE errors
                apart; the ``wgmma`` design is held by
                ``flash_parity.check_wgmma_forward`` (O element by element
                and row by row), which must fail its O scaled by 0.9,
                whole or in its last row; a second launch repeats the
                first bit for bit; a ragged non-causal call raises.
8. sensorformer_path — SensorFormer at full width (its defaults) scores
                100 cars' 4,096-tick fleet histories: one forward with
                attn_mode="flash" (2 causal kernel launches), held
                against the same weights with the kernel's plain version
                (all cars) and dense attention (4 cars); forward ms and
                scored steps per second.
9. attention_timing — kernel, plain version, bound and the library
                yardstick (``scaled_dot_product_attention``) at the
                model's per-layer call (f32, B=100, T=4096, H=4, D=16)
                and the long-context shape (bf16, B=1, T=65,536, H=2,
                D=128; plain version at blocks 1024), causal and not;
                each line with the kernel's design and achieved TFLOP/s
                (its bound's flops over its time).  The bound
                (``attention_bound``) is the larger of the bytes over the
                memory rate and the flops on the tensor cores: bf16 at
                its peak, f32 as split TF32 (3 × the flops at the TF32
                peak); beside it the fp32 FMA floor and the ex2 floor.
10. attention_backward_kernel — the dK/dV and dQ kernels against the
                plain backward on the card, both entry points, dq, dk and
                dv: the attention_kernel shapes with a seeded random dO,
                then the split-TF32 design's cases (f32 D=8 and 16,
                causal and full, T = 1, 15, 16, 17, 63, 64, 65, 1000 and
                4096 at B·H = 1 and 6, each checked to take the
                ``mma_tf32x3`` design), then the tensor-core design's
                cases (bf16 D=128, plain
                blocks 64: causal T = 1, 63, 64, 65, 1000, 4096 at
                B·H = 1 and 6, non-causal T = 64 and 1024 at B·H = 6,
                causal B=2 H=2 T=4096), each checked to take the
                ``wgmma`` design, those of T ≥ 1000 again on inputs
                rounded to a 1/4 grid, and a call that needs only dk (no
                dQ launch); at the f32 D=8 shapes also against autograd
                through the dense reference; a bf16 row outside the
                tolerance passes only as one p or ds rounding flip
                (``flash_parity.bwd_rounding_flips``, none on the grid),
                and each flip is printed; a second launch repeats the
                first bit for bit; a ragged non-causal call raises.
11. sensorformer_train — the slice's main path: ``make_sp_train_step``
                Adam steps (lr 1e-3) of SensorFormer at full width on the
                fleet histories of phase 8; each step launches exactly
                ``num_layers`` causal forwards, dK/dV and dQ kernels; step
                1's loss and every parameter's grad held against the same
                weights with the plain versions (all cars) and dense
                attention (4 cars); losses finite and falling; step ms
                and trained steps per second.
12. attention_backward_timing — each backward kernel, the plain
                backward, the port's forward + backward and the library's
                (``scaled_dot_product_attention`` through autograd) at the
                shapes of phase 9, beside the bound, the fp32 FMA floor
                and the ex2 floor; each kernel's design and achieved
                TFLOP/s (its bound's flops over its time),
                and ``flash_attention_fwd_bwd_tokens_per_sec`` (T over the
                port's forward + backward seconds, as bench.py's
                long-context line).  The port's forward + backward is the
                long-context path: ``flash_attention`` through autograd,
                its forward in the design ``flash_design`` names (the
                tensor-core one at bf16 D=128); one such call runs with
                every launch count set to 0 just before it and read just
                after (exactly one forward, one dK/dV and one dQ launch).
Then the kernels line (the fit's design, and its launches by design on
the main path and by path, the main path and the CLI path, summed in
``launches``; each attention entry's design at the layer call and the
long-context call; ``launches`` sums the counts read on the paths that
run the entry: the SensorFormer forward (phase 8), the training steps
(phase 11) and the long-context forward + backward (phase 12), each also
given by path), the ``nvidia-smi`` line, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from iotml_torch.cli import _app as cli_app
from iotml_torch.cli import cardata
from iotml_torch.core.normalize import CAR_NORMALIZER
from iotml_torch.core.schema import KSQL_CAR_SCHEMA
from iotml_torch.data.dataset import RowSource, SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import (CAR_AUTOENCODER,
                                            CREDITCARD_AUTOENCODER,
                                            PARAM_NAMES, reconstruction_error)
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops import _build, fused_train
from iotml_torch.ops.attention import (FLASH_DESIGNS, attention_reference,
                                       flash_attention,
                                       flash_attention_backward_reference,
                                       flash_attention_bwd,
                                       flash_attention_fwd,
                                       flash_attention_reference,
                                       flash_bwd_dkv, flash_bwd_dq,
                                       flash_bwd_inputs, flash_design,
                                       flash_smem)
from iotml_torch.ops.avro import AvroCodec
from iotml_torch.ops.flash_parity import (bwd_rounding_flips,
                                          check_rejects_scaled_o,
                                          check_wgmma_forward)
from iotml_torch.ops.framing import strip_frame
from iotml_torch.parallel.seq_parallel import (loss_and_grads,
                                               make_sp_train_step)
from iotml_torch.serve import fastfmt
from iotml_torch.serve import scorer as scorer_module
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream import native
from iotml_torch.stream.consumer import StreamConsumer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.artifacts import ArtifactStore
from iotml_torch.train.checkpoint import CheckpointManager
from iotml_torch.train.loop import Trainer, TrainState, make_scanned_fit
from iotml_torch.train.optim import Adam

#: the JAX suite's own fused-vs-scanned bounds (tests/test_fused_train.py)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
RESUME_TOL = dict(rtol=1e-4, atol=1e-7)
#: flash forward against its plain version, FMA and split-TF32 designs:
#: f32 is the JAX suite's flash forward bound (tests/test_attention.py:
#: 56-57); bf16 allows for P being rounded at the running max of tiles
#: that differ in size.
#: The ``wgmma`` design is held by ``flash_parity.check_wgmma_forward``
#: (each O row within 1e-2 of its norm; O rtol 2e-2 / atol 1e-3 against
#: the plain version at the kernel's key tile, blocks 64).
ATTN_TOL = {torch.float32: (dict(rtol=2e-5, atol=2e-5),
                            dict(rtol=2e-5, atol=2e-5)),
            torch.bfloat16: (dict(rtol=2e-2, atol=2e-2),
                             dict(rtol=0.0, atol=1e-3))}
#: SensorFormer flash vs plain/dense (tests/test_transformer_sp.py:36-39)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
#: flash backward against its plain version: f32 is the JAX suite's flash
#: grad bound (tests/test_attention.py:70-71); bf16 allows one rounding of
#: each output (2^-7 of the value) after f32 sums in another order (P
#: comes from the LSE, so the tiles change nothing else), and a row moved
#: by one p or ds rounding flip (``flash_parity.bwd_rounding_flips``)
GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=1e-2, atol=1e-3)}
#: a training step's loss and parameter grads, kernels vs plain versions
#: or dense attention (tests/test_torch_seq_parallel.py)
TRAIN_LOSS_TOL = dict(rtol=1e-5, atol=0.0)
TRAIN_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: published H100 SXM peaks: fp32 outside the tensor cores, bf16 and TF32
#: dense tensor cores, HBM3; its SMs, and their ex2 rate (16 a clock an SM
#: at 1.98 GHz)
FP32_FLOPS = 67e12
SMS = 132
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
HBM_BYTES_S = 3.35e12
EX2_PER_S = SMS * 16 * 1.98e9
#: a float32 product on the tensor cores is three tf32 products (split
#: TF32: hi·hi + hi·lo + lo·hi), so the f32 bound counts 3 × its flops at
#: the TF32 peak
TF32_TERMS = 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                rtol: float, atol: float) -> float:
    """Raise unless |got - want| <= atol + rtol·|want| everywhere; return
    the largest absolute difference."""
    got, want = got.double().cpu(), want.double().cpu()
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.numel()} outside rtol {rtol} "
            f"atol {atol}; max abs diff {float(diff.max())}")
    return float(diff.max())


def fresh_state(spec, device, seed=0) -> TrainState:
    model = spec.build(device, torch.Generator().manual_seed(seed))
    return TrainState.create(model, Adam())


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi.stdout.strip().splitlines()[0],
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def _fit_kernel(mangled: str):
    """A fit kernel's name in the ptxas log: ``elements`` or a rows
    instantiation (``rows F=18 E=14 H=7``, ...)."""
    rows = re.search(r"fused_fit_rows_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                     mangled)
    if rows:
        return f"rows F={rows.group(1)} E={rows.group(2)} H={rows.group(3)}"
    return "elements" if "fused_fit_kernel" in mangled else None


def _flash_kernel(mangled: str):
    """A flash kernel instantiation's name in the ptxas log: the FMA
    ``flash_fwd_kernel``, ``flash_bwd_dkv_kernel`` and
    ``flash_bwd_dq_kernel`` by dtype and head dim, the tensor-core
    ``flash_{fwd,bwd_dkv,bwd_dq}_wgmma_kernel`` and the split-TF32
    ``flash_{fwd,bwd_dkv,bwd_dq}_mma_kernel``."""
    found = re.match(r"\S*(flash_\w+)_kernelI(f|13__nv_bfloat16)Li(\d+)ELb"
                     r"([01])E", mangled)
    wgmma = re.match(r"\S*(flash_\w+)_wgmma_kernelILb([01])E", mangled)
    mma = re.match(r"\S*(flash_\w+)_mma_kernelILi(\d+)ELb([01])E", mangled)
    if mma:
        return (f"{mma.group(1)} f32 D={mma.group(2)} "
                f"{'causal' if mma.group(3) == '1' else 'full'} mma_tf32x3")
    if found:
        dtype = "f32" if found.group(2) == "f" else "bf16"
        return (f"{found.group(1)} {dtype} D={found.group(3)} "
                f"{'causal' if found.group(4) == '1' else 'full'}")
    if wgmma:
        return (f"{wgmma.group(1)} bf16 D=128 "
                f"{'causal' if wgmma.group(2) == '1' else 'full'} wgmma")
    return None


def phase_build() -> None:
    """Build the three CUDA sources and the native stream engine
    together, one compiler each."""
    def timed(name):
        t0 = time.perf_counter()
        built = not _build.library_path(name).exists()
        log = _build.build_log(name)
        return name, log, built, time.perf_counter() - t0

    def engine():
        t0 = time.perf_counter()
        path = native.library_path()
        fresh = not path.exists()
        native.load()  # built and loaded here, outside every timed path
        return {"library": path.name, "built": fresh,
                "seconds": time.perf_counter() - t0}

    t0 = time.perf_counter()
    names = ("fused_train", "flash_attention", "flash_attention_bwd")
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        native_build = pool.submit(engine)
        built = list(pool.map(timed, names))
        native_engine = native_build.result()
    wall = time.perf_counter() - t0
    sources = {}
    for name, log, fresh, seconds in built:
        sources[name] = {"seconds": seconds, "built": fresh}
        if name.startswith("flash_attention"):
            sources[name]["ptxas"] = ptxas = _build.ptxas_kernels(
                log, _flash_kernel)
            spilled = [k for k, v in ptxas.items()
                       if v.get("spill_stores") or v.get("spill_loads")]
            split = sorted(k for k in ptxas if k.endswith("mma_tf32x3"))
            kinds = {"flash_attention": ("fwd",),
                     "flash_attention_bwd": ("bwd_dkv", "bwd_dq")}[name]
            if split != sorted(
                    f"flash_{kind} f32 D={d} {entry} mma_tf32x3"
                    for kind in kinds for d in (8, 16)
                    for entry in ("causal", "full")):
                raise AssertionError(f"split-TF32 kernels in the ptxas "
                                     f"log of {name}: {split}")
        else:
            sources[name]["ptxas"] = ptxas = _build.ptxas_kernels(
                log, _fit_kernel)
            if sorted(ptxas) != ["elements", "rows F=18 E=14 H=7",
                                 "rows F=30 E=14 H=7"]:
                raise AssertionError(f"fit kernels in the ptxas log: "
                                     f"{sorted(ptxas)}")
            spilled = [k for k, v in ptxas.items() if k.startswith("rows")
                       and (v.get("spill_stores") or v.get("spill_loads"))]
        if spilled:
            raise AssertionError(f"ptxas spills in {spilled}")
    smem = {f"F={spec.input_dim} {design}": fused_train.smem(
        spec.build("cuda").state_dict(), 100, "cuda", design)
        for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER)
        for design in fused_train.DESIGNS}
    flash_smem_bytes = {f"{kind} {str(dtype)[6:]} D={d}": flash_smem(
        kind, d, dtype) for kind in ("fwd", "dkv", "dq")
        for dtype in FLASH_DTYPES for d in (8, 16, 128)}
    emit({"phase": "build", "seconds": wall, "sources": sources,
          "native_engine": native_engine,
          "smem_need_optin_bytes_at_B100": smem,
          "flash_smem_bytes_per_block": flash_smem_bytes,
          "fit_design": check_fit_designs(),
          "flash_design": check_designs(),
          **check_tensor_core_sass()})


FLASH_DTYPES = (torch.float32, torch.bfloat16)
FLASH_SOURCES = ("flash_attention", "flash_attention_bwd")


#: (B, F, E, H) over which the fit kernel's two design rules must agree
FIT_DESIGN_GRID = [(B, F, E, H)
                   for B in (1, 31, 100, 128, 129, 200, 256, 257, 300)
                   for F, E, H in ((18, 14, 7), (30, 14, 7), (18, 16, 7),
                                   (18, 14, 8), (12, 14, 7))]


def check_fit_designs() -> dict:
    """The fit kernel's design over ``FIT_DESIGN_GRID``: the library's
    ``iotml_fused_fit_design`` must be ``fit_design``'s (which shapes
    that is, the CPU tests hold).  Returns the count of each."""
    lib = fused_train._library()
    counts = dict.fromkeys(fused_train.DESIGNS, 0)
    for B, F, E, H in FIT_DESIGN_GRID:
        built = fused_train.DESIGNS[lib.iotml_fused_fit_design(B, F, E, H)]
        said = fused_train.fit_design(B, F, E, H)
        if built != said:
            raise AssertionError(f"fit design at B={B} F={F} E={E} H={H}: "
                                 f"library {built}, fit_design {said}")
        counts[said] += 1
    return counts


def check_designs() -> dict:
    """The design of each dtype and head dim in both directions: what each
    built library dispatches to (``iotml_flash_fwd_design``,
    ``iotml_flash_bwd_design``, codes named by ``FLASH_DESIGNS``) must be
    what ``flash_design`` says (which designs those are, the CPU tests
    hold); each direction takes all three designs."""
    libs = {"forward": _build.load("flash_attention").iotml_flash_fwd_design,
            "backward":
            _build.load("flash_attention_bwd").iotml_flash_bwd_design}
    designs = {}
    for code, dtype in enumerate(FLASH_DTYPES):
        for d in (8, 16, 128):
            for direction, lib_design in libs.items():
                built = FLASH_DESIGNS[lib_design(d, code)]
                said = flash_design(dtype, d, direction)
                if built != said:
                    raise AssertionError(
                        f"{direction} {dtype} D={d}: library {built}, "
                        f"flash_design {said}")
                designs[f"{direction} {str(dtype)[6:]} D={d}"] = said
    for direction in libs:
        if set(v for k, v in designs.items() if k.startswith(direction)) \
                != set(FLASH_DESIGNS):
            raise AssertionError(f"the {direction} does not take all three "
                                 f"designs: {designs}")
    return designs


def check_tensor_core_sass() -> dict:
    """Tensor-core instructions in the SASS (``cuobjdump -sass``): HGMMA in
    each ``wgmma`` instantiation, forward and backward (six), and
    HMMA…TF32 in each split-TF32 instantiation (twelve: the forward, dK/dV
    and dQ, D=8 and 16, causal and full); raises unless each has some."""
    cuobjdump = str(Path(_build._nvcc()).parent / "cuobjdump")
    hgmma, hmma = {}, {}
    for name in FLASH_SOURCES:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        for part in sass.split("Function : ")[1:]:
            head = part.splitlines()[0]
            found = re.search(r"\S*(flash_\w+)_wgmma_kernelILb([01])E", head)
            split = re.search(r"\S*(flash_\w+)_mma_kernelILi(\d+)ELb([01])E",
                              head)
            if found:
                entry = "causal" if found.group(2) == "1" else "full"
                hgmma[f"{found.group(1)} {entry}"] = part.count("HGMMA")
            elif split:
                entry = "causal" if split.group(3) == "1" else "full"
                hmma[f"{split.group(1)} D={split.group(2)} {entry}"] = len(
                    re.findall(r"HMMA\S*TF32", part))
    if len(hgmma) != 6 or not all(hgmma.values()):
        raise AssertionError(f"HGMMA in the tensor-core kernels: {hgmma}")
    if len(hmma) != 12 or not all(hmma.values()):
        raise AssertionError(f"HMMA.TF32 in the split-TF32 kernels: {hmma}")
    return {"hgmma_per_wgmma_kernel": hgmma,
            "hmma_tf32_per_mma_kernel": hmma}


def check_fit(tag: str, kernel_out, plain_out, steps: int) -> float:
    """Hold a kernel fit against the plain version's on the same inputs:
    every epoch's loss and accuracy at METRIC_TOL, the final params, mu
    and nu at STATE_TOL, and the step count.  Returns the largest absolute
    difference."""
    (k_state, k_loss, k_acc), (p_state, p_loss, p_acc) = kernel_out, plain_out
    err = max(check_close(f"{tag} losses", k_loss, p_loss, **METRIC_TOL),
              check_close(f"{tag} accs", k_acc, p_acc, **METRIC_TOL))
    for name, k_tree, p_tree in (
            ("params", k_state.params, p_state.params),
            ("mu", k_state.opt_state.mu, p_state.opt_state.mu),
            ("nu", k_state.opt_state.nu, p_state.opt_state.nu)):
        for key in PARAM_NAMES:
            err = max(err, check_close(f"{tag} {name} {key}", k_tree[key],
                                       p_tree[key], **STATE_TOL))
    if k_state.step != steps or k_state.opt_state.count != steps:
        raise AssertionError(f"{tag}: step {k_state.step}, count "
                             f"{k_state.opt_state.count}, not {steps}")
    return err


def kernel_case(spec, fractional: bool, seed: int, B: int = 100) -> float:
    """Kernel vs plain on one input, in the design ``fit_design`` picks
    (each launch must go through it); returns the largest abs
    difference."""
    F = spec.input_dim
    S, epochs = 6, 4
    design = fused_train.fit_design(B, F, spec.encoding_dim,
                                    spec.hidden_dim)
    by_design = dict(fused_train.fused_fit.launches_by_design)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (S, B, F)).astype(np.float32)
    xs[:, :, ::5] = 0.0  # zeroed columns, as the parity normalizer makes
    masks = np.ones((S, B), np.float32)
    masks[-1, 63:] = 0.0  # ragged last batch
    xs[-1, 63:] = 0.0
    if fractional:
        masks *= rng.uniform(0.25, 1.0, masks.shape).astype(np.float32)
    xs_d = torch.from_numpy(xs).cuda()
    masks_d = torch.from_numpy(masks).cuda()
    state = fresh_state(spec, "cuda", seed)

    k_state, k_loss, k_acc = kernel_out = fused_train.fused_fit(
        state, xs_d, masks_d, epochs)
    torch.cuda.synchronize()
    plain_out = fused_train.fused_fit_reference(state, xs_d, masks_d, epochs)
    tag = f"{design} B={B} F={F} fractional={fractional}"
    err = check_fit(tag, kernel_out, plain_out, S * epochs)

    # bit-for-bit repeat
    r_state, r_loss, r_acc = fused_train.fused_fit(state, xs_d, masks_d, epochs)
    same = torch.equal(r_loss, k_loss) and torch.equal(r_acc, k_acc) and all(
        torch.equal(r_state.params[k], k_state.params[k]) for k in PARAM_NAMES)
    if not same:
        raise AssertionError(f"{tag}: two runs of the kernel differ")

    # resume: 2 + 2 epochs == 4
    a_state, a_loss, _ = fused_train.fused_fit(state, xs_d, masks_d, 2)
    b_state, b_loss, _ = fused_train.fused_fit(a_state, xs_d, masks_d, 2)
    check_close(f"{tag} resume losses", torch.cat([a_loss, b_loss]), k_loss,
                **RESUME_TOL)
    check_close(f"{tag} resume encoder0.weight",
                b_state.params["encoder0.weight"],
                k_state.params["encoder0.weight"], rtol=1e-3, atol=1e-6)
    torch.cuda.synchronize()
    launched = {k: v - by_design[k] for k, v in
                fused_train.fused_fit.launches_by_design.items()}
    if launched != {**dict.fromkeys(by_design, 0), design: 4}:
        raise AssertionError(f"{tag}: launches by design {launched}")
    return err


def phase_kernel() -> float:
    errs = {}
    for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER):
        for fractional in (False, True):
            errs[f"rows F={spec.input_dim} fractional={fractional}"] = \
                kernel_case(spec, fractional,
                            seed=spec.input_dim + fractional)
    errs["rows B=256 F=30 fractional=True"] = kernel_case(
        CREDITCARD_AUTOENCODER, True, seed=256, B=256)
    errs["elements B=300 F=18 fractional=True"] = kernel_case(
        CAR_AUTOENCODER, True, seed=300, B=300)
    emit({"phase": "kernel", "kernel": "fused_fit", "cases": len(errs),
          "max_abs_err": errs, "metric_tol": METRIC_TOL,
          "state_tol": STATE_TOL, "resume_tol": RESUME_TOL,
          "bit_repeat": True})
    return max(errs.values())


@contextlib.contextmanager
def _recording(owner, name: str):
    """Wrap ``owner.name`` (a module's function or a class's method) so
    each call's (args, keywords, result) is recorded."""
    real = getattr(owner, name)
    calls = []

    def spy(*args, **kw):
        calls.append((args, kw, real(*args, **kw)))
        return calls[-1][2]

    setattr(owner, name, spy)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def _check_engine_formatted(formats, n_rows: int, formatted: int,
                            where: str) -> np.ndarray:
    """The rows the scorer formatted, after checking that the engine
    formatted every one of them that its fast path takes (the plain
    version's ``fast_rows`` rule), and numpy only the others."""
    rows = np.concatenate([args[0] for args, _, _ in formats])
    want = int(fastfmt.fast_rows(rows).sum())
    if rows.shape[0] != n_rows or formatted != want or want == 0:
        raise AssertionError(f"{where}: the native engine formatted "
                             f"{formatted} of {rows.shape[0]} payload rows; "
                             f"its fast path takes {want} of them")
    return rows


def phase_main_path(card: str) -> dict:
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    source = RowSource.from_fleet(gen, n_ticks=300)
    train_batches = SensorBatches(source, batch_size=100, take=100,
                                  only_normal=True)
    trainer = Trainer(CAR_AUTOENCODER)  # device=None: the card
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)
    t0 = time.perf_counter()
    hist = trainer.fit_compiled(train_batches, epochs=20)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    losses = hist["loss"]
    if len(losses) != 20 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not converge: {losses}")
    if hist["records"][0] != 10_000:
        raise AssertionError(f"trained on {hist['records'][0]} rows")

    score_batches = SensorBatches(source, batch_size=100, skip=100, take=100,
                                  keep_labels=True)
    out = OutputSequence()
    scorer = StreamScorer(CAR_AUTOENCODER, trainer.state.params,
                          score_batches, out, threshold=5.0)
    native.reset_stats()
    with _recording(scorer_module, "format_rows") as formats:
        t0 = time.perf_counter()
        n = scorer.score_available()
        score_s = time.perf_counter() - t0
    formatted = native.stats["format_rows"]
    _check_engine_formatted(formats, n, formatted, "main_path")
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"the main path launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"the rows design")
    if n != 10_000 or len(out.published) != 10_000:
        raise AssertionError(f"scored {n} rows, published {len(out.published)}")
    if [i for i, _ in out.published] != list(range(10_000)):
        raise AssertionError("predictions not in index order")
    if not all(msg.startswith(b"[") for _, msg in out.published):
        raise AssertionError("a payload does not start with '['")

    # the payloads against the trained weights recomputed on the CPU
    check = SensorBatches(source, batch_size=100, skip=100, take=1)
    x = torch.from_numpy(next(iter(check)).x)
    cpu_model = CAR_AUTOENCODER.build("cpu")
    cpu_params = {k: v.cpu() for k, v in trainer.state.params.items()}
    with torch.no_grad():
        want = reconstruction_error(cpu_model, cpu_params, x).numpy()
    got = np.array([float(msg.decode().rsplit("|", 1)[1])
                    for _, msg in out.published[:100]])
    pred0 = np.array(out.published[0][1].decode().split("|")[0]
                     .strip("[]").split(), np.float64)
    if pred0.shape != (18,) or not np.isfinite(pred0).all() \
            or not np.allclose(got, want, rtol=0, atol=2e-6):
        raise AssertionError(f"payload errors disagree with a CPU recompute: "
                             f"max {np.abs(got - want).max()}")
    info = {"phase": "main_path", "card": card, "fit_seconds": fit_s,
            "host_pipeline_s": hist["host_pipeline_s"],
            "device_compute_s": hist["device_compute_s"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "rows_trained_per_epoch": 10_000,
            "rows_scored": n, "score_seconds": score_s,
            "score_rows_per_s": n / score_s,
            "score_host_pipeline_s": scorer.seconds["host_pipeline"],
            "score_device_compute_s": scorer.seconds["device_compute"],
            "score_format_s": native.stats["format_s"],
            "native_format_rows": formatted,
            "quality": scorer.quality}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design,
            "batches": train_batches, "source": source}


CLI_TOPIC, CLI_GROUP = "SENSOR_DATA_S_AVRO", "cardata-autoencoder"
#: the CLI's payloads against a CPU recompute from the restored params:
#: the first 100 rows at main_path's bound, every row at a bound that
#: still tells each row from its neighbours (index order)
CLI_TOL_FIRST = dict(rtol=0.0, atol=2e-6)
CLI_TOL_ALL = dict(rtol=0.0, atol=1e-5)


def _run_cli(mode: str, root: str) -> dict:
    """One ``cardata.main`` call on the card: its stdout, stats line,
    seconds and the broker it made."""
    argv = ["emulator:30000", CLI_TOPIC, "0", "model-predictions", mode,
            "m1", root]
    out = io.StringIO()
    with _recording(cli_app, "_broker_for") as brokers, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cardata.main(argv)  # device=None: the card
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    text = out.getvalue()
    if rc != 0:
        raise AssertionError(f"cardata {mode} returned {rc}:\n{text}")
    stats = [line for line in text.splitlines()
             if line.startswith("stats: ")]
    return {"seconds": seconds, "broker": brokers[0][2],
            "stats": json.loads(stats[-1][len("stats: "):])}


def phase_cli_path(card: str) -> dict:
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        return _cli_path(card, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _cli_path(card: str, root: str) -> dict:
    fused_train.fused_fit.launches = 0
    fused_train.fused_fit.launches_by_design = dict.fromkeys(
        fused_train.DESIGNS, 0)
    native.reset_stats()
    with _recording(cli_app, "Trainer") as trainers:
        train = _run_cli("train", root)
    launches = fused_train.fused_fit.launches
    by_design = dict(fused_train.fused_fit.launches_by_design)
    train_native = dict(native.stats)
    if launches != 1 or by_design["rows"] != 1:
        raise AssertionError(f"cardata train launched the fit kernel "
                             f"{launches}x ({by_design}), not once through "
                             f"the rows design")
    losses = train["stats"]["loss"]
    if len(losses) != 20 or not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"cardata train did not converge: {losses}")
    if train["stats"]["records"] != 10_000 or \
            train_native["decode_rows"] < 10_000:
        raise AssertionError(f"cardata train: {train['stats']}, native "
                             f"{train_native}")

    # the stored checkpoint is the trained state, bit for bit, and carries
    # the cursor the group committed after it was stored
    state = trainers[0][2].state
    ckpt = CheckpointManager.load_dir(ArtifactStore(root).download_tree(
        "m1", str(Path(root) / "restored")))
    committed = train["broker"].committed(CLI_GROUP, CLI_TOPIC, 0)
    for tree, want in (("params", state.params), ("mu", state.opt_state.mu),
                       ("nu", state.opt_state.nu)):
        got = ckpt["params"] if tree == "params" \
            else getattr(ckpt["opt_state"], tree)
        for k in PARAM_NAMES:
            if not torch.equal(got[k], want[k].cpu()):
                raise AssertionError(f"checkpoint {tree}/{k} differs from "
                                     f"the trained state")
    if (ckpt["step"], ckpt["opt_state"].count) != (2000, 2000) or \
            ckpt["cursors"] != [(CLI_TOPIC, 0, committed)]:
        raise AssertionError(f"checkpoint step/count/cursors "
                             f"{ckpt['step']}, {ckpt['opt_state'].count}, "
                             f"{ckpt['cursors']}; committed {committed}")

    native.reset_stats()
    with _recording(scorer_module, "format_rows") as formats, \
            _recording(native.NativeCodec, "decode_batch") as decodes:
        predict = _run_cli("predict", root)
    predict_native = dict(native.stats)
    broker = predict["broker"]
    end = broker.end_offset("model-predictions", 0)
    payloads = [m.value.decode()
                for m in broker.fetch("model-predictions", 0, 0, end + 1)]
    if end != 10_000 or len(payloads) != 10_000 \
            or predict["stats"]["rows"] != 10_000:
        raise AssertionError(f"model-predictions ends at {end} "
                             f"({len(payloads)} payloads)")
    # every payload is the engine's string for a scored row, and that
    # string is np.array2string of the row, byte for byte
    rows = _check_engine_formatted(formats, 10_000,
                                   predict_native["format_rows"], "cli_path")
    engine_msgs = [m for _, _, msgs in formats for m in msgs]
    if engine_msgs != payloads:
        raise AssertionError("the topic's payloads are not the formatter's "
                             "strings in order")
    mismatched = sum(a != np.array2string(r)
                     for a, r in zip(engine_msgs, rows))
    if mismatched:
        raise AssertionError(f"{mismatched} payloads differ from "
                             f"np.array2string")
    if predict_native["decode_rows"] != 20_000:
        raise AssertionError(f"native engine on predict: {predict_native}")
    # what the engine decoded on predict, exactly the pure codec's columns
    # for the same messages
    pure = AvroCodec(KSQL_CAR_SCHEMA)
    for (codec, msgs), kw, (num, lab) in decodes:
        if kw.get("strip") != 5:
            raise AssertionError(f"predict decoded with {kw}, not strip=5")
        cols = pure.decode_batch([strip_frame(m) for m in msgs])
        label = [f.name for f in codec.schema.fields
                 if f.avro_type == "string"].index(
                     KSQL_CAR_SCHEMA.label_field)
        if not np.array_equal(num, pure.sensor_matrix(cols)) or \
                [v.decode() for v in lab[:, label]] != \
                list(cols[KSQL_CAR_SCHEMA.label_field]):
            raise AssertionError("the native decode of predict's messages "
                                 "differs from the pure codec's")
    decoded = sum(len(args[1]) for args, _, _ in decodes)

    # the payloads against the restored params recomputed on the CPU
    check = SensorBatches(
        StreamConsumer(predict["broker"], [f"{CLI_TOPIC}:0:0"]),
        batch_size=100, skip=100, take=100)
    x = torch.from_numpy(np.concatenate([b.x for b in check]))
    with torch.no_grad():
        want = torch.func.functional_call(
            CAR_AUTOENCODER.build("cpu"), ckpt["params"], (x,)).numpy()
    got = np.array([np.array(p.strip("[]").split(), np.float64)
                    for p in payloads])
    err_first = float(np.abs(got[:100] - want[:100]).max())
    err_all = float(np.abs(got - want).max())
    if got.shape != (10_000, 18) or not np.isfinite(got).all() \
            or not np.allclose(got[:100], want[:100], **CLI_TOL_FIRST) \
            or not np.allclose(got, want, **CLI_TOL_ALL):
        raise AssertionError(f"payloads disagree with a CPU recompute: "
                             f"first 100 max {err_first}, all max {err_all}")

    # format_rows against numpy and the plain version on these rows
    def timed(fn):
        t0 = time.perf_counter()
        out = fn(rows)
        return time.perf_counter() - t0, out

    fmt_s, fmt_out = timed(fastfmt.format_rows)
    np_s, np_out = timed(lambda r: [np.array2string(v) for v in r])
    plain_s, plain_out = timed(fastfmt.format_rows_plain)
    if not fmt_out == np_out == plain_out:
        raise AssertionError("format_rows, its plain version and numpy "
                             "disagree")
    info = {"phase": "cli_path", "card": card,
            "train_seconds": train["seconds"],
            "predict_seconds": predict["seconds"],
            "fit_seconds": train["stats"]["fit_seconds"],
            "fit_host_pipeline_s": train["stats"]["host_pipeline_s"],
            "fit_device_compute_s": train["stats"]["device_compute_s"],
            "loss_first": losses[0], "loss_last": losses[-1],
            "kernel_launches": launches,
            "kernel_launches_by_design": by_design,
            "train_decode_rows": train_native["decode_rows"],
            "train_decode_s": train_native["decode_s"],
            "publish_encode_rows": train_native["encode_rows"],
            "publish_encode_s": train_native["encode_s"],
            "committed_offset": committed,
            "rows_scored": predict["stats"]["rows"],
            "score_seconds": predict["stats"]["score_seconds"],
            "score_rows_per_s": predict["stats"]["rows"]
            / predict["stats"]["score_seconds"],
            "score_host_pipeline_s": predict["stats"]["host_pipeline_s"],
            "score_device_compute_s": predict["stats"]["device_compute_s"],
            "predict_decode_rows": predict_native["decode_rows"],
            "predict_decode_rows_held_to_pure_codec": decoded,
            "predict_decode_s": predict_native["decode_s"],
            "format_rows_native": predict_native["format_rows"],
            "format_s": predict_native["format_s"],
            "max_abs_err_first_100": err_first,
            "max_abs_err_all": err_all,
            "format_10k_ms": {"format_rows": fmt_s * 1e3,
                              "np_array2string": np_s * 1e3,
                              "format_rows_plain": plain_s * 1e3}}
    emit(info)
    return {"launches": launches, "launches_by_design": by_design}


def fit_bound(S: int, B: int, F: int, E: int, H: int, epochs: int) -> dict:
    """Least time for the fit on an H100: the larger of fp32 work over
    the fp32 peak and bytes (slice + state in, state + history out) over
    the memory rate; and the one-SM bound, the same flops over one SM's
    share of the fp32 peak (the fit is a chain of dependent steps that one
    block runs)."""
    n = E * F + E + H * E + H + H * H + H + F * H + F
    macs = E * F + H * E + H * H + F * H  # one forward
    # forward + weight grads (2 × macs) + the delta chain (no dW1 input
    # delta), 2 flops each; Adam ~10 flops per parameter
    step_flops = 2 * B * (2 * macs + F * H + H * H + H * E) + 10 * n
    flops = epochs * S * step_flops
    bytes_moved = 4 * (S * B * F + S * B + 3 * n) + 4 * (3 * n + 2 * epochs)
    ops_ms, bytes_ms = 1e3 * flops / FP32_FLOPS, 1e3 * bytes_moved / HBM_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "one_sm_bound_ms": 1e3 * flops / (FP32_FLOPS / SMS),
            "bound_flops": flops, "bound_bytes": bytes_moved}


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fit_in_turns(tag: str, xs, masks, epochs: int):
    """Both fit designs on one slice: each held against the plain version
    over the whole fit (every epoch and the final state: a fault that
    shows only late in a long fit fails here), then timed in turns, the
    design ``fit_design`` picks first (it, the other, the other, it).
    Returns (that design, ms per fit by design, largest difference by
    design, the plain version's output and the kernels')."""
    S, B, F = xs.shape
    state = fresh_state(CAR_AUTOENCODER, "cuda")
    picked = fused_train.fit_design(B, F, CAR_AUTOENCODER.encoding_dim,
                                    CAR_AUTOENCODER.hidden_dim)
    designs = (picked,) + tuple(d for d in fused_train.DESIGNS
                                if d != picked)

    def kernel(design):
        return fused_train.fused_fit(state, xs, masks, epochs, design=design)

    kernel_out = {d: kernel(d) for d in designs}  # warm, and held below
    plain_out = fused_train.fused_fit_reference(state, xs, masks, epochs)
    torch.cuda.synchronize()
    errs = {d: check_fit(f"{tag} {d}", out, plain_out, epochs * S)
            for d, out in kernel_out.items()}
    ms = {d: [] for d in designs}
    for d in designs + designs[::-1]:
        ms[d].append(cuda_ms(lambda: kernel(d), 5))
    return picked, ms, errs, plain_out, kernel_out


def _stacked(batches):
    bs = list(next(batches.epochs(1)))
    return (torch.from_numpy(np.stack([b.x for b in bs])).cuda(),
            torch.from_numpy(np.stack([b.mask for b in bs])).cuda())


def phase_timing(card: str, batches, source) -> dict:
    xs, masks = _stacked(batches)
    S, B, F = xs.shape
    epochs = 20
    state = fresh_state(CAR_AUTOENCODER, "cuda")
    main_design, ms, errs, plain_out, kernel_out = fit_in_turns(
        "reference shape", xs, masks, epochs)

    def plain():
        return fused_train.fused_fit_reference(state, xs, masks, epochs)

    model = CAR_AUTOENCODER.build("cuda")
    loop = make_scanned_fit(model, Adam())

    def step_loop():
        return loop(state, xs, xs, masks, epochs)

    loop(state, xs[:2], xs[:2], masks[:2], 1)
    plain_ms = cuda_ms(plain, 2)
    loop_ms = cuda_ms(step_loop, 1)
    E, H = CAR_AUTOENCODER.encoding_dim, CAR_AUTOENCODER.hidden_dim
    p_loss = plain_out[1]
    rel = {d: float(((out[1] - p_loss).abs() / p_loss.abs()).max())
           for d, out in kernel_out.items()}

    # the rows design's largest batch, on the same fleet slice
    wide = SensorBatches(source, batch_size=256, take=39, only_normal=True)
    w_xs, w_masks = _stacked(wide)
    w_S, w_B, _ = w_xs.shape
    w_design, w_ms, w_errs, _, _ = fit_in_turns("B=256", w_xs, w_masks,
                                               epochs)
    w_bound = fit_bound(w_S, w_B, F, E, H, epochs)
    info = {"phase": "timing", "card": card, "shape": [S, B, F],
            "epochs": epochs, "steps": epochs * S, "design": main_design,
            "kernel_ms": ms,
            "us_per_step": {d: 1e3 * min(t) / (epochs * S)
                            for d, t in ms.items()},
            "plain_ms": plain_ms, "step_loop_ms": loop_ms,
            **fit_bound(S, B, F, E, H, epochs),
            "max_abs_err": errs, "loss_rel_diff_max": rel,
            "batch_256": {
                "shape": [w_S, w_B, F], "steps": epochs * w_S,
                "design": w_design, "kernel_ms": w_ms,
                "us_per_step": {d: 1e3 * min(t) / (epochs * w_S)
                                for d, t in w_ms.items()},
                "bound_ms": w_bound["bound_ms"],
                "one_sm_bound_ms": w_bound["one_sm_bound_ms"],
                "max_abs_err": w_errs}}
    emit(info)
    return info


def _qkv(B, T, H, D, dtype, seed, grid=False):
    """Three seeded normal [B, T, H, D] tensors on the card.  ``grid``
    rounds them to multiples of 1/4 (GRID_NOTE)."""
    rng = np.random.default_rng(seed)
    ts = [rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3)]
    if grid:
        ts = [np.round(t * 4) / 4 for t in ts]
    return [torch.from_numpy(t).to("cuda", dtype) for t in ts]


#: The bf16 backward's grid cases.  Kernel and plain version sum Q·Kᵀ and
#: dO·Vᵀ in f32 in different orders, so off the grid a p or ds can round
#: to the other bf16 neighbour in one of them (a flip, which
#: ``bwd_rounding_flips`` must explain).  On a 1/4 grid every product is
#: a multiple of 1/16 and those sums (128 terms, well under 2^24
#: sixteenths) are exact in any order: both round the same p and ds, so
#: these cases allow no flip at all.
GRID_NOTE = "inputs on a 1/4 grid: Q·Kᵀ and dO·Vᵀ exact in f32, no flip"


def check_attention(tag, out, want, design, block) -> dict:
    """Kernel (o, lse) against the plain version's at ``block``: the
    ``wgmma`` design by ``check_wgmma_forward`` (which must also fail O
    scaled by 0.9, whole or in its last row), the FMA design at ATTN_TOL;
    returns the largest absolute difference of each: {"o": .., "lse": ..}
    (and the ``wgmma`` design's "o_row_rel")."""
    (o, lse), (want_o, want_lse) = out, want
    if design == "wgmma":
        err = check_wgmma_forward(tag, o, lse, want_o, want_lse, block)
        check_rejects_scaled_o(tag, o, lse, want_o, want_lse, block)
        return err
    o_tol, lse_tol = ATTN_TOL[want_o.dtype]
    return {"o": check_close(f"{tag} O", o, want_o, **o_tol),
            "lse": check_close(f"{tag} LSE", lse, want_lse, **lse_tol)}


ATTN_CASES = [  # dtype, B, T, H, D, causal, block
    (torch.float32, 2, 40, 2, 8, True, 16),
    (torch.float32, 2, 32, 2, 8, False, 16),
    (torch.float32, 2, 4096, 4, 16, True, 128),
    (torch.bfloat16, 1, 1000, 2, 128, True, 128),
    (torch.bfloat16, 1, 1024, 2, 128, False, 128),
]


#: the tensor-core forward's cases (bf16, D=128; the plain version at the
#: kernel's 64-row key tile, or at the caller's block 16 where T = 1,040
#: leaves a ragged key tile): dtype, B, T, H, D, causal, block
WGMMA_FWD_CASES = [
    *[(torch.bfloat16, B, T, H, 128, True, 64)
      for T in (1, 63, 64, 65, 127, 128, 129, 1000, 4096)
      for B, H in ((1, 1), (2, 3))],
    (torch.bfloat16, 2, 64, 3, 128, False, 64),
    (torch.bfloat16, 2, 1024, 3, 128, False, 64),
    (torch.bfloat16, 2, 1040, 3, 128, False, 16),
]


#: the split-TF32 forward's cases (f32, D=8 and 16; the plain version at
#: blocks 128 when causal, at the whole T when not, which a non-causal call
#: needs to divide T): dtype, B, T, H, D, causal, block
MMA_FWD_CASES = [(torch.float32, B, T, H, D, causal, 128 if causal else T)
                 for D in (8, 16) for causal in (True, False)
                 for T in (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1000,
                           4096)
                 for B, H in ((1, 1), (2, 3))]


def phase_attention_kernel() -> dict:
    errs = {"causal": 0.0, "full": 0.0}
    wgmma_errs = {"o": 0.0, "o_row_rel": 0.0, "lse": 0.0}
    mma_errs = {"o": 0.0, "lse": 0.0}
    cases = []
    for (dtype, B, T, H, D, causal, block), meant in (
            [(case, None) for case in ATTN_CASES]
            + [(case, "mma_tf32x3") for case in MMA_FWD_CASES]
            + [(case, "wgmma") for case in WGMMA_FWD_CASES]):
        q, k, v = _qkv(B, T, H, D, dtype, seed=T + D)
        entry = "causal" if causal else "full"
        design = flash_design(dtype, D, "forward")
        tag = f"{str(dtype)[6:]} B={B} T={T} H={H} D={D} {entry} {design}"
        if meant and design != meant:
            raise AssertionError(f"{tag}: a case of the {meant} design")
        before = flash_attention.launches[entry]
        out = flash_attention_fwd(q, k, v, causal, block, block)
        torch.cuda.synchronize()
        if flash_attention.launches[entry] != before + 1:
            raise AssertionError(f"{tag}: the {entry} kernel was not launched")
        want = flash_attention_reference(q, k, v, causal, block, block)
        err = check_attention(tag, out, want, design, block)
        again = flash_attention_fwd(q, k, v, causal, block, block)
        if not (torch.equal(again[0], out[0])
                and torch.equal(again[1], out[1])):
            raise AssertionError(f"{tag}: two launches differ")
        errs[entry] = max(errs[entry], err["o"], err["lse"])
        if design == "wgmma":
            wgmma_errs = {key: max(wgmma_errs[key], err[key])
                          for key in wgmma_errs}
        elif design == "mma_tf32x3":
            mma_errs = {key: max(mma_errs[key], err[key])
                        for key in mma_errs}
        cases.append({"case": tag, "block": block, "max_abs_err": err})
    q, k, v = _qkv(1, 40, 2, 8, torch.float32, seed=0)
    before = dict(flash_attention.launches)
    try:
        flash_attention_fwd(q, k, v, False, 16, 16)
    except ValueError:
        pass
    else:
        raise AssertionError("non-causal T=40 with block 16 did not raise")
    if flash_attention.launches != before:
        raise AssertionError("a refused call counted a launch")
    emit({"phase": "attention_kernel", "cases": cases,
          "wgmma_max_abs_err": wgmma_errs,
          "mma_tf32x3_cases": len(MMA_FWD_CASES),
          "mma_tf32x3_max_abs_err": mma_errs,
          "tolerance": {"f32": "O, LSE rtol=atol=2e-5",
                        "bf16 fma": "O rtol=atol=2e-2 in f32, LSE atol 1e-3",
                        "bf16 wgmma": "each O row's error within 1e-2 of "
                                      "its norm; O rtol 2e-2 atol 1e-3 in "
                                      "f32 at blocks 64 (rtol=atol=2e-2 at "
                                      "other blocks); LSE atol 1e-3; O x "
                                      "0.9 (whole, or its last row) fails"},
          "bit_repeat": True, "ragged_non_causal_raises": True})
    return errs


def reset_launches() -> None:
    for key in flash_attention.launches:
        flash_attention.launches[key] = 0


def expected_launches(**counts) -> dict:
    """Every flash entry point at 0 but those named."""
    return {key: counts.get(key, 0) for key in flash_attention.launches}


def fleet_histories(num_cars: int, ticks: int) -> np.ndarray:
    """[num_cars, ticks, 18] normalized per-car sensor histories: the
    fleet stepped ``ticks`` times, each tick's rows stacked per car."""
    gen = FleetGenerator(FleetScenario(num_cars=num_cars, failure_rate=0.01))
    rows = np.stack([gen.sensor_matrix(gen.step_columns())
                     for _ in range(ticks)], axis=1)
    return CAR_NORMALIZER.np(rows)


#: the serving path's fleet: cars, and ticks of history per car
SF_CARS, SF_TICKS = 100, 4096


def phase_sensorformer_path(card: str) -> dict:
    t0 = time.perf_counter()
    hist = fleet_histories(SF_CARS, SF_TICKS)
    data_s = time.perf_counter() - t0
    model = SensorFormer(attn_mode="flash").eval()  # no device: the card
    x = torch.from_numpy(hist).to(model.head.weight.device)
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = model(x)
        scores = SensorFormer.anomaly_scores(pred, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    if launches != expected_launches(causal=model.num_layers):
        raise AssertionError(f"one forward launched {launches}, not "
                             f"{model.num_layers} causal")
    if tuple(scores.shape) != (SF_CARS, SF_TICKS - 1) \
            or not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"scores {tuple(scores.shape)}, finite "
                             f"{bool(torch.isfinite(scores).all())}")

    def same_weights(mode):
        m = SensorFormer(attn_mode=mode).eval()
        m.load_state_dict(model.state_dict())
        return m

    with torch.no_grad():
        plain_scores = SensorFormer.anomaly_scores(
            same_weights("flash_reference")(x), x)
        err = check_close("scores vs plain version", scores, plain_scores,
                          **MODEL_TOL)
        dense_scores = SensorFormer.anomaly_scores(
            same_weights("dense")(x[:4]), x[:4])
        dense_err = check_close("scores vs dense (4 cars)", scores[:4],
                                dense_scores, **MODEL_TOL)

        def forward():
            return SensorFormer.anomaly_scores(model(x), x)

        ms = cuda_ms(forward, 5)
    steps = SF_CARS * (SF_TICKS - 1)
    info = {"phase": "sensorformer_path", "card": card,
            "shape": list(x.shape), "d_model": model.d_model,
            "num_heads": model.num_heads, "num_layers": model.num_layers,
            "data_seconds": data_s, "first_forward_seconds": first_s,
            "kernel_launches": launches, "max_abs_err_vs_plain": err,
            "max_abs_err_vs_dense_4_cars": dense_err,
            "score_mean": float(scores.mean()), "forward_ms": ms,
            "scored_steps_per_s": steps / (ms / 1e3)}
    emit(info)
    return {**info, "histories": hist}


def attention_bound(B, T, H, D, causal, dtype, flops_per_pair_per_d=4,
                    tensors=4, row_bytes=4) -> dict:
    """Least time for one attention call on an H100: its flops per live
    (query, key) pair (``flops_per_pair_per_d``·D) on the tensor cores,
    against the bytes it must move: ``tensors`` [B, T, H, D] tensors and
    ``row_bytes`` of f32 per row, each read or written once.  bf16 runs at
    the bf16 peak; float32 as split TF32, three tf32 products a product,
    at the TF32 peak.  Beside it, not in it: the same flops at the fp32
    FMA rate (``fp32_fma_floor_ms``) and one ex2 per live pair
    (``ex2_floor_ms``).  The forward is 4·D flops, q, k, v, o and the lse
    (the defaults)."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = flops_per_pair_per_d * D * pairs * B * H
    elt = torch.tensor([], dtype=dtype).element_size()
    bytes_moved = tensors * B * H * T * D * elt + row_bytes * B * H * T
    if dtype == torch.float32:
        ops_ms = 1e3 * TF32_TERMS * flops / TF32_FLOPS
    else:
        ops_ms = 1e3 * flops / BF16_FLOPS
    bytes_ms = 1e3 * bytes_moved / HBM_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_flops": flops, "bound_bytes": bytes_moved,
            "fp32_fma_floor_ms": 1e3 * flops / FP32_FLOPS,
            "ex2_floor_ms": 1e3 * pairs * B * H / EX2_PER_S}


TIMING_SHAPES = {  # name: (dtype, B, T, H, D, plain block, reps)
    "sensorformer_layer": (torch.float32, 100, 4096, 4, 16, 128, 5),
    "long_context": (torch.bfloat16, 1, 65536, 2, 128, 1024, 3),
}


def phase_attention_timing(card: str) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    out = {}
    for shape, (dtype, B, T, H, D, block, reps) in TIMING_SHAPES.items():
        q, k, v = _qkv(B, T, H, D, dtype, seed=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        for causal in (True, False):
            entry = "causal" if causal else "full"

            def kernel():
                return flash_attention_fwd(q, k, v, causal, block, block)

            def plain():
                return flash_attention_reference(q, k, v, causal, block,
                                                 block)

            def library():
                # the yardstick only; never the math fallback, which
                # would hold the whole [B, H, T, T] score matrix
                with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                                  SDPBackend.EFFICIENT_ATTENTION,
                                  SDPBackend.CUDNN_ATTENTION]):
                    return scaled_dot_product_attention(qh, kh, vh,
                                                        is_causal=causal)

            design = flash_design(dtype, D, "forward")
            err = check_attention(f"{shape} {entry}", kernel(), plain(),
                                  design, block)
            library()
            torch.cuda.synchronize()
            ms = cuda_ms(kernel, reps)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, reps)
            ms_again = cuda_ms(kernel, reps)
            bound = attention_bound(B, T, H, D, causal, dtype)
            out[(shape, entry)] = info = {
                "phase": "attention_timing", "card": card, "shape": shape,
                "entry": entry, "dtype": str(dtype)[6:],
                "B": B, "T": T, "H": H, "D": D, "plain_block": block,
                "design": design,
                "kernel_ms": [ms, ms_again], "plain_ms": plain_ms,
                "library_ms": library_ms,
                "max_abs_err": max(err["o"], err["lse"]),
                "max_abs_err_by_output": err, **bound,
                "tflops": bound["bound_flops"] / (min(ms, ms_again) / 1e3)
                / 1e12}
            emit(info)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return out

#: the backward's parts: flops per live pair (× D), [B, T, H, D] tensors
#: moved, f32 bytes per row.  Both kernels recompute Q·Kᵀ and dO·Vᵀ (2·D
#: each); dK/dV adds Pᵀ·dO and dSᵀ·Q, dQ adds dS·K.  The whole backward
#: counts each product once: 10·D; it reads q, k, v, o, dO and the lse and
#: writes dq, dk, dv (delta is derived from o and dO).  dK/dV reads q, k,
#: v, dO, lse and delta and writes dk, dv; dQ writes dq.
BWD_PARTS = {"backward": (10, 8, 4), "dkv": (8, 6, 8), "dq": (6, 5, 8)}


def check_grads(tag, got, want, dtype, inputs=None, causal=True,
                grid=False) -> tuple:
    """Kernel (dq, dk, dv) against the plain backward's at the dtype's
    bound; bf16 rows outside it must each be one rounding flip of a p or
    ds of ``inputs`` (q, k, v, o, lse, do), none on ``grid`` inputs.
    Returns the largest absolute difference of each kernel's outputs,
    {"dkv": .., "dq": ..}, and the flips, each tagged with the case."""
    flips = []
    if dtype == torch.bfloat16:
        try:
            flips = bwd_rounding_flips(*inputs, got, want, causal,
                                       max_rows=0 if grid else None,
                                       **GRAD_TOL[dtype])
        except AssertionError as exc:
            raise AssertionError(f"{tag}: {exc}") from None
        errs = {name: float((g.double() - w.double()).abs().max())
                for name, g, w in zip("qkv", got, want)}
    else:
        errs = {name: check_close(f"{tag} d{name}", g.float(), w.float(),
                                  **GRAD_TOL[dtype])
                for name, g, w in zip("qkv", got, want)}
    return ({"dkv": max(errs["k"], errs["v"]), "dq": errs["q"]},
            [{"case": tag, **flip} for flip in flips])


#: the tensor-core design's cases (bf16, D=128; the plain version at the
#: kernels' 64-row tiles): dtype, B, T, H, D, causal, block
WGMMA_BWD_CASES = [
    *[(torch.bfloat16, B, T, H, 128, True, 64)
      for T in (1, 63, 64, 65, 1000, 4096) for B, H in ((1, 1), (2, 3))],
    (torch.bfloat16, 2, 64, 3, 128, False, 64),
    (torch.bfloat16, 2, 1024, 3, 128, False, 64),
    (torch.bfloat16, 2, 4096, 2, 128, True, 64),
]
#: the longer of those cases again on grid inputs (GRID_NOTE)
WGMMA_BWD_GRID_CASES = [case for case in WGMMA_BWD_CASES if case[2] >= 1000]
#: the split-TF32 design's cases (f32, D=8 and 16; the plain version at
#: blocks 128 when causal, at the whole T when not, which a non-causal
#: call needs to divide T): dtype, B, T, H, D, causal, block
MMA_BWD_CASES = [(torch.float32, B, T, H, D, causal, 128 if causal else T)
                 for D in (8, 16) for causal in (True, False)
                 for T in (1, 15, 16, 17, 63, 64, 65, 1000, 4096)
                 for B, H in ((1, 1), (2, 3))]


def phase_attention_backward_kernel() -> dict:
    errs = {}
    cases, flips = [], []
    for (dtype, B, T, H, D, causal, block), grid, meant in (
            [(case, False, None) for case in ATTN_CASES]
            + [(case, False, "mma_tf32x3") for case in MMA_BWD_CASES]
            + [(case, False, "wgmma") for case in WGMMA_BWD_CASES]
            + [(case, True, "wgmma") for case in WGMMA_BWD_GRID_CASES]):
        q, k, v = _qkv(B, T, H, D, dtype, seed=T + D, grid=grid)
        do = _qkv(B, T, H, D, dtype, seed=T + D + 1, grid=grid)[0]
        entry = "causal" if causal else "full"
        design = flash_design(dtype, D, "backward")
        tag = (f"backward {str(dtype)[6:]} B={B} T={T} H={H} D={D} {entry} "
               f"{design}{' grid' if grid else ''}")
        if meant and design != meant:
            raise AssertionError(f"{tag}: a case of the {meant} design")
        o, lse = flash_attention_fwd(q, k, v, causal, block, block)
        before = dict(flash_attention.launches)
        got = flash_attention_bwd(q, k, v, o, lse, do, causal, block, block)
        torch.cuda.synchronize()
        for kind in ("dkv", "dq"):
            key = f"bwd_{kind}_{entry}"
            if flash_attention.launches[key] != before[key] + 1:
                raise AssertionError(f"{tag}: the {key} kernel was not "
                                     f"launched")
        want = flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal, block, block)
        err, case_flips = check_grads(tag, got, want, dtype,
                                      (q, k, v, o, lse, do), causal, grid)
        flips += case_flips
        case = {"case": tag, "block": block, "max_abs_err": err,
                "grid_inputs": grid, "rounding_flips": len(case_flips)}
        if dtype == torch.float32 and D == 8:
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            dense = torch.autograd.grad(
                attention_reference(*leaves, causal=causal), leaves, do)
            case["max_abs_err_vs_dense_autograd"] = check_grads(
                f"{tag} vs dense autograd", got, dense, dtype)[0]
        again = flash_attention_bwd(q, k, v, o, lse, do, causal, block,
                                    block)
        if not all(torch.equal(a, g) for a, g in zip(again, got)):
            raise AssertionError(f"{tag}: two launches differ")
        for kind in ("dkv", "dq"):
            errs[(kind, entry)] = max(errs.get((kind, entry), 0.0),
                                      err[kind])
        cases.append(case)
    # only dk is needed: the dK/dV kernel runs, the dQ kernel does not, and
    # dk is the last case's
    before = dict(flash_attention.launches)
    only_k = flash_attention_bwd(q, k, v, o, lse, do, causal, block, block,
                                 needs=(False, True, False))
    ran = {key: flash_attention.launches[key] - before[key]
           for key in before}
    if ran != expected_launches(bwd_dkv_causal=1) or only_k[0] is not None \
            or only_k[2] is not None or not torch.equal(only_k[1], got[1]):
        raise AssertionError(f"{tag}, only dk needed: launched {ran}")
    q, k, v = _qkv(1, 40, 2, 8, torch.float32, seed=0)
    lse = torch.zeros((1, 2, 40), device="cuda")
    before = dict(flash_attention.launches)
    try:
        flash_attention_bwd(q, k, v, q, lse, q, False, 16, 16)
    except ValueError:
        pass
    else:
        raise AssertionError("non-causal backward at T=40 with block 16 "
                             "did not raise")
    if flash_attention.launches != before:
        raise AssertionError("a refused backward counted a launch")
    emit({"phase": "attention_backward_kernel", "cases": cases,
          "rounding_flips": flips,
          "tolerance": {"f32": "dq, dk, dv rtol 1e-4 atol 1e-5",
                        "bf16": "dq, dk, dv rtol 1e-2 atol 1e-3 in f32; a "
                                "row outside it only as one p or ds "
                                "rounding flip (at most 1 row in 10,000, "
                                "at least 2, an output); " + GRID_NOTE},
          "bit_repeat": True, "only_dk_skips_dq": True,
          "ragged_non_causal_raises": True})
    return errs


#: SensorFormer training on the fleet histories: Adam steps after one
#: warm-up step, and cars per chunk of the plain version's gradient
TRAIN_TIMED_STEPS = 5
PLAIN_GRAD_CARS = 10


def phase_sensorformer_train(card: str, hist: np.ndarray) -> dict:
    model = SensorFormer(attn_mode="flash")  # no device: the card
    init, step, put_x = make_sp_train_step(model, Adam(1e-3))
    x = put_x(hist)
    n_cars, T = x.shape[:2]
    L = model.num_layers
    state = init()

    # step 1's loss and grads — what the step computes — held against the
    # plain versions on all cars (autograd through the plain forward, in
    # chunks of cars weighted by their share of the mean) and against
    # dense attention on 4 cars
    loss_k, grads_k = loss_and_grads(model, state.params, x)
    plain = SensorFormer(attn_mode="flash_reference")
    loss_p, grads_p = 0.0, {key: torch.zeros_like(g)
                            for key, g in grads_k.items()}
    for c in range(0, n_cars, PLAIN_GRAD_CARS):
        share = min(PLAIN_GRAD_CARS, n_cars - c) / n_cars
        loss_c, grads_c = loss_and_grads(plain, state.params,
                                         x[c:c + PLAIN_GRAD_CARS])
        loss_p = loss_p + share * loss_c
        for key in grads_p:
            grads_p[key] += share * grads_c[key]
    err_loss = check_close("step-1 loss vs plain", loss_k, loss_p,
                           **TRAIN_LOSS_TOL)
    err_plain = max(check_close(f"grad {key} vs plain", grads_k[key],
                                grads_p[key], **TRAIN_GRAD_TOL)
                    for key in grads_k)
    loss_k4, grads_k4 = loss_and_grads(model, state.params, x[:4])
    loss_d4, grads_d4 = loss_and_grads(SensorFormer(attn_mode="dense"),
                                       state.params, x[:4])
    err_loss_dense = check_close("4-car loss vs dense", loss_k4, loss_d4,
                                 **TRAIN_LOSS_TOL)
    err_dense = max(check_close(f"grad {key} vs dense (4 cars)",
                                grads_k4[key], grads_d4[key],
                                **TRAIN_GRAD_TOL)
                    for key in grads_k4)
    grad_scale = max(float(g.abs().max()) for g in grads_k.values())
    del grads_k, grads_p, grads_c, grads_k4, grads_d4, plain
    torch.cuda.empty_cache()

    # the main path: make_sp_train_step's steps
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    per_step = expected_launches(causal=L, bwd_dkv_causal=L,
                                 bwd_dq_causal=L)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    for i in range(1 + TRAIN_TIMED_STEPS):
        if i == 1:
            start.record()
        before = dict(flash_attention.launches)
        state, metrics = step(state, x)
        ran = {key: flash_attention.launches[key] - before[key]
               for key in before}
        if ran != per_step:
            raise AssertionError(f"step {i + 1} launched {ran}, not "
                                 f"{per_step}")
        losses.append(metrics["loss"])
    end.record()
    end.synchronize()
    launches = dict(flash_attention.launches)
    step_ms = start.elapsed_time(end) / TRAIN_TIMED_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).cpu().tolist()
    check_close("step-1 loss vs loss_and_grads", torch.tensor(losses[0]),
                loss_k, rtol=1e-6, atol=0.0)
    if not all(math.isfinite(v) for v in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"training did not converge: {losses}")
    if state.step != 1 + TRAIN_TIMED_STEPS:
        raise AssertionError(f"state at step {state.step}")
    steps = n_cars * (T - 1)
    info = {"phase": "sensorformer_train", "card": card,
            "shape": list(x.shape), "d_model": model.d_model,
            "num_heads": model.num_heads, "num_layers": L,
            "learning_rate": 1e-3, "steps": 1 + TRAIN_TIMED_STEPS,
            "kernel_launches": launches, "losses": losses,
            "step1_loss_err_vs_plain": err_loss,
            "step1_grad_max_abs_err_vs_plain": err_plain,
            "step1_loss_err_vs_dense_4_cars": err_loss_dense,
            "step1_grad_max_abs_err_vs_dense_4_cars": err_dense,
            "step1_grad_max_abs": grad_scale,
            "tolerance": {"loss": TRAIN_LOSS_TOL, "grads": TRAIN_GRAD_TOL},
            "step_ms": step_ms, "trained_steps_per_s": steps / (step_ms / 1e3),
            "peak_memory_bytes": peak}
    emit(info)
    return info


def phase_attention_backward_timing(card: str) -> dict:
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention

    # the yardstick only; never the math fallback, which would hold the
    # whole [B, H, T, T] score matrix
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    out = {}
    for shape, (dtype, B, T, H, D, block, reps) in TIMING_SHAPES.items():
        q, k, v = _qkv(B, T, H, D, dtype, seed=1)
        do = _qkv(B, T, H, D, dtype, seed=2)[0]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_leaves = [t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v)]
        do_h = do.transpose(1, 2).contiguous()
        for causal in (True, False):
            entry = "causal" if causal else "full"
            o, lse = flash_attention_fwd(q, k, v, causal, block, block)
            folded = flash_bwd_inputs(q, k, v, o, lse, do)

            def dkv():
                return flash_bwd_dkv(*folded, causal=causal)

            def dq():
                return flash_bwd_dq(*folded, causal=causal)

            def plain():
                return flash_attention_backward_reference(
                    q, k, v, o, lse, do, causal, block, block)

            def port():
                return torch.autograd.grad(
                    flash_attention(*leaves, causal, block, block), leaves,
                    do)

            def lib_forward():
                with sdpa_kernel(backends):
                    return scaled_dot_product_attention(*lib_leaves,
                                                        is_causal=causal)

            def library():
                return torch.autograd.grad(lib_forward(), lib_leaves, do_h)

            lib_out = lib_forward()

            def lib_bwd(which):
                return lambda: torch.autograd.grad(
                    lib_out, [lib_leaves[i] for i in which], do_h,
                    retain_graph=True)

            kernel_grads = flash_attention_bwd(q, k, v, o, lse, do, causal,
                                               block, block)
            err, flips = check_grads(f"{shape} {entry} backward",
                                     kernel_grads, plain(), dtype,
                                     (q, k, v, o, lse, do), causal)
            # the path as a caller runs it, counted alone: one forward, one
            # dK/dV and one dQ launch, and the grads of the kernels above
            reset_launches()
            path_grads = port()
            torch.cuda.synchronize()
            path_launches = dict(flash_attention.launches)
            want_launches = expected_launches(
                **{entry: 1, f"bwd_dkv_{entry}": 1, f"bwd_dq_{entry}": 1})
            if path_launches != want_launches:
                raise AssertionError(f"{shape} {entry} forward + backward "
                                     f"launched {path_launches}")
            if not all(torch.equal(a, b)
                       for a, b in zip(path_grads, kernel_grads)):
                raise AssertionError(f"{shape} {entry}: the path's grads "
                                     f"differ from the kernels'")
            for fn in (dkv, dq, port, library):
                fn()
            torch.cuda.synchronize()
            dkv_ms, dq_ms = cuda_ms(dkv, reps), cuda_ms(dq, reps)
            plain_ms = cuda_ms(plain, 2)
            port_ms = cuda_ms(port, reps)
            library_ms = cuda_ms(library, reps)
            lib_ms = {part: cuda_ms(lib_bwd(which), reps) for part, which in
                      (("backward", (0, 1, 2)), ("dkv", (1, 2)),
                       ("dq", (0,)))}
            dkv_again, dq_again = cuda_ms(dkv, reps), cuda_ms(dq, reps)
            parts = {part: attention_bound(B, T, H, D, causal, dtype, *spec)
                     for part, spec in BWD_PARTS.items()}
            design = flash_design(dtype, D, "backward")

            def kernel_line(kind, times):
                return {"design": design, "ms": times,
                        "library_ms": lib_ms[kind], **parts[kind],
                        "tflops": parts[kind]["bound_flops"]
                        / (min(times) / 1e3) / 1e12}

            out[(shape, entry)] = info = {
                "phase": "attention_backward_timing", "card": card,
                "shape": shape, "entry": entry, "dtype": str(dtype)[6:],
                "B": B, "T": T, "H": H, "D": D, "plain_block": block,
                "dkv": kernel_line("dkv", [dkv_ms, dkv_again]),
                "dq": kernel_line("dq", [dq_ms, dq_again]),
                "backward": {"kernels_ms": min(dkv_ms, dkv_again)
                             + min(dq_ms, dq_again),
                             "plain_ms": plain_ms,
                             "library_ms": lib_ms["backward"],
                             **parts["backward"]},
                # tokens (B·T) over forward + backward seconds: at B=1,
                # bench.py's flash_attention_fwd_bwd_tokens_per_sec
                "forward_backward": {
                    "forward_design": flash_design(dtype, D, "forward"),
                    "kernel_launches": path_launches,
                    "port_ms": port_ms, "library_ms": library_ms,
                    "flash_attention_fwd_bwd_tokens_per_sec":
                        B * T / (port_ms / 1e3),
                    "library_tokens_per_sec": B * T / (library_ms / 1e3)},
                "max_abs_err": err, "rounding_flips": flips}
            emit(info)
            del lib_out, o, lse, folded, kernel_grads, path_grads
        del q, k, v, do, leaves, lib_leaves, do_h
        torch.cuda.empty_cache()
    return out


def launch_counts(key, paths) -> dict:
    """An entry's launches on each path that runs it, read there with
    every count set to 0 just before, and their sum."""
    by_path = {name: counts[key] for name, counts in paths.items()}
    return {"launches": sum(by_path.values()), "launches_by_path": by_path}


def attention_entry(name, replaces, entry, paths, err, timing) -> dict:
    layer = timing[("sensorformer_layer", entry)]
    long = timing[("long_context", entry)]
    return {
        "name": name, "route": "cuda",
        "source": "iotml_torch/ops/csrc/flash_attention.cu",
        "replaces": replaces, "design": layer["design"],
        **launch_counts(entry, paths),
        "max_abs_err": max(err[entry], layer["max_abs_err"],
                           long["max_abs_err"]),
        "ms": min(layer["kernel_ms"]), "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": layer["library_ms"],
        "long_context": {"design": long["design"],
                         "ms": min(long["kernel_ms"]),
                         "tflops": long["tflops"],
                         "plain_ms": long["plain_ms"],
                         "bound_ms": long["bound_ms"],
                         "bound_by": long["bound_by"],
                         "library_ms": long["library_ms"]}}


def backward_entry(name, replaces, kind, entry, paths, errs,
                   timing) -> dict:
    """A backward kernel's line: design, ms, bound and library call of
    its own part at the layer call and the long-context call; plain_ms is
    the whole plain backward (no plain version computes one kernel's
    share alone)."""
    layer = timing[("sensorformer_layer", entry)]
    long = timing[("long_context", entry)]
    return {
        "name": name, "route": "cuda",
        "source": "iotml_torch/ops/csrc/flash_attention_bwd.cu",
        "design": layer[kind]["design"],
        "replaces": replaces, **launch_counts(f"bwd_{kind}_{entry}", paths),
        "max_abs_err": max(errs[(kind, entry)], layer["max_abs_err"][kind],
                           long["max_abs_err"][kind]),
        "ms": min(layer[kind]["ms"]),
        "plain_ms": layer["backward"]["plain_ms"],
        "bound_ms": layer[kind]["bound_ms"],
        "bound_by": layer[kind]["bound_by"],
        "library_ms": layer[kind]["library_ms"],
        "long_context": {"design": long[kind]["design"],
                         "ms": min(long[kind]["ms"]),
                         "tflops": long[kind]["tflops"],
                         "plain_ms": long["backward"]["plain_ms"],
                         "bound_ms": long[kind]["bound_ms"],
                         "bound_by": long[kind]["bound_by"],
                         "library_ms": long[kind]["library_ms"]}}


def main() -> int:
    dev = phase_device()
    card = dev["nvidia_smi"]
    phase_build()
    err = phase_kernel()
    main_info = phase_main_path(card)
    cli_info = phase_cli_path(card)
    timing = phase_timing(card, main_info["batches"], main_info["source"])
    attn_err = phase_attention_kernel()
    sf_info = phase_sensorformer_path(card)
    attn_timing = phase_attention_timing(card)
    bwd_err = phase_attention_backward_kernel()
    train_info = phase_sensorformer_train(card, sf_info["histories"])
    bwd_timing = phase_attention_backward_timing(card)
    long_paths = [bwd_timing[("long_context", entry)]["forward_backward"]
                  ["kernel_launches"] for entry in ("causal", "full")]
    paths = {"sensorformer_path": sf_info["kernel_launches"],
             "sensorformer_train": train_info["kernel_launches"],
             "long_context": {key: sum(p[key] for p in long_paths)
                              for key in flash_attention.launches}}
    design = timing["design"]
    emit({"kernels": [{
        "name": "fused_fit", "route": "cuda",
        "source": "iotml_torch/ops/csrc/fused_train.cu",
        "replaces": "iotml/ops/fused_train.py:64", "design": design,
        "launches": main_info["launches"] + cli_info["launches"],
        "launches_by_path": {"main_path": main_info["launches"],
                             "cli_path": cli_info["launches"]},
        "launches_by_design": {
            d: main_info["launches_by_design"][d]
            + cli_info["launches_by_design"][d]
            for d in fused_train.DESIGNS},
        "max_abs_err": max(err, *timing["max_abs_err"].values(),
                           *timing["batch_256"]["max_abs_err"].values()),
        "ms": min(timing["kernel_ms"][design]),
        "ms_by_design": {d: min(t) for d, t in timing["kernel_ms"].items()},
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "step_loop_ms": timing["step_loop_ms"]},
        attention_entry("flash_fwd_causal", "iotml/ops/attention.py:215",
                        "causal", paths, attn_err, attn_timing),
        attention_entry("flash_fwd_full", "iotml/ops/attention.py:149",
                        "full", paths, attn_err, attn_timing),
        backward_entry("flash_bwd_dkv_causal", "iotml/ops/attention.py:482",
                       "dkv", "causal", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dq_causal", "iotml/ops/attention.py:518",
                       "dq", "causal", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dkv_full", "iotml/ops/attention.py:402",
                       "dkv", "full", paths, bwd_err, bwd_timing),
        backward_entry("flash_bwd_dq_full", "iotml/ops/attention.py:447",
                       "dq", "full", paths, bwd_err, bwd_timing)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
