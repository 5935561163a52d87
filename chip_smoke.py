#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``iotml_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
Each phase prints one JSON line; any failure ends the run with a
non-zero exit and no result line:

1. device     — card name, count, ``nvidia-smi`` name and power limit;
                TF32 switched off for matmul and cuDNN.
2. build      — both CUDA sources built from the checkout, one ``nvcc``
                each, started together (seconds per source; ptxas
                registers, shared memory and spills per instantiation).
3. kernel     — the fused-fit kernel against its plain PyTorch version on
                the card: B=100 at F=18 and F=30, 6 batches × 4 epochs,
                ragged last batch, 0/1 and fractional masks; runs repeat
                bit for bit; 2 + 2 epochs equal 4.
4. main_path  — the reference job at full width and shape: a 100-car
                fleet for 300 ticks (30,000 rows), train on 100 batches
                of 100 normal rows for 20 epochs (``fit_compiled``, one
                kernel launch), then score batches 100..199 (10,000
                rows) with threshold 5.
5. timing     — the kernel held against its plain version over the whole
                fit at that shape (all 20 epochs' loss and accuracy, the
                final params, mu and nu), then its time per fit (CUDA
                events over warm launches) beside the plain version's,
                the autograd step loop's (``fused="never"``) and the
                bound.
6. attention_kernel — the flash-attention kernel against its plain
                version on the card, both entry points, O and LSE: f32
                D=8 (causal T=40 with blocks 16, non-causal T=32), f32
                D=16 (causal, B=2, H=4, T=4096), bf16 D=128 H=2 (causal
                T=1000, non-causal T=1024); a second launch repeats the
                first bit for bit; a ragged non-causal call raises.
7. sensorformer_path — SensorFormer at full width (its defaults) scores
                100 cars' 4,096-tick fleet histories: one forward with
                attn_mode="flash" (2 causal kernel launches), held
                against the same weights with the kernel's plain version
                (all cars) and dense attention (4 cars); forward ms and
                scored steps per second.
8. attention_timing — kernel, plain version, bound and the library
                yardstick (``scaled_dot_product_attention``) at the
                model's per-layer call (f32, B=100, T=4096, H=4, D=16)
                and the long-context shape (bf16, B=1, T=65,536, H=2,
                D=128; plain version at blocks 1024), causal and not.
Then the kernels line, the ``nvidia-smi`` line, and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from iotml_torch.core.normalize import CAR_NORMALIZER
from iotml_torch.data.dataset import RowSource, SensorBatches
from iotml_torch.gen.simulator import FleetGenerator, FleetScenario
from iotml_torch.models.autoencoder import (CAR_AUTOENCODER,
                                            CREDITCARD_AUTOENCODER,
                                            PARAM_NAMES, reconstruction_error)
from iotml_torch.models.transformer import SensorFormer
from iotml_torch.ops import _build, fused_train
from iotml_torch.ops.attention import (flash_attention, flash_attention_fwd,
                                       flash_attention_reference)
from iotml_torch.serve.scorer import StreamScorer
from iotml_torch.stream.producer import OutputSequence
from iotml_torch.train.loop import Trainer, TrainState, make_scanned_fit
from iotml_torch.train.optim import Adam

#: the JAX suite's own fused-vs-scanned bounds (tests/test_fused_train.py)
METRIC_TOL = dict(rtol=2e-4, atol=1e-6)
STATE_TOL = dict(rtol=5e-3, atol=2e-5)
RESUME_TOL = dict(rtol=1e-4, atol=1e-7)
#: flash forward against its plain version: f32 is the JAX suite's flash
#: forward bound (tests/test_attention.py:56-57); bf16 allows for P being
#: rounded at the running max of tiles that differ in size
ATTN_TOL = {torch.float32: (dict(rtol=2e-5, atol=2e-5),
                            dict(rtol=2e-5, atol=2e-5)),
            torch.bfloat16: (dict(rtol=2e-2, atol=2e-2),
                             dict(rtol=0.0, atol=1e-3))}
#: SensorFormer flash vs plain/dense (tests/test_transformer_sp.py:36-39)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
#: published H100 SXM peaks: fp32 outside the tensor cores, bf16 dense
#: tensor cores, HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12


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


def _ptxas_by_kernel(log: str) -> dict:
    """Registers and spills of each flash_fwd_kernel instantiation, from
    ``-Xptxas -v``."""
    out, name = {}, None
    for line in log.splitlines():
        found = re.search(r"Function properties for \S*flash_fwd_kernelI"
                          r"(f|13__nv_bfloat16)Li(\d+)ELb([01])E", line)
        if found:
            dtype = "f32" if found.group(1) == "f" else "bf16"
            name = (f"{dtype} D={found.group(2)} "
                    f"{'causal' if found.group(3) == '1' else 'full'}")
            out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
            name = None
    return out


def phase_build() -> None:
    """Build both sources together, one nvcc each."""
    def timed(name):
        t0 = time.perf_counter()
        log = _build.build(name)
        return name, log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        built = list(pool.map(timed, ("fused_train", "flash_attention")))
    wall = time.perf_counter() - t0
    sources = {}
    for name, log, seconds in built:
        sources[name] = {"seconds": seconds, "built": bool(log)}
        if name == "flash_attention":
            sources[name]["ptxas"] = _ptxas_by_kernel(log)
        else:
            sources[name]["ptxas"] = [line.strip() for line in log.splitlines()
                                      if "Used" in line or "spill" in line]
    smem = {f"F={spec.input_dim}": fused_train.smem(
        spec.build("cuda").state_dict(), 100, "cuda")
        for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER)}
    emit({"phase": "build", "seconds": wall, "sources": sources,
          "smem_need_optin_bytes_at_B100": smem})


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


def kernel_case(spec, fractional: bool, seed: int) -> float:
    """Kernel vs plain on one input; returns the largest abs difference."""
    F = spec.input_dim
    S, B, epochs = 6, 100, 4
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
    tag = f"F={F} fractional={fractional}"
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
    return err


def phase_kernel() -> float:
    err = 0.0
    for spec in (CAR_AUTOENCODER, CREDITCARD_AUTOENCODER):
        for fractional in (False, True):
            err = max(err, kernel_case(spec, fractional,
                                       seed=spec.input_dim + fractional))
    emit({"phase": "kernel", "kernel": "fused_fit", "cases": 4,
          "max_abs_err": err, "metric_tol": METRIC_TOL, "state_tol": STATE_TOL,
          "resume_tol": RESUME_TOL, "bit_repeat": True})
    return err


def phase_main_path(card: str) -> dict:
    gen = FleetGenerator(FleetScenario(num_cars=100, failure_rate=0.01))
    source = RowSource.from_fleet(gen, n_ticks=300)
    train_batches = SensorBatches(source, batch_size=100, take=100,
                                  only_normal=True)
    trainer = Trainer(CAR_AUTOENCODER)  # device=None: the card
    fused_train.fused_fit.launches = 0
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
    t0 = time.perf_counter()
    n = scorer.score_available()
    score_s = time.perf_counter() - t0
    launches = fused_train.fused_fit.launches
    if launches != 1:
        raise AssertionError(f"the main path launched the fit kernel "
                             f"{launches}x, not once")
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
            "kernel_launches": launches, "rows_trained_per_epoch": 10_000,
            "rows_scored": n, "score_seconds": score_s,
            "score_rows_per_s": n / score_s,
            "score_host_pipeline_s": scorer.seconds["host_pipeline"],
            "score_device_compute_s": scorer.seconds["device_compute"],
            "quality": scorer.quality}
    emit(info)
    return {"launches": launches, "batches": train_batches}


def fit_bound(S: int, B: int, F: int, E: int, H: int, epochs: int) -> dict:
    """Least time for the fit on an H100: the larger of fp32 work over
    the fp32 peak and bytes (slice + state in, state + history out) over
    the memory rate."""
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


def phase_timing(card: str, batches) -> dict:
    bs = list(next(batches.epochs(1)))
    xs = torch.from_numpy(np.stack([b.x for b in bs])).cuda()
    masks = torch.from_numpy(np.stack([b.mask for b in bs])).cuda()
    S, B, F = xs.shape
    epochs = 20
    state = fresh_state(CAR_AUTOENCODER, "cuda")

    def kernel():
        return fused_train.fused_fit(state, xs, masks, epochs)

    def plain():
        return fused_train.fused_fit_reference(state, xs, masks, epochs)

    model = CAR_AUTOENCODER.build("cuda")
    loop = make_scanned_fit(model, Adam())

    def step_loop():
        return loop(state, xs, xs, masks, epochs)

    kernel_out = kernel()  # warm, and held against the plain version
    plain_out = plain()
    loop(state, xs[:2], xs[:2], masks[:2], 1)
    torch.cuda.synchronize()
    # the whole fit at the main path's shape, every epoch and the final
    # state: a fault that shows only late in a long fit fails here
    err = check_fit("reference shape", kernel_out, plain_out, epochs * S)
    ms = cuda_ms(kernel, 5)
    plain_ms = cuda_ms(plain, 2)
    loop_ms = cuda_ms(step_loop, 1)
    ms_again = cuda_ms(kernel, 5)
    E, H = (state.params[f"{k}.weight"].shape[0]
            for k in ("encoder0", "encoder1"))
    k_loss, p_loss = kernel_out[1], plain_out[1]
    rel = ((k_loss - p_loss).abs() / p_loss.abs()).cpu()
    info = {"phase": "timing", "card": card, "shape": [S, B, F],
            "epochs": epochs, "steps": epochs * S,
            "kernel_ms": [ms, ms_again], "plain_ms": plain_ms,
            "step_loop_ms": loop_ms, **fit_bound(S, B, F, E, H, epochs),
            "max_abs_err": err, "loss_rel_diff_max": float(rel.max())}
    emit(info)
    return info


def _qkv(B, T, H, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, H, D)).astype(np.float32))
            .to("cuda", dtype) for _ in range(3)]


def check_attention(tag, out, want) -> float:
    """Kernel (o, lse) against the plain version's at the dtype's bounds;
    returns the largest absolute difference."""
    (o, lse), (want_o, want_lse) = out, want
    o_tol, lse_tol = ATTN_TOL[want_o.dtype]
    return max(check_close(f"{tag} O", o, want_o, **o_tol),
               check_close(f"{tag} LSE", lse, want_lse, **lse_tol))


ATTN_CASES = [  # dtype, B, T, H, D, causal, block
    (torch.float32, 2, 40, 2, 8, True, 16),
    (torch.float32, 2, 32, 2, 8, False, 16),
    (torch.float32, 2, 4096, 4, 16, True, 128),
    (torch.bfloat16, 1, 1000, 2, 128, True, 128),
    (torch.bfloat16, 1, 1024, 2, 128, False, 128),
]


def phase_attention_kernel() -> dict:
    errs = {"causal": 0.0, "full": 0.0}
    cases = []
    for dtype, B, T, H, D, causal, block in ATTN_CASES:
        q, k, v = _qkv(B, T, H, D, dtype, seed=T + D)
        entry = "causal" if causal else "full"
        tag = f"{str(dtype)[6:]} B={B} T={T} H={H} D={D} {entry}"
        before = flash_attention.launches[entry]
        out = flash_attention_fwd(q, k, v, causal, block, block)
        torch.cuda.synchronize()
        if flash_attention.launches[entry] != before + 1:
            raise AssertionError(f"{tag}: the {entry} kernel was not launched")
        want = flash_attention_reference(q, k, v, causal, block, block)
        err = check_attention(tag, out, want)
        again = flash_attention_fwd(q, k, v, causal, block, block)
        if not (torch.equal(again[0], out[0])
                and torch.equal(again[1], out[1])):
            raise AssertionError(f"{tag}: two launches differ")
        errs[entry] = max(errs[entry], err)
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
          "tolerance": {"f32": "O, LSE rtol=atol=2e-5",
                        "bf16": "O rtol=atol=2e-2 in f32, LSE atol 1e-3"},
          "bit_repeat": True, "ragged_non_causal_raises": True})
    return errs


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
    flash_attention.launches.update(causal=0, full=0)
    t0 = time.perf_counter()
    with torch.no_grad():
        pred = model(x)
        scores = SensorFormer.anomaly_scores(pred, x)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches)
    if launches != {"causal": model.num_layers, "full": 0}:
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
    return info


def attention_bound(B, T, H, D, causal, dtype) -> dict:
    """Least time for one forward on an H100: 4·D flops per live (query,
    key) pair at the inputs' peak, against q, k, v read once and o, lse
    written once."""
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 4 * D * pairs * B * H
    elt = torch.tensor([], dtype=dtype).element_size()
    bytes_moved = 4 * B * H * T * D * elt + 4 * B * H * T
    peak = FP32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    ops_ms, bytes_ms = 1e3 * flops / peak, 1e3 * bytes_moved / HBM_BYTES_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_flops": flops, "bound_bytes": bytes_moved,
            "fp32_fma_floor_ms": 1e3 * flops / FP32_FLOPS}


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

            err = check_attention(f"{shape} {entry}", kernel(), plain())
            library()
            torch.cuda.synchronize()
            ms = cuda_ms(kernel, reps)
            plain_ms = cuda_ms(plain, 2)
            library_ms = cuda_ms(library, reps)
            ms_again = cuda_ms(kernel, reps)
            out[(shape, entry)] = info = {
                "phase": "attention_timing", "card": card, "shape": shape,
                "entry": entry, "dtype": str(dtype)[6:],
                "B": B, "T": T, "H": H, "D": D, "plain_block": block,
                "kernel_ms": [ms, ms_again], "plain_ms": plain_ms,
                "library_ms": library_ms, "max_abs_err": err,
                **attention_bound(B, T, H, D, causal, dtype)}
            emit(info)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    return out


def attention_entry(name, replaces, entry, launches, err, timing) -> dict:
    layer = timing[("sensorformer_layer", entry)]
    long = timing[("long_context", entry)]
    return {
        "name": name, "route": "cuda",
        "source": "iotml_torch/ops/csrc/flash_attention.cu",
        "replaces": replaces, "launches": launches[entry],
        "max_abs_err": max(err[entry], layer["max_abs_err"],
                           long["max_abs_err"]),
        "ms": min(layer["kernel_ms"]), "plain_ms": layer["plain_ms"],
        "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
        "library_ms": layer["library_ms"],
        "long_context": {"ms": min(long["kernel_ms"]),
                         "plain_ms": long["plain_ms"],
                         "bound_ms": long["bound_ms"],
                         "bound_by": long["bound_by"],
                         "fp32_fma_floor_ms": long["fp32_fma_floor_ms"],
                         "library_ms": long["library_ms"]}}


def main() -> int:
    dev = phase_device()
    card = dev["nvidia_smi"]
    phase_build()
    err = phase_kernel()
    main_info = phase_main_path(card)
    timing = phase_timing(card, main_info["batches"])
    attn_err = phase_attention_kernel()
    sf_info = phase_sensorformer_path(card)
    attn_timing = phase_attention_timing(card)
    launches = sf_info["kernel_launches"]
    emit({"kernels": [{
        "name": "fused_fit", "route": "cuda",
        "source": "iotml_torch/ops/csrc/fused_train.cu",
        "replaces": "iotml/ops/fused_train.py:64",
        "launches": main_info["launches"],
        "max_abs_err": max(err, timing["max_abs_err"]),
        "ms": min(timing["kernel_ms"]), "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "step_loop_ms": timing["step_loop_ms"]},
        attention_entry("flash_fwd_causal", "iotml/ops/attention.py:215",
                        "causal", launches, attn_err, attn_timing),
        attention_entry("flash_fwd_full", "iotml/ops/attention.py:149",
                        "full", launches, attn_err, attn_timing)]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": dev["name"],
                                 "count": dev["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
