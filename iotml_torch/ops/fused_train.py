"""The whole autoencoder fit in one kernel launch (``iotml.ops.fused_train``).

The reference trains thousands of tiny steps — batch 100 over an
18-wide MLP — and a step loop pays several kernel launches per step for
microseconds of work each.  ``fused_fit`` runs every epoch and every
step (forward, hand-derived backward, Adam on all eight tensors) in one
launch of ``csrc/fused_train.cu``, one thread block whose shared memory
holds the parameters, the moments and the step's activations for the
whole fit.

Exact math (as ``iotml.train.loop`` / ``models.autoencoder`` define it):

  h1 = tanh(x W1 + b1);  penalty = l1 * sum|h1| / B      (Keras activity reg)
  h2 = relu(h1 W2 + b2); h3 = tanh(h2 W3 + b3); out = relu(h3 W4 + b4)
  loss = sum((out-x)^2 * m) / max(sum(m)*F, 1) + penalty  (masked MSE)
  acc  = sum((out==x) * m) / max(sum(m)*F, 1)             (Keras 'accuracy')
  Adam: b1=.9 b2=.999 eps=1e-8, bias correction 1 - exp(t ln b), t=step+1

The kernel has two designs (``fit_design``): "rows", a thread per batch
row and two barriers a step, at the cardata and creditcard shapes
(F = 18 or 30, E = 14, H = 7) with B <= 256; "elements", a thread per
output element and ten barriers a step, everywhere else.

``fused_fit`` launches the kernel for CUDA tensors and takes the plain
version, ``fused_fit_reference``, only for CPU tensors.  The kernel's
gate is its shared-memory footprint (``fits``): the batches stream from
device memory, so the slice's size does not matter, only one step's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import List, Tuple

import torch

from ..models.autoencoder import PARAM_NAMES
from ..train.optim import B1, B2, EPS, AdamState

def _dims(params) -> Tuple[int, int, int]:
    """(F, E, H) from the state_dict's weight shapes."""
    e, f = params["encoder0.weight"].shape
    h = params["encoder1.weight"].shape[0]
    return f, e, h


#: the kernel's designs, by the code ``iotml_fused_fit_design`` returns
DESIGNS = ("elements", "rows")
#: the (F, E, H) the rows design is built for, and its largest batch
ROWS_SHAPES = ((18, 14, 7), (30, 14, 7))
ROWS_MAX_BATCH = 256


def fit_design(batch_size: int, F: int, E: int, H: int) -> str:
    """The design ``fused_fit`` launches at this shape, by the rule of the
    library's ``iotml_fused_fit_design``: "rows" at the shapes it is built
    for with 1 <= B <= 256, "elements" everywhere else."""
    if 1 <= batch_size <= ROWS_MAX_BATCH and (F, E, H) in ROWS_SHAPES:
        return "rows"
    return "elements"


def _resolve_design(design, batch_size: int, params) -> str:
    auto = fit_design(batch_size, *_dims(params))
    if design is None:
        return auto
    if design not in DESIGNS:
        raise ValueError(f"fused_fit design must be one of {DESIGNS}, "
                         f"not {design!r}")
    if design == "rows" and auto != "rows":
        raise ValueError(f"the rows design does not take batch "
                         f"{batch_size} at (F, E, H) = {_dims(params)}")
    return design


def smem(params, batch_size: int, device, design=None) -> Tuple[int, int]:
    """(bytes of shared memory one step of ``design`` needs, by default
    the one ``fit_design`` picks, and bytes a block may opt into on
    ``device``), both from the kernel's source, which owns the layouts:
    params + mu + nu, the step's batch and mask, every activation and
    delta, and the reduction scratch."""
    design = _resolve_design(design, batch_size, params)
    need, optin = ctypes.c_longlong(), ctypes.c_int()
    lib = _library()
    with torch.cuda.device(device):
        err = lib.iotml_fused_fit_smem(
            DESIGNS.index(design), batch_size, *_dims(params),
            ctypes.byref(need), ctypes.byref(optin))
    if err != 0:
        raise RuntimeError(f"fused_fit shared-memory query failed: CUDA "
                           f"error {err}")
    return need.value, optin.value


def fits(params, batch_size: int, device) -> bool:
    """The ``fused="auto"`` gate.  On the card one step must fit a block's
    shared memory; the plain version, which CPU tensors take, has no such
    limit."""
    if torch.device(device).type == "cpu":
        return True
    need, optin = smem(params, batch_size, device)
    return need <= optin


def supported(state, supervised: bool) -> bool:
    """Is this TrainState the kernel's exact contract? (4-layer
    DenseAutoencoder params + Adam state, unsupervised)."""
    if supervised:
        return False
    params = getattr(state, "params", None)
    return isinstance(params, dict) and set(params) == set(PARAM_NAMES) \
        and isinstance(getattr(state, "opt_state", None), AdamState)


def _new_state(state, params, mu, nu, total: int):
    opt = state.opt_state
    return dataclasses.replace(
        state, step=state.step + total, params=params,
        opt_state=AdamState(count=opt.count + total, mu=mu, nu=nu))


def fused_fit(state, xs: torch.Tensor, masks: torch.Tensor, epochs: int,
              lr: float = 1e-3, l1: float = 1e-7, design=None):
    """Run the whole fit in one kernel launch.

    state: TrainState (DenseAutoencoder params + AdamState)
    xs: [S, B, F] float32 batches; masks: [S, B] float32
    design: None for ``fit_design``'s, or "elements" (any shape) or
    "rows" (only where ``fit_design`` gives it); on the CPU it is checked
    and the plain version runs.
    Returns (new_state, losses [epochs], accs [epochs]) — per-epoch means,
    the history the autograd step loop reports.  CUDA tensors launch the
    kernel (or raise); CPU tensors run ``fused_fit_reference``.
    """
    design = _resolve_design(design, xs.shape[1], state.params)
    if xs.device.type == "cpu":
        return fused_fit_reference(state, xs, masks, epochs, lr, l1)
    if xs.device.type != "cuda":
        raise ValueError(f"fused_fit takes cuda or cpu tensors, "
                         f"not {xs.device}")
    S, B, F = xs.shape
    f, e, h = _dims(state.params)
    epochs = int(epochs)
    if f != F or tuple(masks.shape) != (S, B) or epochs < 1 \
            or masks.device != xs.device:
        raise ValueError(f"fused_fit: xs {tuple(xs.shape)} on {xs.device}, "
                         f"masks {tuple(masks.shape)} on {masks.device}, "
                         f"{F} features vs model {f}, epochs {epochs}")
    need, optin = smem(state.params, B, xs.device, design)
    if need > optin:
        raise ValueError(f"fused_fit: batch {B} x {F} needs {need} B of "
                         f"shared memory, over the {optin} B a block can "
                         f"have")
    opt = state.opt_state
    flat = []
    for tree in (state.params, opt.mu, opt.nu):
        parts = [tree[k] for k in PARAM_NAMES]
        if any(p.device != xs.device or p.dtype != torch.float32
               for p in parts):
            raise ValueError("fused_fit: params and moments must be float32 "
                             f"on {xs.device}")
        flat.append(torch.cat([p.reshape(-1) for p in parts]))
    xs = xs.to(torch.float32).contiguous()
    masks = masks.to(torch.float32).contiguous()
    outs = [torch.empty_like(t) for t in flat]
    losses = torch.empty(epochs, dtype=torch.float32, device=xs.device)
    accs = torch.empty_like(losses)
    denoms = torch.empty(S, dtype=torch.float32, device=xs.device)

    lib = _library()
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        err = lib.iotml_fused_fit(
            DESIGNS.index(design), xs.data_ptr(), masks.data_ptr(),
            *(t.data_ptr() for t in flat), *(t.data_ptr() for t in outs),
            losses.data_ptr(), accs.data_ptr(), denoms.data_ptr(),
            S, B, F, e, h, epochs, int(opt.count),
            lr, l1, l1 / B, 1.0 / S, B1, 1.0 - B1, B2, 1.0 - B2, EPS,
            math.log(B1), math.log(B2), stream)
    if err != 0:
        raise RuntimeError(f"fused_fit {design} kernel launch failed: CUDA "
                           f"error {err}")
    fused_fit.launches += 1
    fused_fit.launches_by_design[design] += 1
    new = [_unflatten(t, state.params) for t in outs]
    return _new_state(state, *new, epochs * S), losses, accs


#: kernel launches so far, in all and by design (the plain version is
#: not counted)
fused_fit.launches = 0
fused_fit.launches_by_design = dict.fromkeys(DESIGNS, 0)


def _unflatten(flat: torch.Tensor, like) -> dict:
    out, off = {}, 0
    for k in PARAM_NAMES:
        n = like[k].numel()
        out[k] = flat[off:off + n].view(like[k].shape)
        off += n
    return out


def _library():
    from . import _build

    lib = _build.load("fused_train")
    if lib.iotml_fused_fit.argtypes is None:
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.iotml_fused_fit.argtypes = [i32] + [ptr] * 11 + [i32] * 7 \
            + [f32] * 11 + [ptr]
        lib.iotml_fused_fit.restype = ctypes.c_int
        lib.iotml_fused_fit_design.argtypes = [i32] * 4
        lib.iotml_fused_fit_design.restype = ctypes.c_int
        lib.iotml_fused_fit_smem.argtypes = [i32] * 5 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
        lib.iotml_fused_fit_smem.restype = ctypes.c_int
    return lib


def fused_fit_reference(state, xs: torch.Tensor, masks: torch.Tensor,
                        epochs: int, lr: float = 1e-3, l1: float = 1e-7):
    """The plain version: the kernel's arithmetic, step by step, in torch
    ops on any device.  Same contract and result as ``fused_fit``."""
    S, B, F = xs.shape
    opt = state.opt_state
    p: List[torch.Tensor] = [state.params[k].clone() for k in PARAM_NAMES]
    m = [opt.mu[k].clone() for k in PARAM_NAMES]
    v = [opt.nu[k].clone() for k in PARAM_NAMES]
    epochs = int(epochs)
    losses = torch.zeros(epochs, dtype=torch.float32, device=xs.device)
    accs = torch.zeros_like(losses)
    log_b1 = torch.tensor(math.log(B1), dtype=torch.float32, device=xs.device)
    log_b2 = torch.tensor(math.log(B2), dtype=torch.float32, device=xs.device)
    for i in range(epochs * S):
        s, e = i % S, i // S
        x = xs[s]
        msk = masks[s].reshape(B, 1)
        w1, b1, w2, b2, w3, b3, w4, b4 = p

        # forward (nn.Linear layout: x @ W.T)
        z1 = x @ w1.T + b1
        h1 = torch.tanh(z1)
        z2 = h1 @ w2.T + b2
        h2 = torch.clamp_min(z2, 0.0)
        z3 = h2 @ w3.T + b3
        h3 = torch.tanh(z3)
        z4 = h3 @ w4.T + b4
        out = torch.clamp_min(z4, 0.0)

        denom = torch.clamp_min(torch.sum(msk) * F, 1.0)
        diff = out - x
        penalty = l1 * torch.sum(torch.abs(h1)) / B
        losses[e] += torch.sum(diff * diff * msk) / denom + penalty
        accs[e] += torch.sum((out == x).to(torch.float32) * msk) / denom

        # backward (hand-derived; weight grads in [out, in])
        dz4 = (2.0 / denom) * diff * msk * (z4 > 0.0)
        dh3 = dz4 @ w4
        dz3 = dh3 * (1.0 - h3 * h3)
        dh2 = dz3 @ w3
        dz2 = dh2 * (z2 > 0.0)
        dh1 = dz2 @ w2 + (l1 / B) * torch.sign(h1)
        dz1 = dh1 * (1.0 - h1 * h1)
        grads = (dz1.T @ x, dz1.sum(0), dz2.T @ h1, dz2.sum(0),
                 dz3.T @ h2, dz3.sum(0), dz4.T @ h3, dz4.sum(0))

        # Adam, bias correction at t = count + i + 1 as 1 - exp(t ln b)
        t = float(opt.count + i + 1)
        c1 = 1.0 - torch.exp(t * log_b1)
        c2 = 1.0 - torch.exp(t * log_b2)
        for k, g in enumerate(grads):
            m[k] = B1 * m[k] + (1.0 - B1) * g
            v[k] = B2 * v[k] + (1.0 - B2) * g * g
            p[k] = p[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + EPS)
    inv = 1.0 / S
    new = [dict(zip(PARAM_NAMES, t)) for t in (p, m, v)]
    return _new_state(state, *new, epochs * S), losses * inv, accs * inv
