"""Micro-batch training over a stream slice (``iotml.train.loop``'s twin).

The reference trains with ``autoencoder.fit(dataset, epochs=20)`` over a
batched stream: every epoch re-reads the slice from its start offset.
Here:

- ``TrainState`` holds the step count, the params (a state_dict) and the
  Adam state; updates are functional, like the JAX package's;
- loss = masked MSE + the Keras activity penalty, and ``accuracy`` is
  Keras's elementwise-equality metric on a regression, so histories have
  the reference's shape;
- ``Trainer.fit`` is the Keras-shaped per-step loop; ``fit_compiled``
  stacks the slice once, moves it to the device once, and runs every
  epoch × batch either in the fused kernel (``ops.fused_train``) or in
  the autograd step loop over device-resident batches;
- ``supervised=True`` (the LSTM) fits ``model(x)`` to the batches' ``y``
  with no activity penalty; the fused kernel is the autoencoder's alone,
  so such a fit always takes the step loop, as the JAX package's takes
  its scanned fit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops import fused_train
from ..utils.device import DeviceLike, resolve_device
from .optim import Adam, AdamState

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: int
    params: Params
    opt_state: AdamState

    @classmethod
    def create(cls, model: torch.nn.Module, tx) -> "TrainState":
        """Start from the module's current weights (copied)."""
        params = {k: v.detach().clone() for k, v in model.state_dict().items()}
        return cls(step=0, params=params, opt_state=tx.init(params))


def _masked_mse(pred, target, mask):
    """Mean squared error over valid rows only (mask is [B], 0/1 or a
    fractional per-row weight that enters linearly)."""
    per_elem = torch.square(pred - target)
    m = mask.reshape(mask.shape + (1,) * (per_elem.dim() - 1))
    denom = torch.clamp_min(torch.sum(m) * per_elem[0].numel(), 1.0)
    return torch.sum(per_elem * m) / denom


def _keras_accuracy(pred, target, mask):
    m = mask.reshape(mask.shape + (1,) * (pred.dim() - 1))
    eq = (pred == target).to(torch.float32) * m
    return torch.sum(eq) / torch.clamp_min(torch.sum(m) * pred[0].numel(),
                                           1.0)


def make_loss_fn(model: torch.nn.Module, supervised: bool = False):
    """Loss closure.  Autoencoder mode targets the input itself;
    supervised mode uses (x, y)."""

    def loss_fn(params, x, y, mask):
        if supervised:
            pred = torch.func.functional_call(model, params, (x,))
            penalty, target = 0.0, y
        else:
            pred, penalty = torch.func.functional_call(
                model, params, (x,), {"with_penalty": True})
            target = x
        loss = _masked_mse(pred, target, mask) + penalty
        return loss, (pred, target)

    return loss_fn


def make_raw_train_step(model: torch.nn.Module, tx,
                        supervised: bool = False) -> Callable:
    """One autograd step: (state, x, y, mask) → (state, metrics).
    Metrics stay on the device (no host sync)."""
    loss_fn = make_loss_fn(model, supervised)

    def step(state: TrainState, x, y, mask):
        params = {k: v.detach().requires_grad_(True)
                  for k, v in state.params.items()}
        loss, (pred, target) = loss_fn(params, x, y, mask)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params.keys(), grads))
        new_params, opt_state = tx.update(
            grads, state.opt_state,
            {k: v.detach() for k, v in params.items()})
        metrics = {"loss": loss.detach(),
                   "accuracy": _keras_accuracy(pred.detach(), target, mask)}
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=opt_state), metrics

    return step


def make_scanned_fit(model: torch.nn.Module, tx, supervised: bool = False):
    """The whole fit as the autograd step loop over device-resident
    batches: epochs (outer) × batches (inner), per-epoch mean loss and
    accuracy left on the device — ``make_scanned_fit``'s counterpart."""
    raw = make_raw_train_step(model, tx, supervised)

    def fit(state: TrainState, xs, ys, masks, epochs: int):
        losses, accs = [], []
        for _ in range(epochs):
            ep_loss, ep_acc = [], []
            for x, y, m in zip(xs, ys, masks):
                state, metrics = raw(state, x, y, m)
                ep_loss.append(metrics["loss"])
                ep_acc.append(metrics["accuracy"])
            losses.append(torch.mean(torch.stack(ep_loss)))
            accs.append(torch.mean(torch.stack(ep_acc)))
        return state, (torch.stack(losses), torch.stack(accs))

    return fit


def make_eval_step(model: torch.nn.Module, supervised: bool = False
                   ) -> Callable:
    """(params, x) → model output, without autograd (the same in both
    modes)."""

    def step(params, x):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (x,))

    return step


class Trainer:
    """model.fit for streams: epochs × batches with history, like Keras.

    ``model`` is an ``AutoencoderSpec`` or an ``LSTMSpec``; the module is
    built on ``device`` (``cuda`` unless given) with weights from a CPU
    generator seeded with ``seed``.
    """

    def __init__(self, model, seed: int = 0,
                 learning_rate: float = 1e-3, supervised: bool = False,
                 tx=None, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.build(self.device,
                                 torch.Generator().manual_seed(seed))
        # the fused kernel implements exactly the default Adam; a
        # caller-supplied optimizer always takes the step loop
        self._default_tx = tx is None
        self.learning_rate = learning_rate
        self.tx = tx if tx is not None else Adam(learning_rate)
        self.supervised = supervised
        self.state: Optional[TrainState] = None
        self._step = None

    def _ensure_state(self):
        if self.state is None:
            self.state = TrainState.create(self.model, self.tx)
        if self._step is None:
            self._step = make_raw_train_step(self.model, self.tx,
                                             self.supervised)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def fit(self, batches, epochs: int = 1, verbose: bool = False,
            callbacks=()) -> dict:
        """Keras-shaped per-step loop: re-reads the stream every epoch and
        fires callbacks per batch; one host sync per step for the
        history.  A frozen slice (``cache=True``) with no per-batch
        observation delegates to ``fit_compiled``."""
        if not callbacks and not verbose and getattr(batches, "cache", False):
            return self.fit_compiled(batches, epochs)
        history = {"loss": [], "accuracy": [], "records": [], "seconds": []}
        epoch_iter = batches.epochs(epochs) if hasattr(batches, "epochs") \
            else (iter(batches) for _ in range(epochs))
        for e, it in enumerate(epoch_iter):
            t0 = time.perf_counter()
            tot_loss = tot_acc = 0.0
            n = records = 0
            for b in it:
                self._ensure_state()
                x = self._to_device(b.x)
                y = self._to_device(b.y) if b.y is not None else x
                self.state, m = self._step(self.state, x, y,
                                           self._to_device(b.mask))
                tot_loss += float(m["loss"])
                tot_acc += float(m["accuracy"])
                n += 1
                records += b.n_valid
                for cb in callbacks:
                    cb.on_batch_end(b, m)
            dt = time.perf_counter() - t0
            history["loss"].append(tot_loss / max(n, 1))
            history["accuracy"].append(tot_acc / max(n, 1))
            history["records"].append(records)
            history["seconds"].append(dt)
            if verbose:
                print(f"epoch {e + 1}/{epochs} - loss {history['loss'][-1]:.6f} "
                      f"- {records} records - {dt:.2f}s")
        return history

    def fit_compiled(self, batches, epochs: int = 1, fused: str = "auto"
                     ) -> dict:
        """Whole-slice fit: read the epoch's batches once, stack them on
        the host, move them to the device once, and run every epoch ×
        batch on the device.

        fused: "auto" runs the fit in the fused kernel when the model and
        optimizer are its contract (``fused_train.supported``, the default
        Adam) and one step fits a block's shared memory; "never" forces
        the autograd step loop; "always" raises if unsupported.

        The history adds ``host_pipeline_s`` (read + batch + stack) and
        ``device_compute_s`` (transfer + fit + the one sync that reads the
        metrics back)."""
        if fused not in ("auto", "never", "always"):
            raise ValueError(f"fused must be auto|never|always, not {fused!r}")
        t0 = time.perf_counter()
        # .epochs(1) when the source has it: that fills a cache=True
        # batcher's replay cache
        it = next(batches.epochs(1)) if hasattr(batches, "epochs") \
            else iter(batches)
        bs = list(it)
        if not bs:
            return {"loss": [], "accuracy": [], "records": [], "seconds": [],
                    "host_pipeline_s": time.perf_counter() - t0,
                    "device_compute_s": 0.0}
        xs = np.stack([b.x for b in bs])
        masks = np.stack([b.mask for b in bs])
        records = sum(b.n_valid for b in bs)
        self._ensure_state()
        t_dev = time.perf_counter()

        activity_l1 = getattr(self.model, "activity_l1", None)
        use_fused = fused != "never" and \
            fused_train.supported(self.state, self.supervised) and \
            self._default_tx and activity_l1 is not None and \
            fused_train.fits(self.state.params, xs.shape[1], self.device)
        if fused == "always" and not use_fused:
            raise ValueError("fused fit unsupported for this model/optimizer/"
                             "batch size")
        xs_d, masks_d = self._to_device(xs), self._to_device(masks)
        if use_fused:
            self.state, losses, accs = fused_train.fused_fit(
                self.state, xs_d, masks_d, epochs,
                lr=self.learning_rate, l1=activity_l1)
        else:
            scanned = make_scanned_fit(self.model, self.tx, self.supervised)
            if any(b.y is not None for b in bs):
                ys_d = self._to_device(np.stack(
                    [b.y if b.y is not None else b.x for b in bs]))
            else:
                ys_d = xs_d  # autoencoder mode targets the input itself
            self.state, (losses, accs) = scanned(self.state, xs_d, ys_d,
                                                 masks_d, epochs)
        # ONE sync for both metric vectors
        losses, accs = torch.stack([losses, accs]).cpu().numpy()
        t_end = time.perf_counter()
        dt = t_end - t0
        return {"loss": losses.tolist(), "accuracy": accs.tolist(),
                "records": [records] * epochs,
                "seconds": [dt / epochs] * epochs,
                "host_pipeline_s": t_dev - t0,
                "device_compute_s": t_end - t_dev}

    def predict(self, batches, callbacks=(), params=None):
        """Batched inference; calls callbacks with (batch, outputs) for
        ordered write-back.  ``params`` overrides the trained state."""
        ev = make_eval_step(self.model, self.supervised)
        params = params if params is not None else self.state.params
        outs = []
        for b in batches:
            out = ev(params, self._to_device(b.x))
            for cb in callbacks:
                cb.on_predict_batch_end(b, out)
            outs.append(out.cpu().numpy()[: b.n_valid])
        return outs
