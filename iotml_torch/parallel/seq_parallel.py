"""SensorFormer training on the next-step objective
(``iotml.parallel.seq_parallel``'s twin), in its one-device form.

The JAX package shards the time axis over a ``('data', 'seq')`` mesh,
runs ring attention and exchanges each shard's first row with its
neighbour (``shift_in_next``).  On one device that reduces to the masked
next-step MSE of ``sp_next_step_loss_reference`` — targets ``x[:, 1:]``,
the final step masked — and ``make_sp_train_step`` is the gradient of
that loss followed by Adam.  A mesh of more than one device raises
NotImplementedError until ring attention and the cross-rank shift are
ported (ROADMAP A11, multi-GPU SensorFormer).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..train.loop import TrainState

Params = Dict[str, torch.Tensor]


def sp_next_step_loss_reference(model, x, params: Optional[Params] = None):
    """Masked next-step MSE: Σ (pred[:, :-1] − x[:, 1:])² / count, with
    ``pred = model(x)`` (under ``params`` when given, through
    ``torch.func.functional_call``)."""
    pred = model(x) if params is None else \
        torch.func.functional_call(model, params, (x,))
    return torch.mean(torch.square(pred[:, :-1] - x[:, 1:]))


def loss_and_grads(model, params: Params, x) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of ``sp_next_step_loss_reference`` at ``params``:
    ``jax.value_and_grad`` of the JAX step.  Nothing leaves the device."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = sp_next_step_loss_reference(model, x, leaves)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves.keys(), grads))


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: None is one device; a ``DeviceMesh`` (or
    anything with ``size()``) or a sequence of devices counts itself."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    return int(size()) if callable(size) else len(mesh)


def make_sp_train_step(model, optimizer, mesh=None
                       ) -> Tuple[Callable, Callable, Callable]:
    """Build ``(init, step, put_x)`` for next-step training of a
    SensorFormer on one device (the model's).

    ``init()`` starts a ``TrainState`` from the module's current weights
    (copied) and ``optimizer.init``; ``step(state, x)`` with x ``[B, T,
    F]`` returns ``(state, {"loss": loss})``, the loss a 0-d tensor left on
    the device; ``put_x(x)`` puts a numpy array or tensor on the model's
    device as float32.  ``optimizer`` is the port's optax-parity ``Adam``
    (or anything with its ``init`` / ``update``)."""
    if _mesh_size(mesh) > 1:
        raise NotImplementedError(
            "make_sp_train_step runs on one device: sequence-parallel "
            "training across devices needs ring attention and the "
            "cross-rank next-step shift (ROADMAP A11)")
    device = next(model.parameters()).device

    def init() -> TrainState:
        return TrainState.create(model, optimizer)

    def step(state: TrainState, x):
        loss, grads = loss_and_grads(model, state.params, x)
        params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), {"loss": loss}

    def put_x(x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device, torch.float32)

    return init, step, put_x
