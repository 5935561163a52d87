"""Sequence-parallel SensorFormer training on the next-step objective
(``iotml.parallel.seq_parallel``'s twin).

Over a ``('data', 'seq')`` mesh the batch's rows shard over 'data' and
the time axis over 'seq'; attention runs as ring attention (the model's
``attn_mode='ring'``), and the next-step objective's one cross-shard
term, position t's target x[t+1] on the next shard for a shard's last
step, is one ``ppermute`` (``shift_in_next``).  Each shard's squared
error and element count are summed over both axes (``psum``), and one
backward runs through the whole sharded graph: each shard's loss reads
the other shards' K/V through the ring, so the backward of every
rotation sends gradients back around it.  Each process sums its
gradients in a fixed order and the processes sum theirs with one
``all_reduce`` (``sharded_step``); Adam runs on each device's replica.

Without a mesh (or with one device) the step is the one-device form:
the masked next-step MSE of ``sp_next_step_loss_reference`` — targets
``x[:, 1:]``, the final step masked — and Adam, on the model's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..train.loop import TrainState
from .mesh import (Mesh, NamedSharding, P, ShardedTensor, axis_index,
                   axis_size, block_of, global_axis_size, ppermute, psum,
                   shard_device)
from .sharded_step import init_state, make_sharded_step, shard_modules

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


def shift_in_next(x_local, axis_name: str):
    """For each local ``[B, Tl, F]`` shard, the next-step targets ``[B,
    Tl, F]``: rows 0..Tl-2 from the local shard, row Tl-1 the first row
    of the next shard (the first shard's on the last: masked)."""
    n = axis_size(axis_name)
    perm = [(i, (i - 1) % n) for i in range(n)]
    head_of_next = ppermute(x_local[:, :1], axis_name, perm)
    return torch.cat([x_local[:, 1:], head_of_next], dim=1)


def next_step_mask(Tl: int, axis_name: str):
    """``[Tl]`` float32 validity mask of the next-step targets: 1 but at
    the global final step, which has no successor."""
    mask = torch.ones(Tl, dtype=torch.float32, device=shard_device())
    if axis_index(axis_name) == axis_size(axis_name) - 1:
        mask[Tl - 1] = 0.0
    return mask


def _mesh_size(mesh) -> int:
    """Devices in ``mesh``: None is one device; a ``DeviceMesh`` (or
    anything with ``size()``) or a sequence of devices counts itself."""
    if mesh is None:
        return 1
    size = getattr(mesh, "size", None)
    return int(size()) if callable(size) else len(mesh)


def make_sp_train_step(model, optimizer, mesh=None, data_axis: str = "data",
                       seq_axis: str = "seq"
                       ) -> Tuple[Callable, Callable, Callable]:
    """Build ``(init, step, put_x)`` for next-step training of a
    SensorFormer.

    ``init()`` starts a ``TrainState`` from the module's current weights
    (copied) and ``optimizer.init``; ``step(state, x)`` with x ``[B, T,
    F]`` returns ``(state, {"loss": loss})``, the loss a 0-d tensor left on
    the device; ``optimizer`` is the port's optax-parity ``Adam`` (or
    anything with its ``init`` / ``update``).

    ``mesh`` None (or a one-device sequence) is the one-device step on
    the model's device; ``put_x`` puts a numpy array or tensor there as
    float32.  A ``Mesh`` with ``data_axis`` and ``seq_axis`` runs the
    sequence-parallel step: the model is ``attn_mode='ring'`` over
    ``seq_axis`` (any mode when the axis has one shard), ``put_x`` cuts x
    ``P(data_axis, seq_axis)`` into a ``ShardedTensor``, the state's
    params are ``ShardedTensor``s replicated on each device and
    ``step.value_and_grad(state, x)`` gives the step's loss and
    gradients without the update."""
    if isinstance(mesh, Mesh):
        return _make_mesh_step(model, optimizer, mesh, data_axis, seq_axis)
    if _mesh_size(mesh) > 1:
        raise TypeError(
            "a multi-device sequence-parallel step takes a "
            "parallel.mesh.Mesh with its data and seq axes, not "
            f"{type(mesh).__name__}")
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


def _make_mesh_step(model, optimizer, mesh: Mesh, data_axis: str,
                    seq_axis: str):
    if set(mesh.axis_names) != {data_axis, seq_axis}:
        raise ValueError(f"a sequence-parallel mesh has the axes "
                         f"{(data_axis, seq_axis)}, not {mesh.axis_names}")
    n_seq = global_axis_size(mesh, seq_axis)
    mode = getattr(model, "attn_mode", None)
    if n_seq > 1 and (mode != "ring"
                      or getattr(model, "ring_axis", None) != seq_axis):
        raise ValueError(
            f"a {n_seq}-shard {seq_axis!r} axis needs the model's "
            f"attn_mode='ring' over it, not {mode!r}")
    max_len = getattr(model, "max_len", None)
    modules = shard_modules(model, mesh)
    x_sharding = NamedSharding(mesh, P(data_axis, seq_axis))

    def local_loss(i, params, x_local):
        B, Tl, F = x_local.shape
        my = axis_index(seq_axis)
        n = axis_size(seq_axis)
        if max_len is not None and n * Tl > max_len:
            raise ValueError(
                f"global sequence {n * Tl} exceeds model.max_len={max_len}; "
                f"the position embedding would read past its table")
        positions = my * Tl + torch.arange(Tl, device=x_local.device)
        pred = torch.func.functional_call(modules[i], params, (x_local,),
                                          {"positions": positions})
        target = shift_in_next(x_local, seq_axis)
        mask = next_step_mask(Tl, seq_axis)[None, :, None]
        se = torch.sum(torch.square(pred - target) * mask)
        se_tot = psum(se, (data_axis, seq_axis))
        # elements counted: valid local steps × local rows × features
        cnt_tot = psum(torch.sum(mask) * (B * F), (data_axis, seq_axis))
        loss = se_tot / cnt_tot
        return loss, {"loss": loss}

    def local_args(coords, x: ShardedTensor):
        return (x.piece(block_of(mesh, x.sharding.spec, coords),
                        mesh.devices[coords]),)

    step = make_sharded_step(mesh, optimizer, local_loss, local_args)

    def init() -> TrainState:
        return init_state({k: v.detach() for k, v in
                           model.state_dict().items()}, mesh, {}, optimizer)

    def put_x(x) -> ShardedTensor:
        from .data_parallel import put_global

        if isinstance(x, ShardedTensor):
            return x
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return put_global(np.asarray(x, np.float32), x_sharding)

    return init, step, put_x

